"""The benchmark's plain reference (model.py) and the draws it shares with
the program (draws.py). Nothing here imports the port."""
