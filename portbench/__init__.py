"""The benchmark of the PyTorch and CUDA port (``links_tpu_torch``).

One command runs one cell once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root lists the cells; README.md here says how the
files are found by name and how to run the tests on the CPU and the card.
"""
