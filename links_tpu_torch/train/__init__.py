"""Training: the optimizer, the stage-3a step and the epoch loop."""
