"""Training: the optimizer, the stages' steps and the epoch loop."""
