"""The training step's share of the card's bf16 peak (lr3a-train): ``readers.train_mfu``."""

from portbench.readers import train_mfu as read  # noqa: F401

LAYER = "step (train/steps.py)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_poses_per_s"
