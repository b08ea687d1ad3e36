"""The training step's share of the card's bf16 peak (occ4-train): ``readers.train_mfu``."""

from portbench.readers import train_mfu as read  # noqa: F401

LAYER = "step (train/steps.py)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "occ_train_poses_per_s"
