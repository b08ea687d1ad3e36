"""The host's milliseconds to issue one training step (lr3a-train): ``readers.host_ms_per_step``."""

from portbench.readers import host_ms_per_step as read  # noqa: F401

LAYER = "epoch loop (train/loop.py:run_epoch)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_poses_per_s"
