"""The host's milliseconds to issue one training step (occ4-train): ``readers.host_ms_per_step``."""

from portbench.readers import host_ms_per_step as read  # noqa: F401

LAYER = "epoch loop (train/loop.py:run_epoch)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "occ_train_poses_per_s"
