"""K1's share of its roofline in the traced stretch (lr3a-train): ``readers.k1_roofline``."""

from portbench.readers import k1_roofline as read  # noqa: F401

LAYER = "kernel (ops/csrc/resblock.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_poses_per_s"
