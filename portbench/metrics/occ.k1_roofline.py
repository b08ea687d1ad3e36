"""K1's share of its roofline in the traced stretch (occ4-train): ``readers.k1_roofline``."""

from portbench.readers import k1_roofline as read  # noqa: F401

LAYER = "kernel (ops/csrc/resblock.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "occ_train_poses_per_s"
