"""The share of the traced stretch with no operation on the card
(lr3a-train): ``readers.idle_share``."""

from portbench.readers import idle_share as read  # noqa: F401

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_poses_per_s"
