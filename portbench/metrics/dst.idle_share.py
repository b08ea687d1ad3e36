"""The share of the traced stretch with no operation on the card
(dst-lift-sat): ``readers.idle_share``."""

from portbench.readers import idle_share as read  # noqa: F401

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lift_poses_per_s"
