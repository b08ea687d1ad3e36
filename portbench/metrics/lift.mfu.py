"""The lift's share of the card's bf16 peak (lr-lift-sat): ``readers.lift_mfu``."""

from portbench.readers import lift_mfu as read  # noqa: F401

LAYER = "forward (objectives/lifter.py:lift_left_right_eval)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "lift_poses_per_s"
