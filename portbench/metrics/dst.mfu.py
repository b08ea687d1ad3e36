"""The DSTformer's share of the card's bf16 peak (dst-lift-sat): the model
FLOPs of the frames returned (``flops_dstformer.clip_flops`` at each clip's
valid frames; padding is no work) over the seconds until the last of their
replies, against 989 TFLOP/s, in %."""

from portbench.flops import PEAK_FLOPS


def read(r: dict):
    if not r.get("dst_flops") or not r.get("window_s"):
        return None
    return 100.0 * r["dst_flops"] / r["window_s"] / PEAK_FLOPS


LAYER = "window forward (models/dstformer.py:DSTformer)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "lift_poses_per_s"
