"""Attention's share of the card's busy time in the traced stretch
(dst-lift-sat): the device seconds of the kernels launched inside the
program's ``dst.attn_s`` and ``dst.attn_t`` spans (each attention sub-step:
its LayerNorm, qkv, the attention kernel, proj and the residual add; matched
to their launches by the profiler's correlation ids) over the seconds in
which the card was busy, in %. None where the program has no such spans."""


def read(r: dict):
    tr, attn = r.get("trace"), r.get("attention_device_s")
    if tr is None or not attn or tr.busy_s <= 0:
        return None
    return 100.0 * attn / tr.busy_s


LAYER = "attention (models/dstformer.py:Attention)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lift_poses_per_s"
