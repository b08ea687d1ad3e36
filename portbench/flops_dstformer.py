"""Operations of MotionBERT's DSTformer (``configs/<config>.json`` with
``"model": "dstformer"``), counted from its shapes: 2 FLOPs a multiply-add.

Per window of ``frames`` valid frames of J joints (C = hidden / mlp_ratio,
M = hidden, the MLP's width; ``depth`` levels, each an ST and a TS stream):
every linear on frames x J tokens (the embedding, per stream and level qkv
C -> 3C, proj, fc1 and fc2, per level the fusion 2C -> 2, the head's
pre_logits and head), and attention's two products per stream and level:
spatial, J x J scores of C per frame; temporal, frames x frames scores of C
per joint. LayerNorms, softmaxes and elementwise work are not counted, nor
padded frames: a padded frame is no work a caller asked for.
"""

from __future__ import annotations


def widths(config: dict) -> dict:
    """The model's widths: ``hidden`` is the MLP width, dim_feat = hidden /
    mlp_ratio."""
    return {"dim_feat": int(config["hidden"] / config["mlp_ratio"]),
            "mlp_hidden": config["hidden"], "depth": config["depth"],
            "dim_rep": config["dim_rep"], "num_joints": config["num_joints"],
            "maxlen": config["maxlen"], "dim_in": config["dim_in"],
            "dim_out": config["dim_out"]}


def window_flops(config: dict, frames: int) -> int:
    """FLOPs of one window of ``frames`` valid frames."""
    w = widths(config)
    C, M, D, J = w["dim_feat"], w["mlp_hidden"], w["depth"], w["num_joints"]
    per_token = (w["dim_in"] * C + 2 * D * 2 * (C * 3 * C + C * C + C * M + M * C)
                 + D * 2 * C * 2 + C * w["dim_rep"] + w["dim_rep"] * w["dim_out"])
    spatial = 2 * D * 2 * J * J * C * frames
    temporal = 2 * D * 2 * frames * frames * C * J
    return 2 * (per_token * frames * J + spatial + temporal)


def clip_flops(config: dict, frames: int) -> int:
    """FLOPs of a clip of ``frames`` frames cut into windows of maxlen, the
    last holding the remainder."""
    T = config["maxlen"]
    full, rest = divmod(frames, T)
    return full * window_flops(config, T) + (window_flops(config, rest) if rest else 0)
