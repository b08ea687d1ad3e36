"""Seeded weights, made on the device in a few large calls.

Each model is a state dict in the port's (and the reference LInKs
repository's) layout: ``upscale.weight`` (out, in), ``res_pose1.l1.bias``,
FrEIA's ``module_list.k.subnet.0.weight``, ... Every linear is drawn as
``torch.nn.Linear`` initializes one, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
from one uniform draw per set of models; a coupling block's global scale
starts at 1 and its mixing matrix is a random rotation (sign-fixed QR of a
normal draw), as FrEIA's ``AllInOneBlock`` does. The tensors of a set are
views of one buffer, each at a 16-byte aligned offset; ``clone`` gives a
side its own copy, so that the program's in-place updates never reach the
reference's initial weights.
"""

from __future__ import annotations

import math

import torch

LIFTER_BLOCKS = ("res_common", "res_pose1", "res_pose2", "res_pose3",
                 "res_angle1", "res_angle2", "res_angle3")
COMPLETER_BLOCKS = ("res_pose1", "res_pose2", "res_pose3")
# 0.1 * 2 * softplus(0.5 g) == 1 (FrEIA's global_affine_init=1)
GLOBAL_SCALE_INIT = 2.0 * math.log(math.exp(5.0) - 1.0)


def lifter_linears(joints: int, hidden: int) -> dict[str, tuple[int, int]]:
    """name -> (fan_out, fan_in) of a side/part lifter's linears."""
    out = {"upscale": (hidden, 2 * joints)}
    for blk in LIFTER_BLOCKS:
        out[f"{blk}.l1"] = out[f"{blk}.l2"] = (hidden, hidden)
    out["downscale"] = (joints, hidden)
    out["angles"] = (1, hidden)
    return out


def completer_linears(in_joints: int, out_joints: int, hidden: int) -> dict:
    out = {"upscale": (hidden, 3 * in_joints)}
    for blk in COMPLETER_BLOCKS:
        out[f"{blk}.l1"] = out[f"{blk}.l2"] = (hidden, hidden)
    out["downscale"] = (3 * out_joints, hidden)
    return out


def flow_linears(dim: int, blocks: int, hidden: int) -> dict:
    len2 = dim // 2
    len1 = dim - len2
    out = {}
    for k in range(blocks):
        out[f"module_list.{k}.subnet.0"] = (hidden, len1)
        out[f"module_list.{k}.subnet.2"] = (2 * len2, hidden)
    return out


def _aligned(n: int) -> int:
    return -(-n // 4) * 4


def draw_linears(models: dict[str, dict], generator: torch.Generator) -> dict[str, dict]:
    """{model: {linear: (fan_out, fan_in)}} -> {model: state dict of its
    weights and biases}, from one uniform draw on the generator's device."""
    shapes = [(m, f"{name}.{part}", shape, fan_in)
              for m, linears in models.items() for name, (fan_out, fan_in) in linears.items()
              for part, shape in (("weight", (fan_out, fan_in)), ("bias", (fan_out,)))]
    total = sum(_aligned(math.prod(s)) for _, _, s, _ in shapes)
    flat = torch.rand(total, generator=generator, device=generator.device).mul_(2).sub_(1)
    out: dict[str, dict] = {m: {} for m in models}
    ofs = 0
    for m, key, shape, fan_in in shapes:
        n = math.prod(shape)
        out[m][key] = flat[ofs:ofs + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        ofs += _aligned(n)
    return out


def rotations(count: int, dim: int, generator: torch.Generator) -> torch.Tensor:
    """(count, dim, dim) random rotations: sign-fixed QR, determinant +1."""
    a = torch.randn(count, dim, dim, generator=generator, device=generator.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    q[:, :, 0] *= torch.sign(torch.linalg.det(q))[:, None]
    return q


def add_flow_buffers(sd: dict, dim: int, blocks: int, generator: torch.Generator) -> dict:
    """A flow's global scale, offset and mixing matrices, added to ``sd``."""
    w = rotations(blocks, dim, generator)
    dev = generator.device
    for k in range(blocks):
        sd[f"module_list.{k}.global_scale"] = torch.full((1, dim), GLOBAL_SCALE_INIT, device=dev)
        sd[f"module_list.{k}.global_offset"] = torch.zeros(1, dim, device=dev)
        sd[f"module_list.{k}.w_perm"] = w[k].contiguous()
        sd[f"module_list.{k}.w_perm_inv"] = w[k].T.contiguous()
    return sd


def clone(sd: dict) -> dict:
    """A state dict of fresh contiguous copies."""
    return {k: v.detach().clone() for k, v in sd.items()}
