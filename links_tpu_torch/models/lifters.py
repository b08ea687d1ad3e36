"""Residual-MLP part lifters (counterpart of links_tpu/models/lifters.py).

    upscale: Linear(2J -> H)
    trunk:   LeakyReLU(res_common(x))
    pose:    3 x LeakyReLU(res_block) -> Linear(H -> J)   (depth offsets)
    angle:   3 x LeakyReLU(res_block) -> Linear(H -> 1)   (elevation angle)

Module names are the reference's state-dict keys, so reference ``.pt``
checkpoints load straight in (ckpt/torch_io.py). LayerNorm and dropout are
off on every serving path and are not part of this module yet. The
attention variant of the side lifter is models/attention.py.
"""

from __future__ import annotations

import torch
from torch import nn

from links_tpu_torch.core.nn import F32, Linear, Policy, leaky_relu, recording
from links_tpu_torch.ops.quant import QuantLinear
from links_tpu_torch.ops.resblock import res_block

HIDDEN = 1024
LEG_JOINTS = 7
TORSO_JOINTS = 10
# The residual blocks in the order the fused serving kernel runs them.
CHAIN = ("res_common", "res_pose1", "res_pose2", "res_pose3",
         "res_angle1", "res_angle2", "res_angle3")


class ResBlock(nn.Module):
    """Two Linear + LeakyReLU with a residual skip (no outer activation): the
    residual-block kernel on the card, its plain version on the CPU
    (ops/resblock.py). Quantized (ops/quant.py), the block composes its two
    int8 linears, as the JAX package's ``res_block_apply`` composes
    ``nn.dense``, and calls no kernel; during static calibration it composes
    its float linears, so that each records its input."""

    def __init__(self, hidden: int, *, generator: torch.Generator | None = None):
        super().__init__()
        self.l1 = Linear(hidden, hidden, generator=generator)
        self.l2 = Linear(hidden, hidden, generator=generator)

    def forward(self, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
        if isinstance(self.l1, QuantLinear) or recording():
            return leaky_relu(self.l2(leaky_relu(self.l1(x, policy)), policy)) + x
        return res_block(x, self.l1.weight, self.l1.bias, self.l2.weight, self.l2.bias, policy)


class Lifter(nn.Module):
    """(B, 2J) 2D part pose -> ((B, J) depth offsets, (B, 1) elevation angle).

    Built on the CPU from ``generator`` and then moved to ``device``."""

    def __init__(self, num_joints: int, hidden: int = HIDDEN, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.upscale = Linear(2 * num_joints, hidden, generator=generator)
        for name in CHAIN:
            setattr(self, name, ResBlock(hidden, generator=generator))
        self.downscale = Linear(hidden, num_joints, generator=generator)
        self.angles = Linear(hidden, 1, generator=generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, policy: Policy = F32):
        h = self.upscale(x, policy)
        h = leaky_relu(self.res_common(h, policy))
        xd = h
        for name in ("res_pose1", "res_pose2", "res_pose3"):
            xd = leaky_relu(getattr(self, name)(xd, policy))
        xa = h
        for name in ("res_angle1", "res_angle2", "res_angle3"):
            xa = leaky_relu(getattr(self, name)(xa, policy))
        return self.downscale(xd, policy), self.angles(xa, policy)


class StackedLifter(nn.Module):
    """The (left, right) side-lifter pair of the left/right lifting mode."""

    def __init__(self, left: Lifter, right: Lifter):
        super().__init__()
        self.left = left
        self.right = right

    def forward(self, left_x: torch.Tensor, right_x: torch.Tensor,
                policy: Policy = F32):
        """-> (left depth, right depth, left angle, right angle)."""
        ld, la = self.left(left_x, policy)
        rd, ra = self.right(right_x, policy)
        return ld, rd, la, ra


class LegTorsoLifter(nn.Module):
    """The (legs, torso) lifter pair of the leg/torso lifting mode (7 and 10
    joints), registered in that order, which fixes ``parameters()``'s."""

    def __init__(self, legs: Lifter, torso: Lifter):
        super().__init__()
        self.legs = legs
        self.torso = torso
