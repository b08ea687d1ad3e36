"""Residual-MLP part lifters (counterpart of links_tpu/models/lifters.py).

    upscale: Linear(2J -> H)
    trunk:   LeakyReLU(res_common(x))
    pose:    3 x LeakyReLU(res_block) -> Linear(H -> J)   (depth offsets)
    angle:   3 x LeakyReLU(res_block) -> Linear(H -> 1)   (elevation angle)

Module names are the reference's state-dict keys, so reference ``.pt``
checkpoints load straight in (ckpt/torch_io.py). LayerNorm and dropout are
off on every serving path and are not part of this module yet.
"""

from __future__ import annotations

import torch
from torch import nn

from links_tpu_torch.core.nn import F32, Linear, Policy, leaky_relu

HIDDEN = 1024
# The residual blocks in the order the fused serving kernel runs them.
CHAIN = ("res_common", "res_pose1", "res_pose2", "res_pose3",
         "res_angle1", "res_angle2", "res_angle3")


class ResBlock(nn.Module):
    """Two Linear + LeakyReLU with a residual skip (no outer activation)."""

    def __init__(self, hidden: int, *, generator: torch.Generator | None = None):
        super().__init__()
        self.l1 = Linear(hidden, hidden, generator=generator)
        self.l2 = Linear(hidden, hidden, generator=generator)

    def forward(self, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
        h = leaky_relu(self.l1(x, policy))
        h = leaky_relu(self.l2(h, policy))
        return h + x


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
