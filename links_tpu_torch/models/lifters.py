"""Residual-MLP part lifters (counterpart of links_tpu/models/lifters.py).

    upscale: Linear(2J -> H)
    trunk:   LeakyReLU(res_common(x))
    pose:    3 x LeakyReLU(res_block) -> Linear(H -> J)   (depth offsets)
    angle:   3 x LeakyReLU(res_block) -> Linear(H -> 1)   (elevation angle)

Module names are the reference's state-dict keys, so reference ``.pt``
checkpoints load straight in (ckpt/torch_io.py). A residual block may carry
LayerNorms (``bn1``, ``bn2``: the reference's ``use_batchnorm`` flag gates
LayerNorm) and dropout; every entry point runs with both off. The
attention variant of the side lifter is models/attention.py; the pose
discriminator, which no entry point runs, is ``PoseDiscriminator``.
"""

from __future__ import annotations

import torch
from torch import nn

from links_tpu_torch.core.nn import (
    F32,
    LayerNorm,
    Linear,
    Policy,
    dense,
    dropout,
    leaky_relu,
    recording,
)
from links_tpu_torch.ops.quant import QuantLinear
from links_tpu_torch.ops.resblock import res_block
from links_tpu_torch.train import parallel

HIDDEN = 1024
LEG_JOINTS = 7
TORSO_JOINTS = 10
# The residual blocks in the order the fused serving kernel runs them.
CHAIN = ("res_common", "res_pose1", "res_pose2", "res_pose3",
         "res_angle1", "res_angle2", "res_angle3")
# The pose discriminator's residual blocks (only res_common runs).
DISCRIMINATOR_BLOCKS = ("res_common", "res_pose1", "res_pose2")


class ResBlock(nn.Module):
    """Two Linear + LeakyReLU with a residual skip (no outer activation): the
    residual-block kernel on the card, its plain version on the CPU
    (ops/resblock.py).

    With ``use_layernorm`` a LayerNorm follows each linear; with
    ``dropout_rate`` and ``dropout_masks`` given, dropout follows each
    activation. Neither kernel computes that function, so such a block
    composes plain torch ops, as the JAX package's ``res_block_apply`` does.
    Quantized (ops/quant.py), the block composes its two int8 linears and
    calls no kernel; during static calibration it composes its float
    linears, so that each records its input. Split over a 'model' axis
    (``train.parallel.tp_shard_``: l1 on fan_out, l2 on fan_in, bn1 on
    features) it takes the tensor-parallel route, which calls no kernel
    either: K1 computes the whole block, and the split sums the l2 product
    over the ranks between its two linears."""

    def __init__(self, hidden: int, *, use_layernorm: bool = False, dropout_rate: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.l1 = Linear(hidden, hidden, generator=generator)
        self.l2 = Linear(hidden, hidden, generator=generator)
        if use_layernorm:
            self.bn1 = LayerNorm(hidden)
            self.bn2 = LayerNorm(hidden)
        self.use_layernorm = use_layernorm
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, policy: Policy = F32,
                dropout_masks: tuple[torch.Tensor, torch.Tensor] | torch.Generator | None = None
                ) -> torch.Tensor:
        """``dropout_masks``: None (deterministic, as the JAX package's
        default), the two keep-masks (bool, x's shape) of the two dropouts,
        or a generator to draw them from."""
        drop = bool(self.dropout_rate) and dropout_masks is not None
        if getattr(self.l1, "tp", None) is not None:
            if drop:
                raise ValueError("a residual block split over 'model' takes no dropout")
            return self._tensor_parallel(x, policy)
        if not (self.use_layernorm or drop or isinstance(self.l1, QuantLinear) or recording()):
            return res_block(x, self.l1.weight, self.l1.bias, self.l2.weight, self.l2.bias,
                             policy)
        gen = dropout_masks if isinstance(dropout_masks, torch.Generator) else None
        keeps = dropout_masks if drop and gen is None else (None, None)
        norms = (self.bn1, self.bn2) if self.use_layernorm else (None, None)
        h = x
        for lin, norm, keep in zip((self.l1, self.l2), norms, keeps):
            h = lin(h, policy)
            if norm is not None:
                h = norm(h)
            h = leaky_relu(h)
            if drop:
                h = dropout(h, self.dropout_rate, keep, gen)
        return h + x

    def _tensor_parallel(self, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        """The block on this rank's features of l1's output: the gradient of
        x through that branch sums over the ranks (never the residual's),
        and the l2 products sum before b2, bn2, LeakyReLU and the residual."""
        group = self.l1.tp.group
        h = dense(parallel.copy_to_model(x, group), self.l1.weight, self.l1.bias, policy)
        if self.use_layernorm:
            h = self.bn1(h)
        a = parallel.reduce_from_model(dense(leaky_relu(h), self.l2.weight, None, policy), group)
        a = a + self.l2.bias
        if self.use_layernorm:
            a = self.bn2(a)
        return leaky_relu(a) + x


class Lifter(nn.Module):
    """(B, 2J) 2D part pose -> ((B, J) depth offsets, (B, 1) elevation angle).

    Built on the CPU from ``generator`` and then moved to ``device``."""

    def __init__(self, num_joints: int, hidden: int = HIDDEN, *, use_layernorm: bool = False,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.upscale = Linear(2 * num_joints, hidden, generator=generator)
        for name in CHAIN:
            setattr(self, name, ResBlock(hidden, use_layernorm=use_layernorm, generator=generator))
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


class PoseDiscriminator(nn.Module):
    """(B, 2J) 2D pose -> (B, 1) score (the reference's ``PoseDiscriminator``,
    which no entry point runs): upscale, LeakyReLU(res_common), downscale.
    ``res_pose1`` and ``res_pose2`` are built, as the reference builds
    them, and not run. Built on the CPU from ``generator``."""

    def __init__(self, num_joints: int = 16, hidden: int = HIDDEN, *,
                 use_layernorm: bool = False, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.upscale = Linear(2 * num_joints, hidden, generator=generator)
        for name in DISCRIMINATOR_BLOCKS:
            setattr(self, name, ResBlock(hidden, use_layernorm=use_layernorm, generator=generator))
        self.downscale = Linear(hidden, 1, generator=generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
        h = leaky_relu(self.res_common(self.upscale(x, policy), policy))
        return self.downscale(h, policy)
