"""Invertible coupling block (counterpart of links_tpu/flows/coupling.py): the
equivalent of FrEIA's ``AllInOneBlock`` with ``permute_soft=True``, applied
in this order on the forward pass:

    x1, x2 = split(x)                      # [D - D//2, D//2]
    a      = subnet(x1) * 0.1              # Linear(len1, H) ReLU Linear(H, 2 len2)
    s      = clamp * 0.636 * atan(a[:, :len2])
    y2     = x2 * exp(s) + a[:, len2:]
    y      = concat(x1, y2) * gs + gb      # global affine
    z      = y @ W^T                       # fixed orthogonal W
    logdet = sum(s) + sum(log(gs))

with clamp = 2, gs = 0.1 softplus_{beta=0.5}(g). The subnet follows the dtype
policy; the mixing matmul and the logdet stay f32 (on the card f32 matmuls
must not run in TF32: ``core.nn.full_f32_matmuls``). Module and buffer names
are FrEIA's state-dict keys (``module_list.k.subnet.{0,2}``,
``global_scale``/``global_offset`` as (1, D), ``w_perm``, ``w_perm_inv``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from links_tpu_torch.core.nn import F32, Linear, Policy

CLAMP = 2.0
# FrEIA's ATAN clamp activation is the literal 0.636, not 2/pi.
ATAN_CLAMP = 0.636
# g0 with 0.1 * softplus_{beta=0.5}(g0) == 1 (FrEIA's global_affine_init=1).
GLOBAL_SCALE_INIT = 2.0 * math.log(math.exp(5.0) - 1.0)


def split_lens(dim: int) -> tuple[int, int]:
    """FrEIA's split: the first part gets the ceil half."""
    len2 = dim // 2
    return dim - len2, len2


def random_orthogonal(dim: int, generator: torch.Generator | None = None) -> torch.Tensor:
    """A random rotation in SO(dim) by sign-fixed QR."""
    q, r = torch.linalg.qr(torch.randn(dim, dim, generator=generator))
    q = q * torch.sign(torch.diagonal(r))
    q[:, 0] *= torch.sign(torch.linalg.det(q))
    return q


class CouplingBlock(nn.Module):
    def __init__(self, dim: int, hidden: int = 1024, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        len1, len2 = split_lens(dim)
        # ReLU sits between the two linears: keys subnet.0 and subnet.2
        self.subnet = nn.Sequential(Linear(len1, hidden, generator=generator), nn.ReLU(),
                                    Linear(hidden, 2 * len2, generator=generator))
        self.global_scale = nn.Parameter(torch.full((1, dim), GLOBAL_SCALE_INIT))
        self.global_offset = nn.Parameter(torch.zeros(1, dim))
        w = random_orthogonal(dim, generator)
        self.register_buffer("w_perm", w)
        self.register_buffer("w_perm_inv", w.T.contiguous())

    def _coupling(self, x1: torch.Tensor, policy: Policy):
        len2 = self.w_perm.shape[0] // 2
        a = self.subnet[2](torch.relu(self.subnet[0](x1, policy)), policy) * 0.1
        return CLAMP * ATAN_CLAMP * torch.atan(a[:, :len2]), a[:, len2:]

    def _scale(self) -> torch.Tensor:
        return 0.1 * (2.0 * F.softplus(0.5 * self.global_scale))

    def forward(self, x: torch.Tensor, policy: Policy = F32):
        """x -> (z, log|det J|) of this block."""
        len1, _ = split_lens(x.shape[-1])
        x1, x2 = x[:, :len1], x[:, len1:]
        s, t = self._coupling(x1, policy)
        y2 = x2 * torch.exp(s) + t
        gs = self._scale()
        y = torch.cat([x1, y2], dim=-1) * gs + self.global_offset
        return y @ self.w_perm.T, s.sum(-1) + torch.log(gs).sum()

    def inverse(self, z: torch.Tensor, policy: Policy = F32):
        """z -> (x, log|det J| of the inverse map)."""
        len1, _ = split_lens(z.shape[-1])
        gs = self._scale()
        y = (z @ self.w_perm - self.global_offset) / gs
        x1, y2 = y[:, :len1], y[:, len1:]
        s, t = self._coupling(x1, policy)
        x2 = (y2 - t) * torch.exp(-s)
        return torch.cat([x1, x2], dim=-1), -(s.sum(-1) + torch.log(gs).sum())


class Flow(nn.Module):
    """A stack of coupling blocks over dimension ``dim`` (FrEIA's
    ``SequenceINN`` naming: ``module_list``). Built on the CPU from
    ``generator``."""

    def __init__(self, dim: int, n_blocks: int = 8, hidden: int = 1024, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.module_list = nn.ModuleList(
            CouplingBlock(dim, hidden, generator=generator) for _ in range(n_blocks))

    @property
    def dim(self) -> int:
        return self.module_list[0].w_perm.shape[0]
