"""The attention side lifter (counterpart of links_tpu/models/attention.py).

The reference names an ``Attention_Left_Right_Lifter(..., num_heads=2)`` that
it defines nowhere; the JAX package supplies one as a flagged variant of the
MLP lifter (stage 3a ``--attention``), and this is its port:

    embed:     Linear(2 -> 64) per joint token, plus a learned position ``pos``
    attention: ``num_heads``-head self-attention over the J joint tokens
               (``qkv``, softmax, ``proj``) with a residual add
    upscale:   Linear(J 64 -> H)
    trunk:     LeakyReLU(res_common(x))
    pose:      2 x LeakyReLU(res_block) -> Linear(H -> J)   (depth offsets)
    angle:     2 x LeakyReLU(res_block) -> Linear(H -> 1)   (elevation angle)

Attention over J <= 17 tokens is plain einsum and softmax, as XLA computes
it in the JAX package; the five residual blocks run the residual-block
kernel on the card. The head count is encoded in the shape of ``qkv``'s
weight, (3, heads, 64 / heads, 64) in torch's (out, in) layout (JAX's is
(64, 3, heads, 64 / heads)), so a checkpoint carries it. The weights'
``.pt`` is the module's state dict: the reference has no such class, so
there is no reference layout to follow (ckpt/torch_io.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from links_tpu_torch.core.nn import F32, Linear, Policy, dense, leaky_relu
from links_tpu_torch.models.lifters import HIDDEN, ResBlock

TOKEN_DIM = 64
POSE_BLOCKS = ("res_pose1", "res_pose2")
ANGLE_BLOCKS = ("res_angle1", "res_angle2")
BLOCKS = ("res_common", *POSE_BLOCKS, *ANGLE_BLOCKS)


class QKV(nn.Module):
    """The query, key and value projections of every head in one weight
    (3, heads, 64 / heads, 64) and bias (3, heads, 64 / heads). Not a
    ``core.nn.Linear``: int8 quantization keeps it float, as the JAX package
    keeps its 4-D leaf."""

    def __init__(self, num_heads: int, *, generator: torch.Generator | None = None):
        super().__init__()
        lin = Linear(TOKEN_DIM, 3 * TOKEN_DIM, generator=generator)
        dh = TOKEN_DIM // num_heads
        self.weight = nn.Parameter(lin.weight.detach().reshape(3, num_heads, dh, TOKEN_DIM))
        self.bias = nn.Parameter(lin.bias.detach().reshape(3, num_heads, dh))

    def forward(self, t: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
        return dense(t, self.weight.reshape(3 * TOKEN_DIM, TOKEN_DIM),
                     self.bias.reshape(3 * TOKEN_DIM), policy)


class AttentionLifter(nn.Module):
    """(B, 2J) 2D part pose -> ((B, J) depth offsets, (B, 1) elevation angle).

    Built on the CPU from ``generator`` and then moved to ``device``."""

    def __init__(self, num_joints: int, num_heads: int = 2, hidden: int = HIDDEN, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        if TOKEN_DIM % num_heads:
            raise ValueError(f"num_heads={num_heads} must divide TOKEN_DIM={TOKEN_DIM}")
        self.embed = Linear(2, TOKEN_DIM, generator=generator)
        self.pos = nn.Parameter(
            torch.randn(num_joints, TOKEN_DIM, generator=generator) * 0.02)
        self.qkv = QKV(num_heads, generator=generator)
        self.proj = Linear(TOKEN_DIM, TOKEN_DIM, generator=generator)
        self.upscale = Linear(num_joints * TOKEN_DIM, hidden, generator=generator)
        for name in BLOCKS:
            setattr(self, name, ResBlock(hidden, generator=generator))
        self.downscale = Linear(hidden, num_joints, generator=generator)
        self.angles = Linear(hidden, 1, generator=generator)
        if device is not None:
            self.to(device)

    @property
    def num_heads(self) -> int:
        return self.qkv.weight.shape[1]

    def forward(self, x: torch.Tensor, policy: Policy = F32):
        b, (j, d) = x.shape[0], self.pos.shape
        nh = self.num_heads
        tokens = x.reshape(b, 2, j).transpose(1, 2)                     # (B, J, 2)
        t = self.embed(tokens, policy) + self.pos
        qkv = self.qkv(t, policy).reshape(b, j, 3, nh, d // nh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]              # (B, J, H, Dh)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d // nh)
        att = torch.softmax(att, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, j, d)
        t = t + self.proj(o, policy)

        h = self.upscale(t.reshape(b, j * d), policy)
        h = leaky_relu(self.res_common(h, policy))
        xd = h
        for name in POSE_BLOCKS:
            xd = leaky_relu(getattr(self, name)(xd, policy))
        xa = h
        for name in ANGLE_BLOCKS:
            xa = leaky_relu(getattr(self, name)(xa, policy))
        return self.downscale(xd, policy), self.angles(xa, policy)
