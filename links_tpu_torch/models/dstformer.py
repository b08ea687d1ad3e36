"""MotionBERT's DSTformer: a dual-stream spatio-temporal transformer that
lifts a window of 2D poses to 3D (Zhu et al., "MotionBERT: A Unified
Perspective on Learning Human Motion Representations", ICCV 2023;
github.com/Walter0807/MotionBERT, ``lib/model/DSTformer.py``, widths from
``configs/pose3d/MB_ft_h36m.yaml``). ``lift`` and ``serve --model
dstformer`` serve it; the JAX package has no counterpart, and nothing here
trains it.

For a window of F <= maxlen frames of J joints, C = dim_feat:

    embed:  z = joints_embed(x) + pos_embed[j] + temp_embed[f]; x (F, J, 3) is
            the 2D pose and a confidence
    A(u):   qkv(u) -> q, k, v of ``num_heads`` heads; softmax(q k^T / sqrt(C /
            heads)) v over the J joints of one frame (spatial, A_s) or over
            the F frames of one joint (temporal, A_t); heads concatenated,
            then proj
    M(u):   fc2(GELU(fc1(u))), fc1: C -> mlp_ratio C, the exact-erf GELU
    ST_i:   z += A_s(LN(z)); z += M_s(LN(z)); z += A_t(LN(z)); z += M_t(LN(z))
            (blocks_st.i; TS_i, blocks_ts.i, runs the temporal pair first)
    level:  s = ST_i(z), t = TS_i(z) from the same z; alpha =
            softmax(ts_attn_i([s | t])) per token; z = alpha_0 s + alpha_1 t
    head:   y = head(tanh(pre_logits.fc(LN(z)))) -> (F, J, 3)

Every LayerNorm is affine with eps 1e-6; dropout and drop-path are off
(MotionBERT's evaluation). Module names are MotionBERT's state-dict keys, so
its ``model_pos`` dict, with the ``module.`` prefix stripped, loads
(``from_state_dict``). The forward updates its activations in place and
builds no autograd graph: it serves, it does not train.

Windows: serving cuts a clip into consecutive windows of maxlen frames
(cli/lift.py:pack_windows); a short last window is padded to maxlen, and
``lens`` gives each window's valid frames. Padded frames carry confidence 0
and are left out of temporal attention's keys, so each valid frame's output
is the unpadded window's.

Precision (``Policy``): under ``BF16`` every linear is a bf16 tensor-core
product with f32 sums and an f32 result (``core.nn.mm_bf16``), attention
takes q, k and v in bf16 (``scaled_dot_product_attention``: f32 scores and
softmax, bf16 probabilities, f32 sums), and the LayerNorms, GELU, tanh, the
fusion's softmax and the residual stream are f32. Under ``F32`` all of it is
f32. The GEMMs and attention are the library's; the passes between them in
the blocks are this repository's kernels (ops/dst_glue.py), one per chain:
a LayerNorm writes the next product's operand in the compute dtype, the
qkv bias add writes q, k and v, fc1's bias add, GELU and cast are one pass,
and each residual add is one pass with the LayerNorm after it. They round
where the plain op sequence rounds: the products' operands and q, k, v.
Per stream 9 launches: 5 ``residual_layernorm`` (the stream's first
LayerNorm, of ``z``, which both streams read and neither writes; 3 residual
adds each with the next LayerNorm; the last residual add alone), 2
``qkv_bias_split``, 2 ``bias_gelu_cast``.

Spans (train/profiling.py) per forward, each with the caller's ``args``:
``dst.embed``; ``dst.attn_s`` and ``dst.attn_t``, each attention sub-step
with its residual add and the LayerNorm after it (the MLP's); ``dst.mlp``,
each MLP sub-step with its residual add and the next sub-step's LayerNorm
(a stream's first LayerNorm runs in its first attention span);
``dst.fuse``, a level's fusion; ``dst.head``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from links_tpu_torch.core.nn import F32, LayerNorm, Linear, Policy, mm_bf16
from links_tpu_torch.ops import dst_glue as G
from links_tpu_torch.ops.dst_glue import LN_EPS
from links_tpu_torch.train.profiling import span

NUM_HEADS = 8  # MB_ft_h36m.yaml's heads (8 of 64); a state dict does not carry it
EMBED_STD = 0.02  # MotionBERT's trunc_normal_(std=.02) of pos_embed and temp_embed


def _mm(x: torch.Tensor, weight: torch.Tensor, policy: Policy) -> torch.Tensor:
    """x @ weight^T under ``policy``, no bias, an f32 result."""
    if policy.compute_dtype == torch.bfloat16:
        return mm_bf16(x, weight)
    return x @ weight.t()


def _linear(x: torch.Tensor, lin: Linear, policy: Policy) -> torch.Tensor:
    y = _mm(x, lin.weight, policy)
    return y.add_(lin.bias)


def _ln(x: torch.Tensor, norm: LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), norm.weight, norm.bias, LN_EPS)


def _backends(q: torch.Tensor, flash: bool):
    """The attention kernels allowed on the card: flash for bf16 attention
    that masks no key (it takes no mask), else the memory-efficient kernel,
    which also ran the 17-token spatial attention fastest (H100, torch
    2.11). cuDNN's is left out: it builds a graph per shape, and serving's
    batch of windows changes shape from run to run."""
    if not q.is_cuda:
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if flash and q.dtype != torch.float32:
        return sdpa_kernel([SDPBackend.FLASH_ATTENTION])
    return sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])


class Attention(nn.Module):
    """MotionBERT's ``Attention`` in its spatial or temporal mode: ``qkv``
    (C -> 3C, with bias) and ``proj``."""

    def __init__(self, dim: int, *, generator: torch.Generator | None = None):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, generator=generator)
        self.proj = Linear(dim, dim, generator=generator)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, generator=generator)
        self.fc2 = Linear(hidden, dim, generator=generator)


class Block(nn.Module):
    """One stream of a level: the spatial pair (``_s``) and the temporal pair
    (``_t``), each a LayerNorm before attention and one before the MLP."""

    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator | None = None):
        super().__init__()
        for sfx in ("s", "t"):
            setattr(self, f"norm1_{sfx}", LayerNorm(dim))
            setattr(self, f"attn_{sfx}", Attention(dim, generator=generator))
            setattr(self, f"norm2_{sfx}", LayerNorm(dim))
            setattr(self, f"mlp_{sfx}", MLP(dim, hidden, generator=generator))


class DSTformer(nn.Module):
    """(W, F, J, dim_in) windows -> (W, F, J, dim_out) 3D poses."""

    def __init__(self, dim_in: int = 3, dim_out: int = 3, dim_feat: int = 512,
                 dim_rep: int = 512, depth: int = 5, num_heads: int = NUM_HEADS,
                 mlp_ratio: float = 2, num_joints: int = 17, maxlen: int = 243, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if dim_feat % num_heads:
            raise ValueError(f"dim_feat {dim_feat} is not a multiple of {num_heads} heads")
        self.num_heads, self.maxlen, self.num_joints = num_heads, maxlen, num_joints
        hidden = int(dim_feat * mlp_ratio)
        g = generator
        self.joints_embed = Linear(dim_in, dim_feat, generator=g)
        self.blocks_st = nn.ModuleList(Block(dim_feat, hidden, generator=g) for _ in range(depth))
        self.blocks_ts = nn.ModuleList(Block(dim_feat, hidden, generator=g) for _ in range(depth))
        self.norm = LayerNorm(dim_feat)
        self.pre_logits = nn.ModuleDict({"fc": Linear(dim_feat, dim_rep, generator=g)})
        self.head = Linear(dim_rep, dim_out, generator=g)
        self.temp_embed = nn.Parameter(
            torch.randn(1, maxlen, 1, dim_feat, generator=g) * EMBED_STD)
        self.pos_embed = nn.Parameter(torch.randn(1, num_joints, dim_feat, generator=g) * EMBED_STD)
        self.ts_attn = nn.ModuleList(Linear(2 * dim_feat, 2, generator=g) for _ in range(depth))

    @torch.no_grad()
    def forward(self, x: torch.Tensor, lens=None, policy: Policy = F32,
                args: str | None = None) -> torch.Tensor:
        """``x`` (W, F, J, dim_in), F <= maxlen; ``lens`` (W,) on the host:
        each window's valid frames (None: all F), the rest masked out of
        temporal attention's keys; ``args``: the spans' args."""
        W, Fr, J, _ = x.shape
        C = self.norm.weight.shape[0]
        keys = None
        if lens is not None and int(np.min(lens)) < Fr:
            valid = torch.as_tensor(np.asarray(lens), device=x.device)
            keys = (torch.arange(Fr, device=x.device) < valid[:, None])[:, None, None, :]
        with span("dst.embed", args):
            z = _mm(x.reshape(-1, x.shape[-1]), self.joints_embed.weight, policy)
            z.view(W, Fr, J, C).add_(self.joints_embed.bias + self.pos_embed[0]
                                     + self.temp_embed[0, :Fr])
        shape = (W, Fr, J)
        for i in range(len(self.blocks_st)):
            s = self._stream(self.blocks_st[i], z, ("s", "t"), shape, keys, policy, args)
            t = self._stream(self.blocks_ts[i], z, ("t", "s"), shape, keys, policy, args)
            del z
            with span("dst.fuse", args):
                lin = self.ts_attn[i]
                alpha = _mm(s, lin.weight[:, :C], policy)
                alpha += _mm(t, lin.weight[:, C:], policy)
                alpha = torch.softmax(alpha.add_(lin.bias), dim=-1)
                z = s.mul_(alpha[:, :1]).addcmul_(t, alpha[:, 1:])
                del s, t
        with span("dst.head", args):
            h = torch.tanh_(_linear(_ln(z, self.norm), self.pre_logits["fc"], policy))
            y = _linear(h, self.head, policy)
        return y.view(W, Fr, J, -1)

    def _stream(self, blk: Block, z, order, shape, keys, policy, args):
        """One stream of a level from ``z`` (left as it is) -> its output."""
        dt = policy.compute_dtype
        out = h = None
        for i, sfx in enumerate(order):
            temporal = sfx == "t"
            with span("dst.attn_t" if temporal else "dst.attn_s", args):
                if h is None:
                    norm = getattr(blk, f"norm1_{sfx}")
                    _, h = G.residual_layernorm(z, gamma=norm.weight, beta=norm.bias, dtype=dt)
                attn = getattr(blk, f"attn_{sfx}")
                u = self._attention(attn, h, shape, keys if temporal else None, temporal, policy)
                norm = getattr(blk, f"norm2_{sfx}")
                out, h = G.residual_layernorm(z if out is None else out, u, attn.proj.bias,
                                              norm.weight, norm.bias, dt)
            with span("dst.mlp", args):
                mlp = getattr(blk, f"mlp_{sfx}")
                u = G.bias_gelu_cast(_mm(h, mlp.fc1.weight, policy), mlp.fc1.bias, dt)
                u = _mm(u, mlp.fc2.weight, policy)
                gamma = beta = None
                if i + 1 < len(order):  # the next sub-step's LayerNorm
                    norm = getattr(blk, f"norm1_{order[i + 1]}")
                    gamma, beta = norm.weight, norm.bias
                out, h = G.residual_layernorm(out, u, mlp.fc2.bias, gamma, beta, dt)
        return out

    def _attention(self, attn: Attention, h, shape, keys, temporal: bool, policy: Policy):
        """A_s or A_t of the (W F J, C) normalized tokens ``h`` (in the compute
        dtype) -> proj's f32 product, its bias not added."""
        W, Fr, J = shape
        M, C = h.shape
        H = self.num_heads
        D = C // H
        qkv = G.qkv_bias_split(_mm(h, attn.qkv.weight, policy), attn.qkv.bias,
                               policy.compute_dtype)
        if temporal:  # one sequence of F frames per (window, joint, head)
            q, k, v = (u.view(W, Fr, J * H, D).transpose(1, 2) for u in qkv)
        else:  # one sequence of J joints per (window, frame, head)
            q, k, v = (u.view(W * Fr, J, H, D).transpose(1, 2) for u in qkv)
        with _backends(q, temporal and keys is None):
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=keys)
        del q, k, v, qkv
        return _mm(o.transpose(1, 2).reshape(M, C), attn.proj.weight, policy)

    def lift(self, p2d: torch.Tensor, lens=None, policy: Policy = F32,
             args: str | None = None) -> torch.Tensor:
        """Serving's forward: (W, F, 2J) windows of lift's normalized 2D poses
        (all x, then all y) and ``lens`` -> (W, F, 3J) 3D poses in lift's
        layout (all x, all y, all z). The confidence is 1 on valid frames and
        0 on padding."""
        W, Fr, _ = p2d.shape
        J = self.num_joints
        x = torch.empty(W, Fr, J, 3, device=p2d.device)
        x[..., :2] = p2d.view(W, Fr, 2, J).transpose(-1, -2)
        if lens is None:
            x[..., 2] = 1.0
        else:
            valid = torch.as_tensor(np.asarray(lens), device=p2d.device)
            x[..., 2] = (torch.arange(Fr, device=p2d.device) < valid[:, None])[..., None]
        y = self(x, lens, policy, args)
        return y.transpose(-1, -2).reshape(W, Fr, -1)


def from_state_dict(state_dict: dict, device="cpu", num_heads: int = NUM_HEADS) -> DSTformer:
    """A ``DSTformer`` of the widths ``state_dict`` holds (MotionBERT's
    keys), every key loaded."""
    sd = state_dict
    dim_feat, dim_in = sd["joints_embed.weight"].shape
    depth = sum(k.startswith("blocks_st.") and k.endswith(".norm1_s.weight") for k in sd)
    model = DSTformer(dim_in=dim_in, dim_out=sd["head.weight"].shape[0], dim_feat=dim_feat,
                      dim_rep=sd["pre_logits.fc.weight"].shape[0], depth=depth,
                      num_heads=num_heads,
                      mlp_ratio=sd["blocks_st.0.mlp_s.fc1.weight"].shape[0] / dim_feat,
                      num_joints=sd["pos_embed"].shape[1], maxlen=sd["temp_embed"].shape[1])
    model.load_state_dict(sd)
    return model.to(device)


def load_pt(path, device="cpu", num_heads: int = NUM_HEADS) -> DSTformer:
    """A DSTformer from a ``.pt`` state dict (``--dst-pt``)."""
    return from_state_dict(torch.load(path, map_location="cpu", weights_only=True), device,
                           num_heads)
