"""A plain float32 reference of MotionBERT's DSTformer (Zhu et al., ICCV 2023;
github.com/Walter0807/MotionBERT, ``lib/model/DSTformer.py``, widths from
``configs/pose3d/MB_ft_h36m.yaml``), written from its equations, one
unpadded window at a time: no kernels, no batching of windows, no masks.
It imports nothing of the port (``links_tpu_torch``) or of JAX, and takes
its weights as a plain state dict with MotionBERT's keys.

For a window x (F, J, 3) of 2D poses and confidences, C = dim_feat:

    z = joints_embed(x) + pos_embed[j] + temp_embed[f]
    per level i:  s = ST_i(z), t = TS_i(z) from the same z;
                  alpha = softmax(ts_attn_i([s | t])); z = alpha_0 s + alpha_1 t
    ST_i: z += A_s(LN(z)); z += M_s(LN(z)); z += A_t(LN(z)); z += M_t(LN(z));
          TS_i runs the temporal pair first
    A: qkv -> heads of C / heads; softmax(q k^T / sqrt(C / heads)) v over the
       J joints of a frame (A_s) or the F frames of a joint (A_t); proj
    M: fc2(GELU(fc1(u))) with the erf GELU; LN: affine, eps 1e-6
    y = head(tanh(pre_logits.fc(LN(z))))

A ``Precision`` says where the reference rounds: ``F32`` nowhere (TF32 off,
``full_f32``); ``BF16`` at the configuration's bf16 points, which are each
linear's two operands and attention's q, k, v and probabilities, with f32
sums, an f32 softmax and everything else f32; ``FP8`` at the same points in
float8 e4m3, scaled per tensor, the control one precision below bf16.

Departures from MotionBERT, all of them its training-time choices, as
nothing here trains: every parameter is drawn from a seed (``init_params``;
MotionBERT starts ``ts_attn`` at weight 0 and bias 0.5, which makes the
fusion a constant half, and its LayerNorms at 1 and 0, which would leave
their affines untested); the 2D pose's confidence is 1 on every frame; and
dropout and drop-path are off, as in MotionBERT's evaluation.
"""

from __future__ import annotations

import math

import torch

LN_EPS = 1e-6


def full_f32():
    """f32 matmuls stay f32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (7 mantissa bits), to nearest even, in f32."""
    return t.bfloat16().float()


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 (3 mantissa bits), its largest magnitude
    scaled to the format's 448, back in f32."""
    scale = 448.0 / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    def __init__(self, name: str, rnd):
        self.name, self.rnd = name, rnd


F32 = Precision("f32", _same)
BF16 = Precision("bf16", round_bf16)
FP8 = Precision("fp8", round_fp8)


def linear(p: dict, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.rnd(x) @ prec.rnd(p[f"{name}.weight"]).T + p[f"{name}.bias"]


def layer_norm(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[f"{name}.weight"] + p[f"{name}.bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(p: dict, name: str, u: torch.Tensor, heads: int, temporal: bool,
              prec: Precision) -> torch.Tensor:
    """(F, J, C) -> (F, J, C): attention over the joints of each frame, or
    with ``temporal`` over the frames of each joint."""
    Fr, J, C = u.shape
    qkv = linear(p, f"{name}.qkv", u, prec).reshape(Fr, J, 3, heads, C // heads)
    # (sequence, head, position, head dim): sequences are frames (spatial) or joints
    order = (1, 2, 0, 3) if temporal else (0, 2, 1, 3)
    q, k, v = (prec.rnd(qkv[:, :, i].permute(*order)) for i in range(3))
    scores = q @ k.transpose(-1, -2) / math.sqrt(C // heads)
    o = prec.rnd(torch.softmax(scores, dim=-1)) @ v
    o = o.permute(2, 0, 1, 3) if temporal else o.permute(0, 2, 1, 3)  # (F, J, heads, dim)
    return linear(p, f"{name}.proj", o.reshape(Fr, J, C), prec)


def mlp(p: dict, name: str, u: torch.Tensor, prec: Precision) -> torch.Tensor:
    return linear(p, f"{name}.fc2", gelu(linear(p, f"{name}.fc1", u, prec)), prec)


def stream(p: dict, name: str, z: torch.Tensor, order: str, heads: int,
           prec: Precision) -> torch.Tensor:
    """ST (``order`` "st") or TS ("ts") of one level."""
    for sfx in order:
        z = z + attention(p, f"{name}.attn_{sfx}", layer_norm(p, f"{name}.norm1_{sfx}", z),
                          heads, sfx == "t", prec)
        z = z + mlp(p, f"{name}.mlp_{sfx}", layer_norm(p, f"{name}.norm2_{sfx}", z), prec)
    return z


def depth_of(p: dict) -> int:
    return sum(k.startswith("blocks_st.") and k.endswith(".norm1_s.weight") for k in p)


def forward(p: dict, x: torch.Tensor, heads: int = 8, prec: Precision = F32) -> torch.Tensor:
    """One window: x (F, J, 3) -> (F, J, 3)."""
    Fr = x.shape[0]
    z = linear(p, "joints_embed", x, prec) + p["pos_embed"][0] + p["temp_embed"][0, :Fr]
    for i in range(depth_of(p)):
        s = stream(p, f"blocks_st.{i}", z, "st", heads, prec)
        t = stream(p, f"blocks_ts.{i}", z, "ts", heads, prec)
        alpha = torch.softmax(linear(p, f"ts_attn.{i}", torch.cat([s, t], dim=-1), prec), dim=-1)
        z = alpha[..., :1] * s + alpha[..., 1:] * t
    h = torch.tanh(linear(p, "pre_logits.fc", layer_norm(p, "norm", z), prec))
    return linear(p, "head", h, prec)


def lift(p: dict, poses_2d: torch.Tensor, heads: int = 8, prec: Precision = F32) -> torch.Tensor:
    """One window of lift's normalized 2D poses (F, 2J: all x, then all y)
    -> (F, 3J) in lift's layout (all x, all y, all z), confidence 1."""
    Fr = poses_2d.shape[0]
    J = poses_2d.shape[1] // 2
    x = torch.cat([poses_2d.reshape(Fr, 2, J).transpose(1, 2),
                   torch.ones(Fr, J, 1, device=poses_2d.device)], dim=-1)
    return forward(p, x, heads, prec).transpose(1, 2).reshape(Fr, 3 * J)


def init_params(generator: torch.Generator, dim_feat: int = 512, mlp_hidden: int = 1024,
                depth: int = 5, dim_rep: int = 512, num_joints: int = 17, maxlen: int = 243,
                dim_in: int = 3, dim_out: int = 3) -> dict:
    """A state dict with MotionBERT's keys, every parameter drawn from
    ``generator`` on its device: each linear as ``nn.Linear`` draws one,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)); LayerNorm weights U(0.5, 1.5) and
    biases U(-0.1, 0.1); pos_embed and temp_embed N(0, 0.02^2), as
    MotionBERT draws them."""
    g, dev = generator, generator.device
    C = dim_feat
    p = {}

    def lin(name, fan_in, fan_out):
        bound = 1.0 / math.sqrt(fan_in)
        for part, shape in (("weight", (fan_out, fan_in)), ("bias", (fan_out,))):
            p[f"{name}.{part}"] = (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound

    def norm(name):
        p[f"{name}.weight"] = torch.rand(C, generator=g, device=dev) + 0.5
        p[f"{name}.bias"] = (torch.rand(C, generator=g, device=dev) * 2 - 1) * 0.1

    lin("joints_embed", dim_in, C)
    for stream_name in ("blocks_st", "blocks_ts"):
        for i in range(depth):
            for sfx in ("s", "t"):
                b = f"{stream_name}.{i}"
                norm(f"{b}.norm1_{sfx}")
                lin(f"{b}.attn_{sfx}.qkv", C, 3 * C)
                lin(f"{b}.attn_{sfx}.proj", C, C)
                norm(f"{b}.norm2_{sfx}")
                lin(f"{b}.mlp_{sfx}.fc1", C, mlp_hidden)
                lin(f"{b}.mlp_{sfx}.fc2", mlp_hidden, C)
    norm("norm")
    lin("pre_logits.fc", C, dim_rep)
    lin("head", dim_rep, dim_out)
    p["temp_embed"] = torch.randn(1, maxlen, 1, C, generator=g, device=dev) * 0.02
    p["pos_embed"] = torch.randn(1, num_joints, C, generator=g, device=dev) * 0.02
    for i in range(depth):
        lin(f"ts_attn.{i}", 2 * C, 2)
    return p
