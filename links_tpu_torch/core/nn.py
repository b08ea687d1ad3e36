"""NN primitives (counterpart of links_tpu/core/nn.py).

Initialization matches torch.nn.Linear's default distribution,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, drawn from an
explicit ``torch.Generator``.

Mixed precision follows the JAX package's policy: under ``BF16`` the matmul
inputs are rounded to bf16 and the product is accumulated and returned in
f32. A bf16 x bf16 product is exact in f32, so computing
``x.bfloat16().float() @ w.bfloat16().float()`` in f32 equals JAX's
``preferred_element_type=float32`` dot up to summation order, on every
device. (torch's bf16 ``F.linear`` returns bf16 and is not this policy.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Policy:
    """Matmul input dtype; accumulation and outputs are always f32."""

    compute_dtype: torch.dtype = torch.float32


F32 = Policy()
BF16 = Policy(compute_dtype=torch.bfloat16)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          policy: Policy = F32) -> torch.Tensor:
    """y = x @ weight^T + bias (no bias: None), weight in torch's (out, in)
    layout (batched weights broadcast over leading dims), under the dtype
    policy."""
    if policy.compute_dtype != torch.float32:
        x = x.to(policy.compute_dtype).float()
        weight = weight.to(policy.compute_dtype).float()
    y = torch.matmul(x, weight.mT)
    return y if bias is None else y + bias


def mm_bf16(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ weight^T, weight (N, K), as a bf16 product: both operands
    rounded to bf16, their products summed in f32, an f32 (M, N) result
    (``Policy``'s contract). On the card this is one tensor-core GEMM
    (``aten::mm.dtype``), where ``dense`` under ``BF16`` multiplies the
    rounded operands in f32; elsewhere, which has no such kernel, it is
    ``dense``'s product (the same numbers up to summation order). No bias:
    the caller adds it."""
    x, weight = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    if x.is_cuda:
        return torch.mm(x, weight.t(), out_dtype=torch.float32)
    return x.float() @ weight.float().t()


# Activation ranges for static int8 calibration (ops/quant.py:
# quantize_params_static): while a dict is installed here, every ``Linear``
# records the max |x| it is called with, keyed by id() of the module.
_CALIB: dict[int, float] | None = None


@contextlib.contextmanager
def record_activation_ranges():
    """Context manager yielding the {id(linear module): max|x|} record of the
    calls inside it (the counterpart of links_tpu's, which keys by id() of a
    linear's param dict)."""
    global _CALIB
    prev, _CALIB = _CALIB, {}
    try:
        yield _CALIB
    finally:
        _CALIB = prev


def recording() -> bool:
    """True inside ``record_activation_ranges``."""
    return _CALIB is not None


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """torch-default LeakyReLU."""
    return torch.where(x >= 0, x, negative_slope * x)


class Linear(nn.Module):
    """A linear layer with the reference's state-dict keys (``weight`` in
    (out, in) layout, ``bias``) whose forward follows a dtype ``Policy``.

    Split over a 'model' axis (``train.parallel.tp_shard_`` sets ``tp``), it
    holds its part of the weight and takes the tensor-parallel route: a
    column split (fan_out) gathers its output's features from every rank, a
    row split (fan_in) multiplies its slice of the input's features and sums
    the products over the ranks before its replicated bias."""

    def __init__(self, fan_in: int, fan_out: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = nn.Parameter(
            torch.empty(fan_out, fan_in).uniform_(-bound, bound, generator=generator))
        self.bias = nn.Parameter(
            torch.empty(fan_out).uniform_(-bound, bound, generator=generator))
        self.tp = None  # a train.parallel.TPRole once split

    def forward(self, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
        if _CALIB is not None:
            _CALIB[id(self)] = max(_CALIB.get(id(self), 0.0), float(x.abs().max()))
        if self.tp is None:
            return dense(x, self.weight, self.bias, policy)
        from links_tpu_torch.train import parallel  # it imports this module

        group = self.tp.group
        x = parallel.copy_to_model(x, group)
        if self.tp.kind == "column":
            return parallel.gather_from_model(dense(x, self.weight, self.bias, policy), group)
        n = self.weight.shape[1]
        part = dense(x[..., group.rank * n:(group.rank + 1) * n], self.weight, None, policy)
        return parallel.reduce_from_model(part, group) + self.bias


LN_EPS = 1e-5


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance), as the JAX package's
    ``layernorm``, op for op."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


class LayerNorm(nn.Module):
    """``layernorm`` with the reference's ``nn.LayerNorm`` state-dict keys
    (``weight``, ``bias``), at torch's defaults (ones, zeros).

    Split over a 'model' axis on its features (``tp``, set by
    ``train.parallel.tp_shard_``), it normalizes a column split's output: the
    mean and the biased variance of the whole feature axis come from a sum
    and then a sum of squared deviations, each all-reduced over the ranks."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.tp = None  # a train.parallel.TPRole once split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return layernorm(x, self.weight, self.bias)
        from links_tpu_torch.train import parallel  # it imports this module

        group = self.tp.group
        n = x.shape[-1] * group.world
        mean = parallel.all_reduce_sum(x.sum(-1, keepdim=True), group) / n
        var = parallel.all_reduce_sum(((x - mean) ** 2).sum(-1, keepdim=True), group) / n
        return (x - mean) * torch.rsqrt(var + LN_EPS) * self.weight + self.bias


def dropout(x: torch.Tensor, rate: float, keep: torch.Tensor | None = None,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout: kept elements scaled by 1 / (1 - rate), the rest 0.
    The keep-mask is ``keep`` (bool, x's shape), or is drawn from
    ``generator`` (each element kept with probability 1 - rate, drawn on the
    generator's device)."""
    if rate == 0.0:
        return x
    if keep is None:
        if generator is None:
            raise ValueError("dropout needs a keep-mask or a generator to draw it from")
        keep = torch.rand(x.shape, generator=generator, device=generator.device) < 1.0 - rate
    return torch.where(keep.to(x.device), x / (1.0 - rate), 0.0)


def full_f32_matmuls():
    """Keep f32 matmuls in f32 on the card: the f32 serving path is the
    eval-parity path, and TF32 keeps only ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
