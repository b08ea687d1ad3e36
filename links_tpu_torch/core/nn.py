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


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          policy: Policy = F32) -> torch.Tensor:
    """y = x @ weight^T + bias, weight in torch's (out, in) layout (batched
    weights broadcast over leading dims), under the dtype policy."""
    if policy.compute_dtype != torch.float32:
        x = x.to(policy.compute_dtype).float()
        weight = weight.to(policy.compute_dtype).float()
    return torch.matmul(x, weight.mT) + bias


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """torch-default LeakyReLU."""
    return torch.where(x >= 0, x, negative_slope * x)


class Linear(nn.Module):
    """A linear layer with the reference's state-dict keys (``weight`` in
    (out, in) layout, ``bias``) whose forward follows a dtype ``Policy``."""

    def __init__(self, fan_in: int, fan_out: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = nn.Parameter(
            torch.empty(fan_out, fan_in).uniform_(-bound, bound, generator=generator))
        self.bias = nn.Parameter(
            torch.empty(fan_out).uniform_(-bound, bound, generator=generator))

    def forward(self, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
        return dense(x, self.weight, self.bias, policy)


def full_f32_matmuls():
    """Keep f32 matmuls in f32 on the card: the f32 serving path is the
    eval-parity path, and TF32 keeps only ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
