"""Int8 quantized serving, w8a8 (counterpart of links_tpu/ops/quant.py and
of ``_dense_int8`` in links_tpu/core/nn.py).

Scheme (symmetric post-training quantization, as the JAX package's):

* weights: a per-output-channel scale ``max|w| / 127`` over the fan-in,
  floored at 1e-12, and ``round(w / scale)`` clipped to +-127, stored as
  int8 once, offline (``quantize_params``);
* activations: a dynamic per-row scale ``max|x| / 127`` at run time, or a
  static per-tensor ``x_scale`` calibrated offline on representative data
  (``quantize_params_static``);
* the product accumulates in int32 and is rescaled in f32 as
  ``acc * (x_scale * w_scale) + b``, in that order.

The int8 product is exact integer arithmetic, so it is the same on every
device: ``torch._int_mm``, its operands padded with zeros to the shapes it
takes on the card (which adds nothing to the sums). It is a plain matrix
product, as in the JAX package, which computes it outside any Pallas kernel.

A quantized model is a copy of the float one whose every ``core.nn.Linear``
is a ``QuantLinear``; everything else stays float: the attention lifter's
``qkv`` (not a ``Linear``; JAX keeps its 4-D leaf float) and ``pos``. A
``ResBlock`` whose linears are quantized composes them (models/lifters.py),
so a quantized forward launches no residual-block kernel. Gradients through
a quantized model are not supported.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from links_tpu_torch.core.nn import F32, Linear, Policy, record_activation_ranges

__all__ = ["QuantLinear", "dense_int8", "int8_matmul", "is_quantized", "quantize_params",
           "quantize_params_static", "quantize_stacked_static", "quantize_weight"]

# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8. The rows
# always get _PAD_ROWS zero rows, whatever the batch, so that no test of the
# batch size enters a traced program (torch.export would pin the batch on it).
_PAD_ROWS = 16
_MULTIPLE = 8


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) f32 weight -> (int8 weight (out, in), f32 scale (out,)),
    computed on the CPU (the same bits wherever the weight lives), returned
    on the weight's device."""
    wc = w.detach().float().cpu()
    scale = torch.clamp_min(wc.abs().amax(dim=1) / 127.0, 1e-12)
    w_q = torch.clamp(torch.round(wc / scale[:, None]), -127, 127).to(torch.int8)
    return w_q.to(w.device), scale.to(w.device)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    pad = size - t.shape[dim]
    if pad <= 0:
        return t
    widths = [0, 0] * (t.dim() - 1 - dim) + [0, pad]
    return F.pad(t, widths)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32, exact: the operands
    padded with zeros to what ``torch._int_mm`` takes on the card (the rows
    by a fixed _PAD_ROWS, which adds rows no output reads)."""
    m, k = x_q.shape
    n = w_q.shape[0]
    up = -(-k // _MULTIPLE) * _MULTIPLE
    un = -(-n // _MULTIPLE) * _MULTIPLE
    xp = F.pad(x_q, (0, up - k, 0, _PAD_ROWS))
    wp = _pad_to(_pad_to(w_q, 1, up), 0, un)
    return torch._int_mm(xp, wp.t())[:m, :n]


def dense_int8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor,
               x_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The w8a8 linear: x (..., K) -> (..., N) f32, with ``w_q`` (N, K) int8
    and ``w_scale`` (N,); the activation scale is ``x_scale`` (static,
    per tensor) or each row's ``max|x| / 127`` (dynamic)."""
    x = x.float()
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if x_scale is None:
        # a divisor on the device: CUDA divides by a Python number as a
        # multiply by its reciprocal, which may round otherwise
        amax = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12)
        x_scale = amax / amax.new_full((), 127.0)
    x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    acc = int8_matmul(x_q, w_q)
    y = acc.float() * (x_scale * w_scale) + b
    return y.reshape(*lead, -1)


class QuantLinear(nn.Module):
    """An int8 serving linear: ``w_q`` (out, in) int8, ``w_scale`` (out,)
    f32, ``b`` (out,) f32 and, when calibrated, a static ``x_scale`` (0-d
    f32; None serves dynamic per-row scales). Its output is f32 under any
    policy, as the JAX package's int8 dense."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor,
                 x_scale: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("b", b)
        self.register_buffer("x_scale", x_scale)

    @classmethod
    def from_linear(cls, lin: Linear, x_scale: float | None = None) -> QuantLinear:
        w_q, w_scale = quantize_weight(lin.weight)
        xs = None if x_scale is None else torch.tensor(x_scale, dtype=torch.float32,
                                                       device=lin.weight.device)
        return cls(w_q, w_scale, lin.bias.detach().clone(), xs)

    def forward(self, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
        return dense_int8(x, self.w_q, self.w_scale, self.b, self.x_scale)


def _linears(module: nn.Module) -> list[Linear]:
    return [m for m in module.modules() if isinstance(m, Linear)]


def _replace(module: nn.Module, quantized: dict[int, QuantLinear]) -> nn.Module:
    """A copy of ``module`` with each linear of id in ``quantized`` replaced
    by its ``QuantLinear`` (the linears' float weights are not copied)."""
    return copy.deepcopy(module, memo=dict(quantized))


def quantize_params(module: nn.Module) -> nn.Module:
    """A copy of ``module`` (a lifter, a pair, a completer, a dict of them)
    whose every ``Linear`` is a ``QuantLinear`` with dynamic activation
    scales; every other tensor is copied as it is."""
    return _replace(module, {id(m): QuantLinear.from_linear(m) for m in _linears(module)})


def quantize_params_static(module: nn.Module, run_calibration):
    """Int8 quantization with static per-tensor activation scales.

    ``run_calibration(host)`` runs representative forwards of ``host``, a
    CPU copy of ``module``, which computes there with the plain versions of
    the kernels: the JAX package calibrates eagerly on the CPU, and so does
    this (the serving forward that follows runs wherever ``module`` is).
    Each ``Linear`` records the max |x| it saw (a residual block records its
    first linear's input x and its second's h = lrelu(x W1^T + b1)); one
    with a positive range gets ``x_scale = max|x| / 127``, one never reached
    (or only by zeros) keeps dynamic scales.

    -> (quantized copy of ``module``, n_static, n_dynamic)."""
    host = copy.deepcopy(module).cpu()
    with record_activation_ranges() as rec, torch.no_grad():
        run_calibration(host)
    quantized, counts = {}, [0, 0]
    for lin, lin_h in zip(_linears(module), _linears(host)):
        amax = rec.get(id(lin_h))
        static = amax is not None and amax > 0.0
        counts[not static] += 1
        quantized[id(lin)] = QuantLinear.from_linear(
            lin, float(np.float32(amax / 127.0)) if static else None)
    return _replace(module, quantized), counts[0], counts[1]


def quantize_stacked_static(stacked: nn.Module, run_calibration_single):
    """``quantize_params_static`` for a pair of same-shaped models (the
    ``StackedLifter``'s left and right sides, in that order): each side is
    calibrated with ``run_calibration_single(host_i, i)``. A linear that is
    calibrated in only some sides serves dynamic scales in every side, and is
    counted as such (the JAX package's uniform-coverage rule: its stacked
    sides must share one structure). -> (quantized pair, n_static, n_dynamic)
    summed over the sides."""
    sides = list(stacked.children())
    done, tot_s, tot_d = [], 0, 0
    for i, side in enumerate(sides):
        q, s, d = quantize_params_static(side, lambda host, i=i: run_calibration_single(host, i))
        done.append(q)
        tot_s += s
        tot_d += d
    per_side = [{name for name, m in q.named_modules()
                 if isinstance(m, QuantLinear) and m.x_scale is not None} for q in done]
    common = set.intersection(*per_side)
    for q, have in zip(done, per_side):
        mods = dict(q.named_modules())
        for name in have - common:
            mods[name].x_scale = None
            tot_s -= 1
            tot_d += 1
    return copy.deepcopy(stacked, memo={id(s): q for s, q in zip(sides, done)}), tot_s, tot_d


def is_quantized(module: nn.Module) -> bool:
    """True when ``module`` holds int8 serving weights."""
    return any(b.dtype == torch.int8 for b in module.buffers())
