"""The glue of MotionBERT's DSTformer (models/dstformer.py) between its
library GEMMs (``core.nn.mm_bf16``, an f32 product) and attention: each
elementwise or row-local chain between two library kernels as one pass that
reads each operand once and writes the next kernel's operand in the type
that kernel takes. The kernels are CUDA C++ (``csrc/dst_glue.cu``, a plain C
interface loaded with ctypes, built at first use by ``_build``); the JAX
package has no DSTformer, so they replace no TPU kernel.

- ``residual_layernorm(x, u, bias, gamma, beta, dtype)``: s = x + (u + bias)
  in f32, then h = LN(s) gamma + beta (eps 1e-6) in ``dtype``. Without ``u``
  s is x; without ``gamma`` there is no h. -> (s, h). The kernel writes s
  over u's buffer and leaves x as it is.
- ``qkv_bias_split(y, bias, dtype)``: qkv's product y (M, 3C) plus its bias,
  as the planes q, k, v (3, M, C) in ``dtype``.
- ``bias_gelu_cast(y, bias, dtype)``: fc1's product plus its bias through
  the erf GELU, in ``dtype`` (under f32 the kernel writes over y).

Biases, residuals, LayerNorm and GELU are f32; only the output is rounded
to ``dtype`` (bf16 or f32). Each entry point has its plain PyTorch version
beside it (``*_reference``), which CPU tensors take; a CUDA tensor launches
the kernel or raises. The elementwise results of the two agree bit for bit;
the LayerNorm's sums run in another order. Row widths are multiples of 8
(a thread's 8 values are two 16-byte accesses), at most 512 for the
LayerNorm (a row lives in one warp's registers; MotionBERT's width is 512).
``launches`` on each entry point counts its kernel launches. The glue serves
and does not train: an input that needs a gradient while autograd records
is refused.

On the card each launch runs inside an operator of torch's dispatcher
(``torch.ops.links_dst_glue.*``, defined at the first launch), as PyTorch's
own kernels do: the profiler links a kernel to the operator that launched
it, on the launching thread (serve's dispatcher), where a launch made
straight through ctypes is filed under no operator and the profiler's first
thread.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LN_EPS = 1e-6  # MotionBERT's LayerNorms
MAX_LN_WIDTH = 512
_DTYPES = (torch.float32, torch.bfloat16)
_LIB = None
_OPS = None  # the torch.library.Library holding the operators


def _lib():
    global _LIB
    if _LIB is None:
        from links_tpu_torch.ops import _build

        lib = _build.load("dst_glue")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, argtypes in (
                ("dst_residual_layernorm", [p] * 6 + [i, q, i, ctypes.c_float, i, p]),
                ("dst_qkv_bias_split", [p] * 3 + [i, q, i, i, p]),
                ("dst_bias_gelu", [p] * 3 + [i, q, i, i, p])):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i
        lib.dst_glue_error_string.argtypes = [i]
        lib.dst_glue_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(what: str, dtype: torch.dtype, cols: int, named: dict) -> torch.device:
    """``dtype`` f32 or bf16, ``cols`` a multiple of 8, no tensor of
    ``named`` (name -> (tensor, shape)) needing a gradient while autograd
    records, and each a contiguous f32 tensor of its shape on the first
    one's device, 16-byte aligned on the card. -> the device."""
    if dtype not in _DTYPES:
        raise ValueError(f"{what}: writes f32 or bf16, not {dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t, _ in named.values()):
        raise ValueError(f"{what}: serves and does not train; call it under torch.no_grad() "
                         f"or with inputs that need no gradient")
    if cols % 8 or cols < 8:
        raise ValueError(f"{what}: row width {cols} is not a multiple of 8")
    dev = next(iter(named.values()))[0].device
    for name, (t, shape) in named.items():
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or (dev.type == "cuda" and t.data_ptr() % 16):
            raise ValueError(
                f"{what}: {name} must be a contiguous, 16-byte aligned float32 tensor of shape "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)"))
    return dev


def _launch(what: str, dev: torch.device, fn, *args):
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = fn(*args, index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({_lib().dst_glue_error_string(err).decode()})")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _residual_layernorm_cuda(x, u, bias, gamma, beta, h):
    M, C = x.shape
    _launch("residual_layernorm", x.device, _lib().dst_residual_layernorm, x.data_ptr(),
            _ptr(u), _ptr(bias), _ptr(gamma), _ptr(beta), _ptr(h),
            h is not None and h.dtype == torch.bfloat16, M, C, LN_EPS)


def _qkv_bias_split_cuda(y, bias, out):
    _launch("qkv_bias_split", y.device, _lib().dst_qkv_bias_split, y.data_ptr(),
            bias.data_ptr(), out.data_ptr(), out.dtype == torch.bfloat16, *out.shape[1:])


def _bias_gelu_cuda(y, bias, out):
    _launch("bias_gelu_cast", y.device, _lib().dst_bias_gelu, y.data_ptr(), bias.data_ptr(),
            out.data_ptr(), out.dtype == torch.bfloat16, *y.shape)


def _ops():
    """The launches as operators of torch's dispatcher, each writing its
    outputs in place and returning nothing (an operator's result may not
    alias an input), defined once, at the first launch."""
    global _OPS
    if _OPS is None:
        lib = torch.library.Library("links_dst_glue", "DEF")
        for schema, fn in (
                ("residual_layernorm(Tensor x, Tensor(a!)? u, Tensor? bias, Tensor? gamma, "
                 "Tensor? beta, Tensor(b!)? h) -> ()", _residual_layernorm_cuda),
                ("qkv_bias_split(Tensor y, Tensor bias, Tensor(a!) out) -> ()",
                 _qkv_bias_split_cuda),
                ("bias_gelu(Tensor y, Tensor bias, Tensor(a!) out) -> ()", _bias_gelu_cuda)):
            lib.define(schema)
            lib.impl(schema.split("(")[0], fn, "CUDA")
        _OPS = lib
    return torch.ops.links_dst_glue


def residual_layernorm_reference(x, u=None, bias=None, gamma=None, beta=None,
                                 dtype=torch.float32):
    s = x if u is None else x + (u + bias)
    h = None if gamma is None else \
        F.layer_norm(s, (s.shape[-1],), gamma, beta, LN_EPS).to(dtype)
    return s, h


def residual_layernorm(x: torch.Tensor, u: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None, gamma: torch.Tensor | None = None,
                       beta: torch.Tensor | None = None, dtype: torch.dtype = torch.float32):
    """x (M, C) f32; u (M, C) and bias (C,), or neither; gamma and beta (C,),
    or neither. -> (s, h): s = x + (u + bias) (x itself without u), h =
    LN(s) gamma + beta in ``dtype`` (None without gamma). On the card s is
    u's buffer."""
    what = "residual_layernorm"
    if (u is None) != (bias is None) or (gamma is None) != (beta is None) \
            or (u is None and gamma is None):
        raise ValueError(f"{what}: give u with its bias, gamma with beta, and at least one pair")
    M, C = x.shape
    named = {"x": (x, (M, C))}
    if u is not None:
        named.update(u=(u, (M, C)), bias=(bias, (C,)))
    if gamma is not None:
        named.update(gamma=(gamma, (C,)), beta=(beta, (C,)))
        if C > MAX_LN_WIDTH:
            raise ValueError(f"{what}: row width {C} is above {MAX_LN_WIDTH}")
    dev = _check(what, dtype, C, named)
    if dev.type == "cpu":
        return residual_layernorm_reference(x, u, bias, gamma, beta, dtype)
    if u is not None and u.data_ptr() == x.data_ptr():
        raise ValueError(f"{what}: u is written over and may not be x")
    h = None if gamma is None else torch.empty(M, C, dtype=dtype, device=dev)
    _ops().residual_layernorm(x, u, bias, gamma, beta, h)
    residual_layernorm.launches += 1
    return (x if u is None else u), h


residual_layernorm.launches = 0


def qkv_bias_split_reference(y, bias, dtype=torch.float32):
    M, C = y.shape[0], y.shape[1] // 3
    qkv = torch.empty(3, M, C, dtype=dtype, device=y.device)
    # the bias add writes q, k and v each in token order, in ``dtype``
    torch.add(y.view(M, 3, C), bias.view(3, C), out=qkv.permute(1, 0, 2))
    return qkv


def qkv_bias_split(y: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype = torch.float32):
    """y (M, 3C) f32, bias (3C,) -> (3, M, C) in ``dtype``: q, k, v."""
    what = "qkv_bias_split"
    M, C3 = y.shape
    if C3 % 3:
        raise ValueError(f"{what}: y's width {C3} is not 3 C")
    dev = _check(what, dtype, C3 // 3, {"y": (y, (M, C3)), "bias": (bias, (C3,))})
    if dev.type == "cpu":
        return qkv_bias_split_reference(y, bias, dtype)
    qkv = torch.empty(3, M, C3 // 3, dtype=dtype, device=dev)
    _ops().qkv_bias_split(y, bias, qkv)
    qkv_bias_split.launches += 1
    return qkv


qkv_bias_split.launches = 0


def bias_gelu_cast_reference(y, bias, dtype=torch.float32):
    return F.gelu(y + bias).to(dtype)


def bias_gelu_cast(y: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype = torch.float32):
    """y (M, N) f32, bias (N,) -> GELU(y + bias) (M, N) in ``dtype``; under
    f32 the kernel writes it over y."""
    what = "bias_gelu_cast"
    M, N = y.shape
    dev = _check(what, dtype, N, {"y": (y, (M, N)), "bias": (bias, (N,))})
    if dev.type == "cpu":
        return bias_gelu_cast_reference(y, bias, dtype)
    out = y if dtype == torch.float32 else torch.empty(M, N, dtype=dtype, device=dev)
    _ops().bias_gelu(y, bias, out)
    bias_gelu_cast.launches += 1
    return out


bias_gelu_cast.launches = 0
