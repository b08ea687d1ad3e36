"""The side lifters' residual block with its gradient (counterpart of the
fused residual block links_tpu/experimental/pallas_resblock.py, K1):

    y = lrelu(lrelu(x @ W1^T + b1) @ W2^T + b2) + x        x: (B, H)

with no outer LeakyReLU (the ``Lifter`` applies it), under a dtype
``Policy``. ``res_block`` is what ``models.lifters.ResBlock`` calls. For CUDA
tensors it runs the hand-written CUDA kernels of ``csrc/resblock.cu``
(forward and backward; the source's header gives their bound on the H100 and
their design) and raises on what they do not take; for CPU tensors it runs
``res_block_reference``, the plain PyTorch version of the same function.

Both are ``torch.autograd.Function``s with a hand-written backward that
follows ``jax.grad`` of the JAX package's ``res_block_apply``. Under ``BF16``
the matmul inputs x, h, W1 and W2 are rounded to bf16 and products
accumulate in f32; in the backward the gradients stay f32 as matmul
operands, and each of the four products (dh, g1 W1, dW1, dW2) is rounded to
bf16, as the transposes of JAX's bf16 dots are. The forward saves a1, h and
a2 for the backward.
"""

from __future__ import annotations

import ctypes

import torch

from links_tpu_torch.core.nn import Policy, dense, leaky_relu

NEG_SLOPE = 0.01
_TILE = 64  # the kernels' output tile: the width must be a multiple


def _is_bf16(policy: Policy) -> bool:
    return policy.compute_dtype == torch.bfloat16


def _round(t: torch.Tensor, policy: Policy) -> torch.Tensor:
    return t.bfloat16().float() if _is_bf16(policy) else t


def _dlrelu(v: torch.Tensor) -> torch.Tensor:
    """LeakyReLU's derivative, 1 at exactly 0 (as ``leaky_relu``'s own
    gradient; torch's ``F.leaky_relu`` gives 0.01 there)."""
    return torch.where(v >= 0, 1.0, NEG_SLOPE)


def res_block_forward_reference(x, w1, b1, w2, b2, policy: Policy):
    """Plain forward: -> (y, a1, h, a2)."""
    a1 = dense(x, w1, b1, policy)
    h = leaky_relu(a1)
    a2 = dense(h, w2, b2, policy)
    return leaky_relu(a2) + x, a1, h, a2


def res_block_backward_reference(dy, x, w1, w2, a1, h, a2, policy: Policy):
    """Plain backward: -> (dx, dW1, db1, dW2, db2), weights' gradients in
    torch's (out, in) layout."""
    g2 = dy * _dlrelu(a2)
    g1 = _round(g2 @ _round(w2, policy), policy) * _dlrelu(a1)
    dx = dy + _round(g1 @ _round(w1, policy), policy)
    dw1 = _round(g1.mT @ _round(x, policy), policy)
    dw2 = _round(g2.mT @ _round(h, policy), policy)
    return dx, dw1, g1.sum(0), dw2, g2.sum(0)


class _ResBlock(torch.autograd.Function):
    """The block with a given forward and backward implementation."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, policy, fwd, bwd):
        y, a1, h, a2 = fwd(x, w1, b1, w2, b2, policy)
        ctx.save_for_backward(x, w1, w2, a1, h, a2)
        ctx.policy, ctx.bwd = policy, bwd
        return y

    @staticmethod
    def backward(ctx, dy):
        grads = ctx.bwd(dy.contiguous(), *ctx.saved_tensors, ctx.policy)
        return (*grads, None, None, None)


def res_block_reference(x, w1, b1, w2, b2, policy: Policy):
    """The plain PyTorch version of the block, differentiable."""
    return _ResBlock.apply(x, w1, b1, w2, b2, policy, res_block_forward_reference,
                           res_block_backward_reference)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from links_tpu_torch.ops import _build

        lib = _build.load("resblock")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.res_block_forward_launch.argtypes = [p] * 9 + [i] * 4 + [p]
        lib.res_block_forward_launch.restype = i
        lib.res_block_backward_launch.argtypes = [p] * 13 + [i] * 4 + [p]
        lib.res_block_backward_launch.restype = i
        lib.res_block_error_string.argtypes = [i]
        lib.res_block_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(err: int, what: str):
    if err:
        msg = _lib().res_block_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _check(named: dict, batch: int, hidden: int):
    """Every tensor a contiguous, 16-byte aligned f32 CUDA tensor of its
    shape on the first one's device; ``hidden`` a multiple of the tile."""
    if hidden % _TILE or hidden < _TILE:
        raise ValueError(f"res_block kernel: hidden width {hidden} is not a multiple of {_TILE}")
    if batch < 1:
        raise ValueError("res_block kernel: empty batch")
    dev = next(iter(named.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"res_block kernel runs on CUDA tensors, got {dev}")
    for name, (t, shape) in named.items():
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"res_block kernel: {name} must be a contiguous, 16-byte aligned float32 "
                f"tensor of shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}" + ("" if t.is_contiguous() else " (not contiguous)"))
    return dev, (dev.index if dev.index is not None else torch.cuda.current_device())


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def res_block_forward(x, w1, b1, w2, b2, policy: Policy):
    """The forward kernels (2 launches): -> (y, a1, h, a2), each (B, H) f32."""
    if x.dim() != 2:
        raise ValueError(f"res_block kernel: x must be (B, H), got {tuple(x.shape)}")
    n, hid = x.shape
    dev, index = _check({"x": (x, (n, hid)), "w1": (w1, (hid, hid)), "b1": (b1, (hid,)),
                         "w2": (w2, (hid, hid)), "b2": (b2, (hid,))}, n, hid)
    y, a1, h, a2 = (torch.empty(n, hid, device=dev) for _ in range(4))
    err = _lib().res_block_forward_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        a1.data_ptr(), h.data_ptr(), a2.data_ptr(), y.data_ptr(), n, hid,
        int(not _is_bf16(policy)), index, _stream(dev))
    _raise_on(err, "res_block_forward launch")
    res_block_forward.launches += 1
    return y, a1, h, a2


def res_block_backward(dy, x, w1, w2, a1, h, a2, policy: Policy):
    """The backward kernels (5 launches): -> (dx, dW1, db1, dW2, db2)."""
    n, hid = x.shape
    act = (n, hid)
    dev, index = _check({"dy": (dy, act), "x": (x, act), "w1": (w1, (hid, hid)),
                         "w2": (w2, (hid, hid)), "a1": (a1, act), "h": (h, act),
                         "a2": (a2, act)}, n, hid)
    g1, dx = (torch.empty(n, hid, device=dev) for _ in range(2))
    dw1, dw2 = (torch.empty(hid, hid, device=dev) for _ in range(2))
    db1, db2 = (torch.empty(hid, device=dev) for _ in range(2))
    err = _lib().res_block_backward_launch(
        dy.data_ptr(), x.data_ptr(), w1.data_ptr(), w2.data_ptr(), a1.data_ptr(), h.data_ptr(),
        a2.data_ptr(), g1.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), n, hid, int(not _is_bf16(policy)), index, _stream(dev))
    _raise_on(err, "res_block_backward launch")
    res_block_backward.launches += 1
    return dx, dw1, db1, dw2, db2


res_block_forward.launches = 0   # calls that launched the forward kernels
res_block_backward.launches = 0  # calls that launched the backward kernels


def res_block(x, w1, b1, w2, b2, policy: Policy):
    """The residual block, differentiable: the CUDA kernels for CUDA tensors,
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return res_block_reference(x, w1, b1, w2, b2, policy)
    return _ResBlock.apply(x, w1, b1, w2, b2, policy, res_block_forward, res_block_backward)
