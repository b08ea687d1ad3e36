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
bf16, as the transposes of JAX's bf16 dots are. The forward saves a1 and a2
and the matmul inputs x and h for the backward.

Under ``BF16`` the kernels read every matmul operand as bf16 planes: a
weight's plane comes from ``weight_plane`` (one cast per weight version),
x's from the split kernel (``split_planes``), h's from the forward's first
product; an f32 gradient enters as two planes, hi and lo (16 significant
bits). The forward then saves the x and h planes instead of x and h.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from links_tpu_torch.core.nn import Policy, dense, leaky_relu

NEG_SLOPE = 0.01
_TILE = 64  # the kernels' output tile: the width must be a multiple


def _is_bf16(policy: Policy) -> bool:
    return policy.compute_dtype == torch.bfloat16


def _round(t: torch.Tensor, policy: Policy) -> torch.Tensor:
    return t.bfloat16().float() if _is_bf16(policy) else t


def split_reference(v: torch.Tensor, terms: int, mask: torch.Tensor | None = None):
    """The plain split of an f32 operand into ``terms`` (1 or 2) bf16 planes:
    hi = bf16(v) and lo = bf16(v - hi), which hold v to 16 significant bits.
    With ``mask``, v is first multiplied by lrelu'(mask) (g2 = dy * lrelu'(a2))."""
    if mask is not None:
        v = v * _dlrelu(mask)
    hi = v.bfloat16()
    return (hi,) if terms == 1 else (hi, (v - hi.float()).bfloat16())


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
        # the kernels' forward also returns the x it saves (under BF16 its plane)
        y, a1, h, a2, *x_saved = fwd(x, w1, b1, w2, b2, policy)
        ctx.save_for_backward(*(x_saved or [x]), w1, w2, a1, h, a2)
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
# CUDA kernel launches of one call of the forward and the backward, by policy
_LAUNCHES = {"forward": {True: 3, False: 2}, "backward": {True: 6, False: 5}}


def _lib():
    global _LIB
    if _LIB is None:
        from links_tpu_torch.ops import _build

        lib = _build.load("resblock")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, pointers in (("res_block_forward_f32", 9), ("res_block_forward_bf16", 10),
                               ("res_block_backward_f32", 13),
                               ("res_block_backward_bf16", 18)):
            getattr(lib, name).argtypes = [p] * pointers + [i] * 3 + [p]
            getattr(lib, name).restype = i
        lib.res_block_split.argtypes = [p] * 4 + [i] * 3 + [p]
        lib.res_block_split.restype = i
        lib.res_block_error_string.argtypes = [i]
        lib.res_block_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(err: int, what: str):
    if err:
        msg = _lib().res_block_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _check(named: dict, batch: int, hidden: int):
    """Every tensor a contiguous, 16-byte aligned CUDA tensor of its shape and
    dtype (f32 unless given) on the first one's device; ``hidden`` a multiple
    of the tile."""
    if hidden % _TILE or hidden < _TILE:
        raise ValueError(f"res_block kernel: hidden width {hidden} is not a multiple of {_TILE}")
    if batch < 1:
        raise ValueError("res_block kernel: empty batch")
    dev = next(iter(named.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"res_block kernel runs on CUDA tensors, got {dev}")
    for name, (t, shape, *dtype) in named.items():
        dtype = dtype[0] if dtype else torch.float32
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"res_block kernel: {name} must be a contiguous, 16-byte aligned {dtype} "
                f"tensor of shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}" + ("" if t.is_contiguous() else " (not contiguous)"))
    return dev, (dev.index if dev.index is not None else torch.cuda.current_device())


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


_PLANES: dict[int, tuple] = {}  # id(weight) -> (weakref, _version, data_ptr, bf16 plane)


def weight_plane(w: torch.Tensor) -> torch.Tensor:
    """The bf16 plane of a weight, ``w.to(torch.bfloat16)``, cast once per
    version of ``w``: cached until the weight changes in place (an optimizer
    step, ``load_state_dict``, ``copy_``; each bumps ``w._version``) or dies.
    A write through ``w.data`` bypasses the version counter: none is made.
    An inference tensor (the serving path's weights) has no version counter
    and cannot change outside inference mode: its plane is cast once."""
    key = id(w)
    version = None if w.is_inference() else w._version
    hit = _PLANES.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version and hit[2] == w.data_ptr():
        return hit[3]
    plane = w.detach().to(torch.bfloat16)
    _PLANES[key] = (weakref.ref(w, lambda _, k=key: _PLANES.pop(k, None)), version,
                    w.data_ptr(), plane)
    weight_plane.casts += 1
    return plane


weight_plane.casts = 0  # casts made (cache misses)


def split_planes(v: torch.Tensor, terms: int, mask: torch.Tensor | None = None):
    """``split_reference`` as the split kernel (one launch) for a CUDA
    tensor, the plain version for a CPU one: -> ``terms`` bf16 planes."""
    if v.device.type == "cpu":
        return split_reference(v, terms, mask)
    named = {"v": (v, tuple(v.shape))}
    if mask is not None:
        named["mask"] = (mask, tuple(v.shape))
    if v.dim() != 2 or terms not in (1, 2):
        raise ValueError(f"split kernel: (B, H) f32 into 1 or 2 planes, got {tuple(v.shape)}")
    dev, index = _check(named, *v.shape)
    planes = [torch.empty(v.shape, dtype=torch.bfloat16, device=dev) for _ in range(terms)]
    err = _lib().res_block_split(v.data_ptr(), mask.data_ptr() if mask is not None else None,
                                 planes[0].data_ptr(),
                                 planes[1].data_ptr() if terms == 2 else None,
                                 *v.shape, index, _stream(dev))
    _raise_on(err, "res_block split launch")
    split_planes.launches += 1
    return tuple(planes)


split_planes.launches = 0


def res_block_forward(x, w1, b1, w2, b2, policy: Policy):
    """The forward kernels (3 launches under BF16, 2 under F32): -> (y, a1, h,
    a2, x_saved), each (B, H). Under BF16, h and x_saved are the bf16 planes
    of h and x; under F32, h is f32 and x_saved is x."""
    if x.dim() != 2:
        raise ValueError(f"res_block kernel: x must be (B, H), got {tuple(x.shape)}")
    n, hid = x.shape
    dev, index = _check({"x": (x, (n, hid)), "w1": (w1, (hid, hid)), "b1": (b1, (hid,)),
                         "w2": (w2, (hid, hid)), "b2": (b2, (hid,))}, n, hid)
    bf16 = _is_bf16(policy)
    y, a1, a2 = (torch.empty(n, hid, device=dev) for _ in range(3))
    if bf16:
        x_saved, h = (torch.empty(n, hid, dtype=torch.bfloat16, device=dev) for _ in "xh")
        err = _lib().res_block_forward_bf16(
            x.data_ptr(), weight_plane(w1).data_ptr(), b1.data_ptr(),
            weight_plane(w2).data_ptr(), b2.data_ptr(), x_saved.data_ptr(), a1.data_ptr(),
            h.data_ptr(), a2.data_ptr(), y.data_ptr(), n, hid, index, _stream(dev))
    else:
        x_saved, h = x, torch.empty(n, hid, device=dev)
        err = _lib().res_block_forward_f32(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            a1.data_ptr(), h.data_ptr(), a2.data_ptr(), y.data_ptr(), n, hid, index,
            _stream(dev))
    _raise_on(err, "res_block_forward launch")
    res_block_forward.launches += 1
    res_block_forward.kernel_launches += _LAUNCHES["forward"][bf16]
    return y, a1, h, a2, x_saved


def res_block_backward(dy, x, w1, w2, a1, h, a2, policy: Policy):
    """The backward kernels (6 launches under BF16, 5 under F32): -> (dx, dW1,
    db1, dW2, db2). ``x`` and ``h`` are what the forward saved: under BF16
    their bf16 planes (``kernel_saved`` makes them from the plain forward's)."""
    n, hid = x.shape
    act = (n, hid)
    bf16 = _is_bf16(policy)
    planes = torch.bfloat16 if bf16 else torch.float32
    dev, index = _check({"dy": (dy, act), "x": (x, act, planes), "w1": (w1, (hid, hid)),
                         "w2": (w2, (hid, hid)), "a1": (a1, act), "h": (h, act, planes),
                         "a2": (a2, act)}, n, hid)
    dx = torch.empty(n, hid, device=dev)
    dw1, dw2 = (torch.empty(hid, hid, device=dev) for _ in range(2))
    db1, db2 = (torch.empty(hid, device=dev) for _ in range(2))
    if bf16:
        # one scratch buffer: g2's hi and lo planes, g1's hi and lo planes, then the column
        # sums of each 16 rows of g1 and of g2 (f32, for db1 and db2)
        plane, sums = n * hid * 2, -(-n // 16) * hid * 4
        scratch = torch.empty(4 * plane + 2 * sums, dtype=torch.uint8, device=dev)
        base = scratch.data_ptr()
        ptrs = [base + i * plane for i in range(4)] + [base + 4 * plane + i * sums for i in (0, 1)]
        err = _lib().res_block_backward_bf16(
            dy.data_ptr(), x.data_ptr(), weight_plane(w1).data_ptr(),
            weight_plane(w2).data_ptr(), a1.data_ptr(), h.data_ptr(), a2.data_ptr(), *ptrs,
            dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), n,
            hid, index, _stream(dev))
    else:
        g1 = torch.empty(n, hid, device=dev)
        err = _lib().res_block_backward_f32(
            dy.data_ptr(), x.data_ptr(), w1.data_ptr(), w2.data_ptr(), a1.data_ptr(),
            h.data_ptr(), a2.data_ptr(), g1.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), n, hid, index, _stream(dev))
    _raise_on(err, "res_block_backward launch")
    res_block_backward.launches += 1
    res_block_backward.kernel_launches += _LAUNCHES["backward"][bf16]
    return dx, dw1, db1, dw2, db2


res_block_forward.launches = 0   # calls that launched the forward kernels
res_block_backward.launches = 0  # calls that launched the backward kernels
res_block_forward.kernel_launches = 0   # CUDA kernels those calls launched
res_block_backward.kernel_launches = 0


def kernel_saved(x, a1, h, a2, policy: Policy):
    """What the kernels' forward saves for the backward, made from the plain
    forward's x and (a1, h, a2): under BF16 the x and h planes."""
    if _is_bf16(policy):
        x, h = x.bfloat16(), h.bfloat16()
    return x, a1, h, a2


def res_block(x, w1, b1, w2, b2, policy: Policy):
    """The residual block, differentiable: the CUDA kernels for CUDA tensors,
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return res_block_reference(x, w1, b1, w2, b2, policy)
    return _ResBlock.apply(x, w1, b1, w2, b2, policy, res_block_forward, res_block_backward)
