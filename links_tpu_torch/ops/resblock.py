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
bits). The forward then saves the x and h planes instead of x and h. Each
product runs on ``bf16_plan``'s plan, a function of its shape and the SM
count: the persistent kernel where its tiles (or, for dW, the K slices of
its tiles) fill the card, else one tile per block; ``bf16_products``
counts the products by plan.

Under ``F32`` the forward multiplies in three TF32 passes (~22 significant
bits per product, never one pass): each operand v is big + small, big =
``tf32_big(v)`` (v with its low 13 mantissa bits cleared, what the tensor
core reads of v) and small = ``tf32_small(v)`` (exact), and a product sums
big.big + small.big + big.small. The kernel reads the f32 x, h and weights
as they lie; a weight's small plane comes from ``small_plane`` (one cast per
weight version), x's and h's are made at each call (at one row tile, in the
kernel's shared memory). ``res_block_forward_tf32``
is the plain emulation of those numerics, ``f32_plan`` the kernel's tile
plan. The f32 backward multiplies at f32 precision through three bf16 terms
per operand (``split_reference``: t0 + t1 + t2 == v), summing the six term
products i + j < 3 per K tile; a weight's term planes come from
``term_planes`` (one split per weight version), g2's, x's and h's are made
at each call, g1's by the first product. ``res_block_backward_terms`` is
the plain emulation of those numerics (and of the one-term controls),
``f32_bwd_plan`` the kernel's tile plan per product.

For ``torch.export`` the forward is also a registered op,
``links_tpu_torch::res_block_forward`` (``res_block_op``): a traced program
cannot read a fake tensor's ``data_ptr`` nor branch on its device, so under
export ``res_block`` emits the op, whose CUDA implementation is the kernel
call above and whose CPU implementation is the plain forward. A process that
loads such a program imports this module to register the op; the kernels
are built at the op's first CUDA call. Eager callers keep the direct call.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from links_tpu_torch.core.nn import BF16, F32, Policy, dense, leaky_relu

NEG_SLOPE = 0.01
_TILE = 64  # the kernels' output tile: the width must be a multiple
_TF32_BIG = -8192  # 0xFFFFE000 as an int32: a tf32 value's sign, exponent and 10 mantissa bits
# The f32 forward's output tiles (warpgroups of 64 rows, warpgroups that split K,
# columns), in the order f32_plan tries them, and its ring's depth limit.
F32_TILES = ((2, 1, 128), (1, 2, 64), (1, 2, 32), (1, 4, 16), (1, 4, 8))
F32_MAX_STAGES = 32
# the kernel's instantiations (csrc/resblock.cu:run_tf32), the (wg, kw, cols,
# a_split) that f32_plan gives for hidden widths to 4096 and batches to 8192
F32_KERNELS = frozenset({(2, 1, 128, False), (1, 2, 64, False), (1, 1, 64, False),
                         (1, 2, 32, False), (1, 2, 32, True), (1, 4, 16, False),
                         (1, 1, 16, False), (1, 4, 16, True), (1, 4, 8, False), (1, 1, 8, False),
                         (1, 4, 8, True)})
F32_CHUNK_BYTES = 32768  # a ring stage holds several K tiles (one TMA box each) up to this
SMEM_BYTES = 232448  # dynamic shared memory a Hopper block can have (227 KB)
# The f32 backward's output tiles (warpgroups of 64 rows, columns, K tile depth), as its kernel
# builds them (csrc/resblock.cu:run_terms3), and its K splits (blocks of a cluster that share a
# tile's K tiles), in the order f32_bwd_plan tries them; its ring depth limit. Clusters of 4 and
# 8 blocks ran slower than 2 at every batch on an H100 (a cluster's blocks share a GPC, and the
# card's GPCs hold fewer such clusters at once than their blocks would fill).
F32_BWD_TILES = ((2, 128, 32), (1, 64, 64))
F32_BWD_SPLITS = (1, 2)
F32_BWD_MIN_TILES = 2  # K tiles a block of a split keeps at least
F32_BWD_MAX_STAGES = 8
# The bf16 route's tiles (persistent, rows, cols), as its kernels build them
# (csrc/resblock.cu:run_wgmma): one output tile per block (wgmma_gemm), and the persistent
# kernel's (wgmma_gemm_persistent, one consumer warpgroup per tile); the persistent tile
# bf16_plan takes (64 x 256 ran every product faster than 128 x 128 at B = 1,856 to 65,536
# on an H100), its K splits in the order it tries them (2 fills the card with dW's tiles at
# hidden 1024), and the K tiles (64 deep) a slice keeps at least.
BF16_KERNELS = frozenset({(False, 64, 64), (True, 64, 256)})
BF16_PERSISTENT = (64, 256)
BF16_SPLITS = (1, 2)
BF16_MIN_SLICE = 16
BF16_TK = 64  # the bf16 route's K tile


def _is_bf16(policy: Policy) -> bool:
    return policy.compute_dtype == torch.bfloat16


def _round(t: torch.Tensor, policy: Policy) -> torch.Tensor:
    return t.bfloat16().float() if _is_bf16(policy) else t


def split_reference(v: torch.Tensor, terms: int, mask: torch.Tensor | None = None):
    """The plain split of an f32 operand into ``terms`` (1 to 3) bf16 planes:
    t0 = bf16(v), t1 = bf16(v - t0), t2 = bf16(v - t0 - t1), each remainder
    exact. hi = t0 and lo = t1 hold v to 16 significant bits; t0 + t1 + t2
    == v wherever t2 is no bf16 subnormal that rounds (|v| >= 2^-110, or v a
    multiple of 2^-133) and v is below bf16's largest value. With ``mask``, v
    is first multiplied by lrelu'(mask) (g2 = dy * lrelu'(a2))."""
    if mask is not None:
        v = v * _dlrelu(mask)
    planes = []
    for _ in range(terms):
        planes.append(v.bfloat16())
        v = v - planes[-1].float()
    return tuple(planes)


def _dlrelu(v: torch.Tensor) -> torch.Tensor:
    """LeakyReLU's derivative, 1 at exactly 0 (as ``leaky_relu``'s own
    gradient; torch's ``F.leaky_relu`` gives 0.01 there)."""
    return torch.where(v >= 0, 1.0, NEG_SLOPE)


def tf32_big(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` with its low 13 mantissa bits cleared: the tf32 value the
    tensor core reads when handed v."""
    return (v.view(torch.int32) & _TF32_BIG).view(torch.float32)


def tf32_small(v: torch.Tensor) -> torch.Tensor:
    """v - tf32_big(v), exact in f32, signed as v: tf32_big(v) + tf32_small(v)
    is v bit for bit (-0 included)."""
    return torch.copysign(v - tf32_big(v), v)


def _dense_tf32(x, w, b, passes: int):
    """x w^T + b as tf32 products: ``passes`` 3 sums big.big and then
    small.big + big.small (each small term entering as tf32, as the tensor
    core truncates it), the f32 forward kernel's numerics; 1 is big.big
    alone, one TF32 pass."""
    xb, wb = tf32_big(x), tf32_big(w)
    out = xb @ wb.T
    if passes == 3:
        out = out + (tf32_big(tf32_small(x)) @ wb.T + xb @ tf32_big(tf32_small(w)).T)
    return out + b


def res_block_forward_tf32(x, w1, b1, w2, b2, passes: int = 3):
    """The plain emulation of the f32 forward kernel's numerics (``passes`` =
    3), or of one TF32 pass (1): -> (y, a1, h, a2). Under f32 matmuls (TF32
    off) on either device."""
    a1 = _dense_tf32(x, w1, b1, passes)
    h = leaky_relu(a1)
    a2 = _dense_tf32(h, w2, b2, passes)
    return leaky_relu(a2) + x, a1, h, a2


# the f32 backward's term products (i, j), i + j < 3, smallest first, as its kernel sums them
_TERM_PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def _terms_product(a, b, method: str, split: int = 1, tk: int = 64):
    """a (M, K) @ b (K, N), f32. ``method`` 'bf16x3': as the f32 backward's
    kernel sums it: three bf16 terms per operand, the six term products i + j
    < 3 of each ``tk``-deep K tile summed in f32, the tiles added in order
    within each of ``split`` shares of K and the shares added in order.
    'bf16' and 'tf32': each operand as one term (bf16-rounded, or
    ``tf32_big``), with f32 sums: the controls."""
    if method != "bf16x3":
        one = (lambda t: t.bfloat16().float()) if method == "bf16" else tf32_big
        return one(a) @ one(b)
    ta = [t.float() for t in split_reference(a, 3)]
    tb = [t.float() for t in split_reference(b, 3)]
    nk = -(-a.shape[1] // tk)
    out = None
    for s in range(split):
        part = None
        for kt in range(s * nk // split, (s + 1) * nk // split):
            ks = slice(kt * tk, (kt + 1) * tk)
            tile = None
            for i, j in _TERM_PAIRS:
                prod = ta[i][:, ks] @ tb[j][ks]
                tile = prod if tile is None else tile + prod
            part = tile if part is None else part + tile
        out = part if out is None else out + part
    return out


def res_block_backward_terms(dy, x, w1, w2, a1, h, a2, method: str = "bf16x3",
                             plans: tuple | None = None):
    """The plain emulation of the f32 backward kernel's numerics (``method``
    'bf16x3'; ``plans``: the K tiles and splits of dh/dx and of dW, as
    ``f32_bwd_plans`` gives them, else one 64-deep split), or one of the
    controls its check must reject: every product operand (g2, g1, W1, W2,
    x, h) as one bf16 term ('bf16') or its tf32_big term ('tf32', one TF32
    pass), with f32 sums. db1 and db2 are f32 sums of g1 and g2. -> (dx,
    dW1, db1, dW2, db2)."""
    act, wgt = ((p.split, p.tk) for p in plans) if plans else ((1, 64), (1, 64))
    g2 = dy * _dlrelu(a2)
    g1 = _terms_product(g2, w2, method, *act) * _dlrelu(a1)
    dx = dy + _terms_product(g1, w1, method, *act)
    dw1 = _terms_product(g1.mT, x, method, *wgt)
    dw2 = _terms_product(g2.mT, h, method, *wgt)
    return dx, dw1, g1.sum(0), dw2, g2.sum(0)


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


class F32Plan(NamedTuple):
    wg: int          # warpgroups of 64 output rows each
    kw: int          # warpgroups that split K between them, per 64 rows
    rows: int        # output tile rows
    cols: int        # output tile columns (wgmma's n)
    a_rows: int      # rows of A's TMA box: the tile's, or at one row tile B's rounded to 8
    chunk: int       # K tiles (32 deep) per ring stage and TMA box
    stages: int      # the ring's depth
    a_split: bool    # A's small tiles made in shared memory (one row tile), not read
    row_tiles: int
    col_tiles: int
    grid: int        # blocks of one product, one output tile each
    smem: int        # dynamic shared memory bytes of a block


def f32_stage_bytes(a_rows: int, cols: int, chunk: int) -> int:
    """One ring stage of the f32 forward: ``chunk`` K tiles of A's master and
    small planes (a_rows rows of 32 f32) and of B's (cols rows)."""
    return 2 * chunk * (a_rows + cols) * 128


def f32_smem_bytes(wg: int, cols: int, a_rows: int, chunk: int, stages: int) -> int:
    """A block's dynamic shared memory (the kernel's res_block_f32_smem_bytes):
    the swizzle's alignment slack, the ring, the rows a 64 x wg-row wgmma
    reads past the ring's last A tile when A's box is shorter, and a full
    and an empty barrier per stage."""
    return (1024 + stages * f32_stage_bytes(a_rows, cols, chunk) + (64 * wg - a_rows) * 128
            + 16 * stages)


@functools.lru_cache(maxsize=None)
def f32_plan(batch: int, hidden: int, sms: int) -> F32Plan:
    """The f32 forward's tile plan for ``batch`` rows at width ``hidden`` on a
    card with ``sms`` SMs: the first of ``F32_TILES`` whose grid leaves at
    most 1/8 of the SMs without a block, else the narrowest (the most
    blocks); every block owns one output tile and loops over all of K, split
    over the tile's warpgroups (narrow tiles' wgmmas are short, and one
    warpgroup's run in order). At one row tile A is a few rows, and there
    its small tiles are made in shared memory. A ring stage holds as many K
    tiles (one TMA box per operand) as keep it within F32_CHUNK_BYTES and
    the ring 2 stages deep per K group, or holding all of K. The ring takes
    the shared memory of one block per SM, or of two where the grid is
    larger than the card and half still holds 3 stages and 2 per K group,
    else (the K split dropped) 3 stages."""
    if batch < 1 or hidden < _TILE or hidden % _TILE:
        raise ValueError(f"no f32 plan for batch {batch} at hidden width {hidden}")
    fill = sms - sms // 8
    for wg, kw, cols in F32_TILES:
        row_tiles, col_tiles = -(-batch // (64 * wg)), hidden // cols
        if hidden % cols == 0 and row_tiles * col_tiles >= fill:
            break
    rows, grid = 64 * wg, row_tiles * col_tiles
    a_rows = rows if row_tiles > 1 else min(rows, -(-batch // 8) * 8)
    fixed = 1024 + (rows - a_rows) * 128
    nk = hidden // 32
    # two blocks of an SM each have half its 228 KB, less 1 KB the card keeps per block
    pair = (SMEM_BYTES + 1024) // 2 - 1024

    def depth(budget: int, chunk: int) -> int:
        return min(F32_MAX_STAGES, -(-nk // chunk),
                   (budget - fixed) // (f32_stage_bytes(a_rows, cols, chunk) + 16))

    for chunk in (8, 4, 2, 1):
        need = min(2 * kw, -(-nk // chunk))
        if chunk == 1 or (f32_stage_bytes(a_rows, cols, chunk) <= F32_CHUNK_BYTES
                          and depth(SMEM_BYTES, chunk) >= need):
            break
    stages = depth(SMEM_BYTES, chunk)
    if grid > sms and depth(pair, chunk) >= 3:
        stages, kw = depth(pair, chunk), kw if depth(pair, chunk) >= need else 1
    a_split = wg == 1 and row_tiles == 1 and kw > 1
    return F32Plan(wg, kw, rows, cols, a_rows, chunk, stages, a_split, row_tiles, col_tiles, grid,
                   f32_smem_bytes(wg, cols, a_rows, chunk, stages))


class F32BwdPlan(NamedTuple):
    wg: int          # warpgroups of 64 output rows each
    rows: int        # output tile rows
    cols: int        # output tile columns (wgmma's n)
    tk: int          # K tile depth (bf16 values)
    split: int       # blocks of a cluster that share the tile's K tiles
    stages: int      # the ring's depth
    row_tiles: int
    col_tiles: int
    grid: int        # blocks of the product: row_tiles x col_tiles x split
    smem: int        # dynamic shared memory bytes of a block


def f32_bwd_stage_bytes(wg: int, cols: int, tk: int) -> int:
    """One ring stage of the f32 backward: a tk-deep K tile of A's three
    bf16 term planes (64 wg rows) and of B's (cols columns)."""
    return 3 * (64 * wg + cols) * tk * 2


def f32_bwd_smem_bytes(wg: int, cols: int, tk: int, stages: int) -> int:
    """A block's dynamic shared memory (the kernel's
    res_block_f32_bwd_smem_bytes): the swizzle's alignment slack, the ring
    and a full and an empty barrier per stage."""
    return 1024 + stages * (f32_bwd_stage_bytes(wg, cols, tk) + 16)


def f32_bwd_parked_bytes(wg: int, cols: int) -> int:
    """What the epilogue parks in the drained ring: 16 x (cols + 8) f32 per
    consumer warp."""
    return 4 * wg * 16 * (cols + 8) * 4


@functools.lru_cache(maxsize=None)
def f32_bwd_plan(m: int, n: int, k: int, sms: int) -> F32BwdPlan:
    """The f32 backward's tile plan for one product C (m x n), k deep, on a
    card with ``sms`` SMs: the first (tile, split) whose grid fills the card,
    trying the tiles of ``F32_BWD_TILES`` in order (the 128 x 128 tile reads
    half the bytes per product of the 64 x 64 one) and for each the splits
    of ``F32_BWD_SPLITS`` that leave every block of the cluster
    ``F32_BWD_MIN_TILES`` K tiles; else the one with the most blocks.
    Unsplit, a grid fills the card when it leaves at most 1/8 of the SMs
    without a block; split, at most 1/3, with no more blocks than SMs (a
    cluster's barrier and sums cost more than the last SMs give, and a
    second wave of clusters more still: tools/sweep_k1_f32_bwd.py on an
    H100). The ring is as deep as shared memory allows (at least deep enough
    to park the epilogue's sums): that of one block per SM, or of two 64-row
    blocks where the grid is larger than the card and half still holds 2
    stages."""
    if m < 1 or k < 1 or n < 64 or n % 64:
        raise ValueError(f"no f32 backward plan for a {m} x {n} product {k} deep")

    def grid(c):
        return -(-m // (64 * c[0])) * (n // c[1]) * c[3]

    def fills(c):
        return grid(c) >= sms - sms // 8 if c[3] == 1 else sms - sms // 3 <= grid(c) <= sms

    cands = [(wg, cols, tk, split) for wg, cols, tk in F32_BWD_TILES if n % cols == 0
             for split in F32_BWD_SPLITS
             if split == 1 or -(-k // tk) // split >= F32_BWD_MIN_TILES]
    wg, cols, tk, split = next((c for c in cands if fills(c)), max(cands, key=grid))
    local = -(-(-(-k // tk)) // split)  # K tiles of the cluster's busiest block
    least = -(-f32_bwd_parked_bytes(wg, cols) // f32_bwd_stage_bytes(wg, cols, tk))
    pair = (SMEM_BYTES + 1024) // 2 - 1024

    def depth(budget: int) -> int:
        return max(least, min(local, F32_BWD_MAX_STAGES,
                              (budget - 1024) // (f32_bwd_stage_bytes(wg, cols, tk) + 16)))

    g = grid((wg, cols, tk, split))
    # two 128-row tiles' blocks cannot share an SM: each takes most of its registers
    stages = (depth(pair) if wg == 1 and g > sms and depth(pair) >= min(2, local)
              else depth(SMEM_BYTES))
    return F32BwdPlan(wg, 64 * wg, cols, tk, split, stages, -(-m // (64 * wg)), n // cols, g,
                      f32_bwd_smem_bytes(wg, cols, tk, stages))


def f32_bwd_plans(batch: int, hidden: int, sms: int) -> tuple[F32BwdPlan, F32BwdPlan]:
    """The f32 backward's plans of dh and dx (B x H, H deep) and of dW1 and
    dW2 (H x H, B deep)."""
    return f32_bwd_plan(batch, hidden, hidden, sms), f32_bwd_plan(hidden, hidden, batch, sms)


class Bf16Plan(NamedTuple):
    persistent: bool  # one block per SM walking work units, else one output tile per block
    rows: int        # output tile rows
    cols: int        # output tile columns (wgmma's n)
    split: int       # K slices per output tile, added in slice order (persistent only)
    row_tiles: int
    col_tiles: int
    units: int       # work units: output tiles x K slices
    grid: int        # blocks of the product


def bf16_smem_bytes(persistent: bool, rows: int, cols: int, terms: int,
                    staged: bool = True) -> int:
    """A block's dynamic shared memory on a bf16 tile for a product of
    ``terms`` A planes (the kernel's res_block_bf16_smem_bytes): the
    swizzle's alignment slack, then stages of a 64-deep K tile of A's planes
    and of B, each with a full and an empty barrier. One tile per block: 3
    stages where they fit 96 KB (two blocks per SM), else 4. The persistent
    kernel: as many as a block holds, to 8, beside the consumer warps' 16 x
    72 f32 staging tiles (``staged``: every product but dW) and two flags."""
    stage = (terms * rows + cols) * 128
    if not persistent:
        return 1024 + (3 if 96 * 1024 // stage == 3 else 4) * (stage + 16)
    extra = (8 * 16 * 72 * 4 if staged else 0) + 16
    stages = min(8, (SMEM_BYTES - 1024 - extra) // (stage + 16))
    return 1024 + stages * (stage + 16) + extra


@functools.lru_cache(maxsize=None)
def bf16_plan(m: int, n: int, k: int, sms: int) -> Bf16Plan:
    """The bf16 route's plan for one product C (m x n), k deep, on a card
    with ``sms`` SMs. The persistent kernel's tile (``BF16_PERSISTENT``, one
    consumer warpgroup per tile, two per block taking units in turn) where
    its work units fill the card, leaving at most 1/8 of the SMs without
    one: the output tiles, or each split into the fewest K slices of
    ``BF16_SPLITS`` that do, each slice keeping ``BF16_MIN_SLICE`` K tiles;
    min(sms, units) blocks. Else one 64 x 64 tile per block."""
    if m < 1 or k < 1 or n < _TILE or n % _TILE:
        raise ValueError(f"no bf16 plan for a {m} x {n} product {k} deep")
    fill, nk = sms - sms // 8, -(-k // BF16_TK)
    rows, cols = BF16_PERSISTENT
    if n % cols == 0:
        row_tiles, col_tiles = -(-m // rows), n // cols
        for split in BF16_SPLITS:
            if split > 1 and nk // split < BF16_MIN_SLICE:
                break
            units = row_tiles * col_tiles * split
            if units >= fill:
                return Bf16Plan(True, rows, cols, split, row_tiles, col_tiles, units,
                                min(sms, units))
    row_tiles, col_tiles = -(-m // _TILE), n // _TILE
    tiles = row_tiles * col_tiles
    return Bf16Plan(False, _TILE, _TILE, 1, row_tiles, col_tiles, tiles, tiles)


def bf16_plans(batch: int, hidden: int, sms: int) -> tuple[Bf16Plan, Bf16Plan]:
    """The bf16 plans of the forward's products and of dh and dx (B x H, H
    deep), and of dW1 and dW2 (H x H, B deep)."""
    return bf16_plan(batch, hidden, hidden, sms), bf16_plan(hidden, hidden, batch, sms)


def bf16_units(p: Bf16Plan, k: int):
    """The work units of a product on plan ``p``, K ``k`` deep, in the order
    the kernel numbers them: (row tile, column tile, K slice, first K tile,
    K tiles). A persistent block takes units blockIdx, blockIdx + grid, ...;
    slice s of nk K tiles takes [s nk / split, (s + 1) nk / split)."""
    nk, tiles = -(-k // BF16_TK), p.row_tiles * p.col_tiles
    for u in range(p.units):
        s, t = divmod(u, tiles)
        first = s * nk // p.split
        yield t // p.col_tiles, t % p.col_tiles, s, first, (s + 1) * nk // p.split - first


def _bf16_args(p: Bf16Plan) -> tuple[int, ...]:
    return int(p.persistent), p.rows, p.cols, p.split, p.grid


_LIB = None
# CUDA kernel launches of one call of the forward and the backward, by policy (True: bf16);
# the f32 forward launches one less where its plan makes A's small tiles in shared memory
_LAUNCHES = {"forward": {True: 3, False: 3}, "backward": {True: 6, False: 6}}


def _lib():
    global _LIB
    if _LIB is None:
        from links_tpu_torch.ops import _build

        lib = _build.load("resblock")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, argtypes in (("res_block_forward_bf16", [p] * 12 + [i] * 8 + [p]),
                               ("res_block_backward_bf16", [p] * 20 + [i] * 13 + [p]),
                               ("res_block_bf16_smem_bytes", [i] * 5),
                               ("res_block_forward_f32", [p] * 13 + [i] * 10 + [p]),
                               ("res_block_backward_f32", [p] * 13 + [i] * 13 + [p]),
                               ("res_block_split", [p] * 5 + [i] * 3 + [p]),
                               ("res_block_f32_bwd_smem_bytes", [i] * 4),
                               ("res_block_small", [p] * 2 + [i] * 3 + [p]),
                               ("res_block_tf32_product", [p] * 3 + [i] * 4 + [p]),
                               ("res_block_f32_smem_bytes", [i] * 5)):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i
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


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# id(weight) -> (weakref, _version, data_ptr, plane): the bf16 planes, the small planes and
# the three-term planes
_PLANES: dict[int, tuple] = {}
_SMALL: dict[int, tuple] = {}
_TERMS: dict[int, tuple] = {}


def _cached(cache: dict, w: torch.Tensor, make) -> tuple[torch.Tensor, bool]:
    """``make(w)`` kept in ``cache`` until ``w`` changes in place (an optimizer
    step, ``load_state_dict``, ``copy_``; each bumps ``w._version``) or dies.
    A write through ``w.data`` bypasses the version counter: none is made.
    An inference tensor (the serving path's weights) has no version counter
    and cannot change outside inference mode: its plane is made once.
    -> (plane, whether it was made now)."""
    key = id(w)
    version = None if w.is_inference() else w._version
    hit = cache.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version and hit[2] == w.data_ptr():
        return hit[3], False
    plane = make(w.detach())
    cache[key] = (weakref.ref(w, lambda _, k=key: cache.pop(k, None)), version, w.data_ptr(),
                  plane)
    return plane, True


def weight_plane(w: torch.Tensor) -> torch.Tensor:
    """The bf16 plane of a weight, ``w.to(torch.bfloat16)``, cast once per
    version of ``w`` (see ``_cached``)."""
    plane, made = _cached(_PLANES, w, lambda t: t.to(torch.bfloat16))
    weight_plane.casts += made
    return plane


weight_plane.casts = 0  # casts made (cache misses)


def _small(v: torch.Tensor) -> torch.Tensor:
    """``tf32_small(v)`` of an f32 array: the small-plane kernel (one launch)
    for a CUDA tensor, the plain version for a CPU one."""
    if v.device.type == "cpu":
        return tf32_small(v)
    dev, index = _check({"v": (v, tuple(v.shape))}, 1, _TILE)
    out = torch.empty_like(v)
    err = _lib().res_block_small(v.data_ptr(), out.data_ptr(), v.numel() // v.shape[-1],
                                 v.shape[-1], index, _stream(dev))
    _raise_on(err, "res_block small-plane launch")
    return out


def small_plane(w: torch.Tensor) -> torch.Tensor:
    """The small plane of an f32 weight, ``tf32_small(w)``, made once per
    version of ``w`` as ``weight_plane`` casts its bf16 plane."""
    plane, made = _cached(_SMALL, w, _small)
    small_plane.casts += made
    return plane


small_plane.casts = 0  # small planes made (cache misses)


def term_planes(w: torch.Tensor) -> torch.Tensor:
    """The three bf16 term planes of an f32 weight (3, out, in), made once
    per version of ``w`` as ``weight_plane`` casts its bf16 plane, in a cache
    of their own."""
    plane, made = _cached(_TERMS, w, lambda t: split_planes(t, 3))
    term_planes.casts += made
    return plane


term_planes.casts = 0  # term planes made (cache misses)


def tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) b^T (b: (N, K)), f32, as one TF32 pass: for CUDA tensors the
    f32 forward's kernel handed the raw f32 operands (N a multiple of 64),
    for CPU tensors the plain product of their ``tf32_big`` terms. What the
    f32 forward's design assumes of the tensor core: the two agree bit for
    bit on the card when the kernel is handed ``tf32_big(a)``, ``tf32_big(b)``."""
    if a.device.type == "cpu":
        return tf32_big(a) @ tf32_big(b).T
    (m, k), n = a.shape, b.shape[0]
    dev, index = _check({"a": (a, (m, k)), "b": (b, (n, k))}, 1, _TILE)
    out = torch.empty(m, n, device=dev)
    err = _lib().res_block_tf32_product(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                                        index, _stream(dev))
    _raise_on(err, "res_block tf32 product launch")
    tf32_product.launches += 1
    return out


tf32_product.launches = 0


def split_planes(v: torch.Tensor, terms: int, mask: torch.Tensor | None = None):
    """``split_reference`` as the split kernel (one launch) for a CUDA
    tensor, the plain version for a CPU one: -> the (terms, rows, cols) bf16
    planes of a 2D f32 ``v``."""
    if v.device.type == "cpu":
        return torch.stack(split_reference(v, terms, mask))
    named = {"v": (v, tuple(v.shape))}
    if mask is not None:
        named["mask"] = (mask, tuple(v.shape))
    if v.dim() != 2 or terms not in (1, 2, 3):
        raise ValueError(f"split kernel: (rows, cols) f32 into 1 to 3 planes, got "
                         f"{tuple(v.shape)} into {terms}")
    dev, index = _check(named, *v.shape)
    planes = torch.empty((terms, *v.shape), dtype=torch.bfloat16, device=dev)
    err = _lib().res_block_split(v.data_ptr(), mask.data_ptr() if mask is not None else None,
                                 *(planes[t].data_ptr() if t < terms else None for t in range(3)),
                                 *v.shape, index, _stream(dev))
    _raise_on(err, "res_block split launch")
    split_planes.launches += 1
    return planes


split_planes.launches = 0


def res_block_forward(x, w1, b1, w2, b2, policy: Policy):
    """The forward kernels (3 launches, or 2 where the f32 plan makes A's
    small tiles in shared memory): -> (y, a1, h, a2, x_saved), each (B, H).
    Under BF16, h and x_saved are the bf16 planes of h and x; under F32, h
    is f32 and x_saved is x, and the products run on ``f32_plan``'s tiles."""
    if x.dim() != 2:
        raise ValueError(f"res_block kernel: x must be (B, H), got {tuple(x.shape)}")
    n, hid = x.shape
    dev, index = _check({"x": (x, (n, hid)), "w1": (w1, (hid, hid)), "b1": (b1, (hid,)),
                         "w2": (w2, (hid, hid)), "b2": (b2, (hid,))}, n, hid)
    bf16 = _is_bf16(policy)
    launches = _LAUNCHES["forward"][bf16]
    y, a1, a2 = (torch.empty(n, hid, device=dev) for _ in range(3))
    if bf16:
        p = bf16_plan(n, hid, hid, _sms(index))
        x_saved, h = (torch.empty(n, hid, dtype=torch.bfloat16, device=dev) for _ in "xh")
        split_buf, partial, count = _split_scratch(dev, (p, n, hid), (p, n, hid))
        err = _lib().res_block_forward_bf16(
            x.data_ptr(), weight_plane(w1).data_ptr(), b1.data_ptr(),
            weight_plane(w2).data_ptr(), b2.data_ptr(), x_saved.data_ptr(), a1.data_ptr(),
            h.data_ptr(), a2.data_ptr(), y.data_ptr(), partial, count, n, hid, *_bf16_args(p),
            index, _stream(dev))
        del split_buf  # kept until the launches were queued
        plans = (p, p)
    else:
        p = f32_plan(n, hid, _sms(index))
        launches -= p.a_split
        x_saved, h = x, torch.empty(n, hid, device=dev)
        # x's and h's small planes, unless A's small tiles are made in shared memory
        small = None if p.a_split else torch.empty(2, n, hid, device=dev)
        xs, hs = (0, 0) if small is None else (small[0].data_ptr(), small[1].data_ptr())
        err = _lib().res_block_forward_f32(
            x.data_ptr(), w1.data_ptr(), small_plane(w1).data_ptr(), b1.data_ptr(),
            w2.data_ptr(), small_plane(w2).data_ptr(), b2.data_ptr(), xs, hs, a1.data_ptr(),
            h.data_ptr(), a2.data_ptr(), y.data_ptr(), n, hid, p.wg, p.kw, p.cols, p.a_rows,
            p.chunk, p.stages, p.a_split, index, _stream(dev))
    _raise_on(err, "res_block_forward launch")
    if bf16:
        _count_products(plans)
    res_block_forward.launches += 1
    res_block_forward.f32_launches += not bf16
    res_block_forward.kernel_launches += launches
    return y, a1, h, a2, x_saved


def _split_scratch(dev, *products) -> tuple[torch.Tensor | None, int | None, int | None]:
    """The scratch of a call's bf16 products (plan, M, N), in launch order,
    where a plan splits K: the slices' f32 sums (split x M x N, the largest
    such product's; the products run one after another) and one int per
    output tile of every product (the slice counters, zeroed by the call's
    first launch). -> (the buffer, to keep until the launches are queued,
    the sums' address, the counters'), or Nones where no plan splits."""
    if all(p.split == 1 for p, _, _ in products):
        return None, None, None
    floats = max(p.split * m * n for p, m, n in products if p.split > 1)
    ints = sum(p.row_tiles * p.col_tiles for p, _, _ in products)
    scratch = torch.empty(floats + ints, dtype=torch.float32, device=dev)
    return scratch, scratch.data_ptr(), scratch.data_ptr() + 4 * floats


def _count_products(plans):
    for p in plans:
        bf16_products["persistent" if p.persistent else "tile"] += 1


def _bwd_args(p: F32BwdPlan) -> tuple[int, ...]:
    return p.wg, p.cols, p.tk, p.split, p.stages


def res_block_backward(dy, x, w1, w2, a1, h, a2, policy: Policy):
    """The backward kernels (6 launches): -> (dx, dW1, db1, dW2, db2). ``x``
    and ``h`` are what the forward saved: under BF16 their bf16 planes
    (``kernel_saved`` makes them from the plain forward's); under F32 the f32
    x and h, split into three bf16 terms at each call, and the products run
    on ``f32_bwd_plans``' tiles."""
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
        p_act, p_w = bf16_plans(n, hid, _sms(index))
        # one scratch buffer: g2's hi and lo planes, g1's hi and lo planes, then the column
        # sums of each 16 rows of g1 and of g2 (f32, for db1 and db2)
        plane, sums = n * hid * 2, -(-n // 16) * hid * 4
        scratch = torch.empty(4 * plane + 2 * sums, dtype=torch.uint8, device=dev)
        base = scratch.data_ptr()
        ptrs = [base + i * plane for i in range(4)] + [base + 4 * plane + i * sums for i in (0, 1)]
        split_buf, partial, count = _split_scratch(dev, (p_act, n, hid), (p_act, n, hid),
                                                   (p_w, hid, hid), (p_w, hid, hid))
        err = _lib().res_block_backward_bf16(
            dy.data_ptr(), x.data_ptr(), weight_plane(w1).data_ptr(),
            weight_plane(w2).data_ptr(), a1.data_ptr(), h.data_ptr(), a2.data_ptr(), *ptrs,
            partial, count, dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), n, hid, *_bf16_args(p_act), *_bf16_args(p_w), index, _stream(dev))
        del split_buf  # kept until the launches were queued
    else:
        plan_act, plan_w = f32_bwd_plans(n, hid, _sms(index))
        # one scratch buffer: the three term planes of g2, g1, x and h (bf16), then the column
        # sums of each 16 rows of g1 and of g2 (f32, for db1 and db2)
        plane, sums = n * hid * 2, -(-n // 16) * hid * 4
        scratch = torch.empty(12 * plane + 2 * sums, dtype=torch.uint8, device=dev)
        err = _lib().res_block_backward_f32(
            dy.data_ptr(), x.data_ptr(), term_planes(w1).data_ptr(), term_planes(w2).data_ptr(),
            a1.data_ptr(), h.data_ptr(), a2.data_ptr(), scratch.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), n, hid,
            *_bwd_args(plan_act), *_bwd_args(plan_w), index, _stream(dev))
    _raise_on(err, "res_block_backward launch")
    if bf16:
        _count_products((p_act, p_act, p_w, p_w))
    res_block_backward.launches += 1
    res_block_backward.f32_launches += not bf16
    res_block_backward.kernel_launches += _LAUNCHES["backward"][bf16]
    return dx, dw1, db1, dw2, db2


res_block_forward.launches = 0   # calls that launched the forward kernels
res_block_forward.f32_launches = 0  # those of them under F32 (the tf32 kernel)
res_block_backward.launches = 0  # calls that launched the backward kernels
res_block_backward.f32_launches = 0  # those of them under F32 (the three-term kernel)
res_block_forward.kernel_launches = 0   # CUDA kernels those calls launched
res_block_backward.kernel_launches = 0
# bf16 products (2 per forward call, 4 per backward call) by plan: the persistent kernel's, or
# today's one tile per block
bf16_products = {"persistent": 0, "tile": 0}


def kernel_saved(x, a1, h, a2, policy: Policy):
    """What the kernels' forward saves for the backward, made from the plain
    forward's x and (a1, h, a2): under BF16 the x and h planes."""
    if _is_bf16(policy):
        x, h = x.bfloat16(), h.bfloat16()
    return x, a1, h, a2


@torch.library.custom_op("links_tpu_torch::res_block_forward", mutates_args=(),
                         device_types="cpu")
def res_block_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The block's forward ``y`` as a registered op (no gradient): on the CPU
    the plain forward."""
    return res_block_forward_reference(x, w1, b1, w2, b2, BF16 if bf16 else F32)[0]


@res_block_op.register_kernel("cuda")
def _res_block_op_cuda(x, w1, b1, w2, b2, bf16):
    return res_block_forward(x, w1, b1, w2, b2, BF16 if bf16 else F32)[0]


@res_block_op.register_fake
def _res_block_op_fake(x, w1, b1, w2, b2, bf16):
    return x.new_empty(x.shape, dtype=torch.float32)


def res_block(x, w1, b1, w2, b2, policy: Policy):
    """The residual block, differentiable: the CUDA kernels for CUDA tensors,
    the plain version for CPU tensors; the registered op under export."""
    if torch.compiler.is_exporting():
        return res_block_op(x, w1, b1, w2, b2, _is_bf16(policy))
    if x.device.type == "cpu":
        return res_block_reference(x, w1, b1, w2, b2, policy)
    return _ResBlock.apply(x, w1, b1, w2, b2, policy, res_block_forward, res_block_backward)
