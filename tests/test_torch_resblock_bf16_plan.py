"""The bf16 route of the residual-block kernel (K1) on the CPU: its tile plan
(``ops/resblock.py:bf16_plan``, a pure function of the product's shape and
the SM count) and the plain emulation of the order in which its persistent
kernel adds the K slices of a split product, against the plain bf16
backward. The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu_torch.core.nn import BF16
from links_tpu_torch.ops import resblock as K1

H100_SMS = 132
FILL = H100_SMS - H100_SMS // 8  # 7/8 of the SMs
HIDDEN = 1024
# the benchmark's training cells: stage 4's completers (49,152 rows), 3a's
# augmented batch (65,536), stage 4's lifters and a smaller batch (16,384)
CELL_ROWS = (16384, 49152, 65536)
# the plan is checked at these batches: chip_smoke.py's K1_BATCHES, the
# cells' rows, one ragged, and around the plan's changes
BATCHES = (1, 37, 128, 256, 512, 768, 1024, 1792, 1793, 1856, 1984, 2048, 4096, 16384, 49152,
           49153, 65536)
K1_BF16_ULP = 2.0 ** -7
K1_FLIP_REL, K1_FLIP_SHARE = 1e-5, 0.1


def _products(batch, hidden=HIDDEN):
    """(m, n, k) of the block's five bf16 products: the forward's two, dh
    and dx (each batch x hidden, hidden deep) and dW1, dW2 (hidden x
    hidden, batch deep)."""
    act, wgt = (batch, hidden, hidden), (hidden, hidden, batch)
    return {"fwd1": act, "fwd2": act, "dh": act, "dx": act, "dw": wgt}


def _plans(hidden):
    return [(m, n, k, K1.bf16_plan(m, n, k, H100_SMS)) for b in BATCHES
            for m, n, k in set(_products(b, hidden).values())]


def _todays_tile(m, n, sms=H100_SMS):
    """run_wgmma's tile before the persistent plan: 128 x 128 where those
    tiles gave every SM a block, else 64 x 64."""
    return 128 if n % 128 == 0 and -(-m // 128) * (n // 128) >= sms else 64


@pytest.mark.parametrize("hidden", [128, 1024, 1536])
def test_bf16_plan_covers_every_output_once_and_each_k_slice_once(hidden):
    """Every output element lies in exactly one tile; each tile's K tiles
    are cut into the plan's slices, each taken by one unit, in one fixed
    order: slice-major, then row tile, then column tile, each slice's K
    tiles following the one before."""
    for m, n, k, p in _plans(hidden):
        nk = -(-k // K1.BF16_TK)
        seen = np.zeros((p.row_tiles * p.rows, n), np.int32)
        k_seen = np.zeros((p.row_tiles, p.col_tiles, nk), np.int32)
        units = list(K1.bf16_units(p, k))
        assert len(units) == p.units == p.row_tiles * p.col_tiles * p.split, (m, n, k)
        for u, (tm, tn, s, first, count) in enumerate(units):
            assert u == (s * p.row_tiles + tm) * p.col_tiles + tn, (m, n, k)
            if s == 0:
                seen[tm * p.rows:(tm + 1) * p.rows, tn * p.cols:(tn + 1) * p.cols] += 1
            assert count >= 1 and first == s * nk // p.split, (m, n, k)
            k_seen[tm, tn, first:first + count] += 1
        assert (seen == 1).all() and (k_seen == 1).all(), (m, n, k)
        assert (p.row_tiles - 1) * p.rows < m <= p.row_tiles * p.rows, (m, n, k)
        assert p.col_tiles * p.cols == n, (m, n, k)


@pytest.mark.parametrize("hidden", [128, 1024, 1536])
def test_bf16_plan_fits_a_block_and_takes_legal_wgmma_widths(hidden):
    """A tile the kernel is built for; m64 rows per warpgroup and an n that
    wgmma takes; a persistent warpgroup holds its whole tile (at most 128
    f32 accumulators a thread); the ring of both the forward's one-plane and
    the backward's two-plane products, staged or not, within a block's
    227 KB; at least 3 stages; the grid one block per SM at most."""
    for m, n, k, p in _plans(hidden):
        assert (p.persistent, p.rows, p.cols) in K1.BF16_KERNELS, (m, n, k)
        assert p.rows % 64 == 0 and p.cols % 8 == 0 and 8 <= p.cols <= 256, (m, n, k)
        per_warpgroup = p.rows * p.cols if p.persistent else 64 * p.cols
        assert per_warpgroup // 128 <= 128, (m, n, k)
        for terms in (1, 2):
            for staged in (True, False):
                smem = K1.bf16_smem_bytes(p.persistent, p.rows, p.cols, terms, staged)
                stage = (terms * p.rows + p.cols) * 128
                assert smem <= K1.SMEM_BYTES and (smem - 1024) // stage >= 3, (m, n, k)
        if p.persistent:
            assert p.grid == min(H100_SMS, p.units) and p.split in K1.BF16_SPLITS, (m, n, k)
        else:
            assert p.split == 1 and p.grid == p.units, (m, n, k)


@pytest.mark.parametrize("rows", CELL_ROWS)
def test_bf16_plan_fills_the_card_at_the_cells_rows(rows):
    """All five products at the training cells' rows take the persistent
    plan and give at least 7/8 of an H100's SMs a block, each with work."""
    for name, (m, n, k) in _products(rows).items():
        p = K1.bf16_plan(m, n, k, H100_SMS)
        assert p.persistent, name
        assert FILL <= p.grid <= p.units, name


def test_bf16_plan_splits_only_the_weight_gradients_at_the_cells_rows():
    """dW's 64 wide tiles are too few for the card: its batch-long K is
    split; the batch-wide products are not."""
    for rows in CELL_ROWS:
        act, wgt = K1.bf16_plans(rows, HIDDEN, H100_SMS)
        assert act.split == 1 and wgt.split > 1, rows
        assert -(-rows // K1.BF16_TK) // wgt.split >= K1.BF16_MIN_SLICE, rows


def test_bf16_plan_splits_a_batch_wide_product_whose_tiles_are_few():
    """At hidden 2048 and B = 768 the batch-wide products' 96 wide tiles
    leave the card short: their K is split in 2; dW's 256 tiles are not."""
    act, wgt = K1.bf16_plans(768, 2048, H100_SMS)
    assert act.persistent and act.split == 2 and act.grid == H100_SMS
    assert wgt.persistent and wgt.split == 1


@pytest.mark.parametrize("hidden", [128, 256, 1024])
def test_bf16_plan_keeps_todays_tile_up_to_768_rows(hidden):
    """At B <= 768 (the published batch of 256, the trunk and the DP tests)
    every product keeps the one-tile-per-block kernel on today's tile."""
    for batch in range(1, 769):
        for m, n, k in set(_products(batch, hidden).values()):
            p = K1.bf16_plan(m, n, k, H100_SMS)
            size = _todays_tile(m, n)
            assert not p.persistent and (p.rows, p.cols) == (size, size), (batch, m, n, k)


def test_bf16_plan_takes_the_fewest_slices_that_fill_the_card():
    """A persistent plan's split is the first of BF16_SPLITS whose units
    fill the card; no smaller split would, or it would leave a slice fewer
    than BF16_MIN_SLICE K tiles."""
    for m, n, k, p in _plans(HIDDEN):
        if not p.persistent:
            continue
        tiles = p.row_tiles * p.col_tiles
        assert tiles * p.split >= FILL, (m, n, k)
        for split in K1.BF16_SPLITS[:K1.BF16_SPLITS.index(p.split)]:
            assert tiles * split < FILL, (m, n, k)
        nk = -(-k // K1.BF16_TK)
        assert p.split == 1 or nk // p.split >= K1.BF16_MIN_SLICE, (m, n, k)


def test_bf16_plan_is_a_function_of_the_shape_and_the_sms():
    """The same arguments give the same plan; another SM count can give
    another grid."""
    assert K1.bf16_plan(49152, 1024, 1024, 132) == K1.bf16_plan(49152, 1024, 1024, 132)
    assert K1.bf16_plan(49152, 1024, 1024, 114).grid == 114


def test_bf16_plan_refuses_widths_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no bf16 plan"):
        K1.bf16_plan(8, 100, 100, H100_SMS)
    with pytest.raises(ValueError, match="no bf16 plan"):
        K1.bf16_plan(0, 1024, 1024, H100_SMS)
    with pytest.raises(ValueError, match="no bf16 plan"):
        K1.bf16_plan(1024, 1024, 0, H100_SMS)


def test_bf16_kernels_are_the_instantiations_and_the_plans_reach_each():
    """BF16_KERNELS is the list csrc/resblock.cu builds, and bf16_plan gives
    each of them at the port's width (none is dead code)."""
    src = (Path(K1.__file__).parent / "csrc" / "resblock.cu").read_text()
    built = {(kind == "PERSISTENT", int(rows), int(cols)) for kind, rows, cols in
             re.findall(r"^\s*K1_BF16_(TILE|PERSISTENT)\((\d+), (\d+)\)", src, re.M)}
    assert built == K1.BF16_KERNELS
    reached = {(p.persistent, p.rows, p.cols) for _, _, _, p in _plans(HIDDEN)}
    assert reached == K1.BF16_KERNELS


def _split_product(a_terms, b, split: int):
    """sum over a's bf16 terms t of a_t (M, K) @ b (K, N) in f32, with K
    in ``split`` slices of 64-deep tiles as ``bf16_units`` cuts it: each
    slice's sum, then the slices added in order, as the persistent kernel's
    last slice adds them."""
    nk = -(-a_terms[0].shape[1] // K1.BF16_TK)
    out = None
    for s in range(split):
        ks = slice(s * nk // split * K1.BF16_TK, (s + 1) * nk // split * K1.BF16_TK)
        part = sum(t.float()[:, ks] @ b.float()[ks] for t in a_terms)
        out = part if out is None else out + part
    return out


def _backward_split(dy, x, w1, w2, a1, h, a2, splits):
    """The plain emulation of the bf16 backward kernel's sums: g2 and g1 as
    hi and lo bf16 planes, x, h, W1, W2 as bf16, each product's K in the
    slices of ``splits`` (dh and dx, dW1 and dW2; ``bf16_plans``' split)
    summed in f32 and added in slice order, then rounded to bf16. db1 and
    db2 are f32 sums of g1 and g2. -> (dx, dW1, db1, dW2, db2)."""
    def r(t):
        return t.bfloat16().float()

    act, wgt = splits
    g2 = dy * K1._dlrelu(a2)
    g2t = K1.split_reference(g2, 2)
    g1 = r(_split_product(g2t, r(w2), act)) * K1._dlrelu(a1)
    g1t = K1.split_reference(g1, 2)
    dx = dy + r(_split_product(g1t, r(w1), act))
    dw1 = r(_split_product([t.mT for t in g1t], r(x), wgt))
    dw2 = r(_split_product([t.mT for t in g2t], r(h), wgt))
    return dx, dw1, g1.sum(0), dw2, g2.sum(0)


def _block(batch, hidden, seed):
    g = torch.Generator().manual_seed(seed)
    bound = hidden ** -0.5
    w1, w2 = (torch.empty(hidden, hidden).uniform_(-bound, bound, generator=g) for _ in "12")
    b1, b2 = (torch.empty(hidden).uniform_(-bound, bound, generator=g) for _ in "12")
    x, dy = (torch.randn(batch, hidden, generator=g) for _ in "xy")
    return x, w1, b1, w2, b2, dy


def _grad_close(name, got, want):
    """The card's rule for the bf16 backward: dx, dW1, dW2 (rounded after the
    sum) within one bf16 unit of the largest value with under 10% of their
    elements off by more than 1e-5 of their own value; db1, db2 within 1e-3
    of the largest."""
    err = (got - want).abs()
    scale = float(want.abs().max())
    if name in ("dx", "dw1", "dw2"):
        assert float(err.max()) <= K1_BF16_ULP * scale, name
        assert float((err > K1_FLIP_REL * want.abs()).float().mean()) < K1_FLIP_SHARE, name
    else:
        assert float(err.max()) <= 1e-3 * scale, name


@pytest.mark.parametrize("splits", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_split_sum_order_holds_the_plain_bf16_backward(splits):
    """The persistent kernel's sums (g1, g2 as hi and lo planes; each
    product's K slices summed in f32 and added in slice order, then rounded
    to bf16) within the card's one-ulp rule of the plain bf16 backward."""
    batch, hidden = 1024, 128
    x, w1, b1, w2, b2, dy = _block(batch, hidden, 5)
    _, a1, h, a2 = K1.res_block_forward_reference(x, w1, b1, w2, b2, BF16)
    got = _backward_split(dy, x, w1, w2, a1, h, a2, splits)
    want = K1.res_block_backward_reference(dy, x, w1, w2, a1, h, a2, BF16)
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        _grad_close(name, g, w)


def test_split_sum_adds_the_plans_slices_in_order():
    """The emulation's dW is the bf16 rounding of the slices' f32 sums of
    bf16_units' K ranges, added from slice 0 on, bit for bit; one slice
    alone differs from it."""
    batch, hidden, split = 2048, 256, 2
    x, w1, b1, w2, b2, dy = _block(batch, hidden, 6)
    _, a1, h, a2 = K1.res_block_forward_reference(x, w1, b1, w2, b2, BF16)
    p = K1.Bf16Plan(True, 64, 256, split, 1, 1, split, split)
    g2 = K1.split_reference(dy * K1._dlrelu(a2), 2)
    hb = h.bfloat16().float()
    want = None
    for _, _, _, first, count in K1.bf16_units(p, batch):
        ks = slice(first * K1.BF16_TK, (first + count) * K1.BF16_TK)
        part = sum(t.float()[ks].mT @ hb[ks] for t in g2)
        want = part if want is None else want + part
    got = _backward_split(dy, x, w1, w2, a1, h, a2, (1, split))[3]
    assert torch.equal(got, want.bfloat16().float())
    whole = _backward_split(dy, x, w1, w2, a1, h, a2, (1, 1))[3]
    assert not torch.equal(got, whole)
