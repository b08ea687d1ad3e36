"""The f32 forward of the residual-block kernel (K1) on the CPU: its numerics
(three TF32 passes, ``ops/resblock.py:res_block_forward_tf32``, the plain
emulation of what the kernel sums) against links_tpu's f32 res_block_apply
and the Pallas kernel in interpret mode, the big/small split it rests on,
and its tile plan as a pure function. The kernel itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu.core import nn as jnn
from links_tpu.experimental import fused_res_block
from links_tpu.models.lifters import init_res_block, res_block_apply
from links_tpu_torch.core.nn import F32
from links_tpu_torch.ops import resblock as K1

D = 128  # small width; the numerics and the plan are width-generic
H100_SMS = 132
# Three TF32 passes hold each product to ~22 significant bits, so every output
# is within K1_F32_TOL of its largest value (chip_smoke.py's bound); one pass
# (11-bit operands, the truncation biased towards zero) is off by ~1e-3.
K1_F32_TOL = 1e-5
NAMES = ("y", "a1", "h", "a2")


def _block(batch, seed):
    """Seeded numpy inputs: the JAX block's params and x."""
    p = jax.tree.map(np.asarray, init_res_block(jax.random.PRNGKey(seed), D))
    x = np.random.default_rng(seed).normal(size=(batch, D)).astype(np.float32)
    return p, x


def _port(p, x):
    """-> x, W1, b1, W2, b2 as torch tensors in the port's (out, in) layout."""
    return [torch.tensor(np.ascontiguousarray(a)) for a in
            (x, p["l1"]["w"].T, p["l1"]["b"], p["l2"]["w"].T, p["l2"]["b"])]


def _jax_forward(p, x):
    """(y, a1, h, a2) of the JAX package's f32 res_block_apply."""
    a1 = jnn.dense(p["l1"], jnp.asarray(x), jnn.F32)
    h = jnn.leaky_relu(a1)
    a2 = jnn.dense(p["l2"], h, jnn.F32)
    y = res_block_apply(p, jnp.asarray(x), jnn.F32)
    return [np.asarray(t) for t in (y, a1, h, a2)]


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("batch", [1, 37, 70, 192])
def test_three_tf32_passes_match_jax_res_block_apply(batch):
    """All four outputs within K1_F32_TOL of JAX's f32 block; one TF32 pass
    (the control) beyond it on every output."""
    p, x = _block(batch, batch)
    want = _jax_forward(p, x)
    got = K1.res_block_forward_tf32(*_port(p, x), passes=3)
    one = K1.res_block_forward_tf32(*_port(p, x), passes=1)
    for name, g, o, w in zip(NAMES, got, one, want):
        assert _rel_err(g.numpy(), w) <= K1_F32_TOL, name
        assert _rel_err(o.numpy(), w) > K1_F32_TOL, name


@pytest.mark.parametrize("batch", [1, 70])
def test_three_tf32_passes_match_the_pallas_kernel(batch):
    """y against the Pallas kernel in interpret mode (f32), as
    tests/test_pallas_ops.py runs it; the one-pass control beyond the bound."""
    p, x = _block(batch, 100 + batch)
    want = np.asarray(fused_res_block(jnp.asarray(x), p["l1"]["w"], p["l1"]["b"], p["l2"]["w"],
                                      p["l2"]["b"], 64, True))
    got = K1.res_block_forward_tf32(*_port(p, x), passes=3)[0].numpy()
    one = K1.res_block_forward_tf32(*_port(p, x), passes=1)[0].numpy()
    assert _rel_err(got, want) <= K1_F32_TOL
    assert _rel_err(one, want) > K1_F32_TOL


def test_three_tf32_passes_are_not_the_plain_f32_forward():
    """The emulation sums tf32 products: it differs from the plain f32
    forward (TF32 off), within the bound."""
    p, x = _block(64, 7)
    args = _port(p, x)
    got = K1.res_block_forward_tf32(*args, passes=3)
    want = K1.res_block_forward_reference(*args, F32)
    for name, g, w in zip(NAMES, got, want):
        assert not torch.equal(g, w), name
        assert _rel_err(g.numpy(), w.numpy()) <= K1_F32_TOL, name


_EXTREMES = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, -1.1754942e-38, 1.1754944e-38, 5.877e-39,
     3.4028235e38, -3.4028235e38, 1.0, -1.0, 1.0000001, -1.9999999, 65504.0, 2.0 ** -24,
     1.2345678e-20, -8.765432e25], dtype=np.float32)


@pytest.mark.parametrize("values", ["extremes", "normal", "tiny", "huge", "subnormal"])
def test_big_and_small_are_an_exact_split(values):
    """big + small == v bit for bit (subnormals, +-0 and large exponents
    included); big has its low 13 mantissa bits clear; small holds the
    cleared bits (below one tf32 unit of a normal v), signed as v."""
    rng = np.random.default_rng(0)
    v = {"extremes": _EXTREMES,
         "normal": rng.normal(size=4096),
         "tiny": rng.normal(size=4096) * 1e-36,
         "huge": rng.normal(size=4096) * 1e37,
         "subnormal": rng.uniform(-1, 1, size=4096) * 1e-39}[values].astype(np.float32)
    t = torch.from_numpy(v)
    big, small = K1.tf32_big(t), K1.tf32_small(t)
    assert torch.equal((big + small).view(torch.int32), t.view(torch.int32))
    assert not bool((big.view(torch.int32) & 0x1FFF).any())
    assert torch.equal(small.abs(), t.abs() - big.abs())
    normal = t.abs() >= 2.0 ** -126
    assert bool((small.abs()[normal] <= t.abs()[normal] * 2.0 ** -10).all())
    assert bool((torch.signbit(small) == torch.signbit(t)).all())
    assert torch.equal(big.view(torch.int32), t.view(torch.int32) & -8192)


def test_one_pass_product_reads_the_big_terms():
    """tf32_product's plain version (what the card's check holds the kernel
    to) is the product of the big terms, whatever the low bits hold."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(5, D)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32))
    got = K1.tf32_product(a, b)
    assert torch.equal(got, K1.tf32_product(K1.tf32_big(a), K1.tf32_big(b)))
    assert torch.equal(got, K1.tf32_big(a) @ K1.tf32_big(b).T)


def test_small_plane_is_made_once_per_weight_version():
    w = torch.nn.Linear(D, D).weight
    before = K1.small_plane.casts
    plane = K1.small_plane(w)
    assert K1.small_plane(w) is plane and K1.small_plane.casts == before + 1
    assert torch.equal(plane, K1.tf32_small(w.detach()))
    with torch.no_grad():
        w.mul_(0.5)
    fresh = K1.small_plane(w)
    assert fresh is not plane and K1.small_plane.casts == before + 2
    assert torch.equal(fresh, K1.tf32_small(w.detach()))


def test_small_and_bf16_planes_are_cached_apart():
    w = torch.nn.Linear(D, D).weight
    casts, smalls = K1.weight_plane.casts, K1.small_plane.casts
    for _ in range(2):
        assert K1.weight_plane(w).dtype == torch.bfloat16
        assert K1.small_plane(w).dtype == torch.float32
    assert (K1.weight_plane.casts, K1.small_plane.casts) == (casts + 1, smalls + 1)


# the f32 forward's plan: the checked batches (chip_smoke.py's K1_BATCHES and
# eval's), and every batch to 1,100 at hidden 128
CHECKED = (1, 37, 50, 64, 65, 128, 256, 301, 512, 768, 1830, 4096)


def _plans(hidden):
    batches = CHECKED if hidden in (1024, 1536) else range(1, 1100)
    return [(b, K1.f32_plan(b, hidden, H100_SMS)) for b in batches]


@pytest.mark.parametrize("hidden", [D, 1024, 1536])
def test_f32_plan_covers_every_output_once(hidden):
    """Each output element lies in exactly one block's tile: row tiles of
    p.rows cover the batch with the last one ragged, column tiles split the
    width exactly, and the grid is their product."""
    for batch, p in _plans(hidden):
        seen = np.zeros((p.row_tiles * p.rows, hidden), np.int32)
        for tm in range(p.row_tiles):
            for tn in range(p.col_tiles):
                seen[tm * p.rows:(tm + 1) * p.rows, tn * p.cols:(tn + 1) * p.cols] += 1
        assert (seen == 1).all() and p.grid == p.row_tiles * p.col_tiles, batch
        assert (p.row_tiles - 1) * p.rows < batch <= p.row_tiles * p.rows, batch


@pytest.mark.parametrize("batch", [1, 37, 50, 256])
def test_f32_plan_fills_the_card(batch):
    """At least 128 blocks per product on an H100 at hidden 1024."""
    assert K1.f32_plan(batch, 1024, H100_SMS).grid >= 128


@pytest.mark.parametrize("hidden", [D, 1024, 1536])
def test_f32_plan_gives_wgmma_shapes_that_fit_a_block(hidden):
    """A tile the kernel is built for, its K split over warpgroups unless
    two blocks share an SM with too few stages for it, and A's small tiles
    made in shared memory at one row tile of split K; m64 rows per consumer warpgroup, n a
    multiple of 8 that wgmma takes;
    A's box rows a multiple of 8 covering the tile's rows below the batch;
    a stage of 1-8 K tiles, within F32_CHUNK_BYTES where more than one; the
    ring 2 stages deep per warpgroup that splits K (or holding all of K),
    holding the epilogue's staged sums, within a block's shared memory (half an SM's where two
    blocks share one)."""
    for batch, p in _plans(hidden):
        assert (p.wg, p.kw, p.cols, p.a_split) in K1.F32_KERNELS, batch
        assert p.rows == 64 * p.wg and p.a_split == (p.row_tiles == 1 and p.kw > 1), batch
        tile_kw = {(wg, cols): kw for wg, kw, cols in K1.F32_TILES}[p.wg, p.cols]
        assert p.kw in (tile_kw, 1) and (p.kw == tile_kw or p.grid > H100_SMS), batch
        assert p.cols % 8 == 0 and 8 <= p.cols <= 256 and hidden % p.cols == 0, batch
        assert p.a_rows % 8 == 0 and min(batch, p.rows) <= p.a_rows <= p.rows, batch
        assert p.a_rows == p.rows or p.row_tiles == 1, batch
        stages_in_all = -(-hidden // 32 // p.chunk)
        assert min(2 * p.kw, stages_in_all) <= p.stages <= K1.F32_MAX_STAGES, batch
        assert p.stages <= stages_in_all and p.chunk in (1, 2, 4, 8), batch
        assert p.chunk == 1 or p.chunk * 2 * (p.a_rows + p.cols) * 128 <= K1.F32_CHUNK_BYTES
        assert p.smem == K1.f32_smem_bytes(p.wg, p.cols, p.a_rows, p.chunk, p.stages), batch
        assert p.smem <= K1.SMEM_BYTES, batch
        if p.grid > H100_SMS and p.smem <= (K1.SMEM_BYTES + 1024) // 2 - 1024:
            assert p.stages >= min(3, stages_in_all), batch
        staged = p.kw * 4 * p.wg * 16 * (p.cols + 8) * 4
        assert staged <= p.stages * K1.f32_stage_bytes(p.a_rows, p.cols, p.chunk), batch


@pytest.mark.parametrize("hidden", [D, 1024, 1536])
def test_f32_plan_takes_the_widest_tile_that_fills_the_card(hidden):
    """The first tile of F32_TILES whose grid leaves at most 1/8 of the SMs
    idle: every wider tile leaves more idle."""
    for batch, p in _plans(hidden):
        tiles = [(wg, cols) for wg, _, cols in K1.F32_TILES]
        for wg, cols in tiles[:tiles.index((p.wg, p.cols))]:
            grid = -(-batch // (64 * wg)) * (hidden // cols) if hidden % cols == 0 else 0
            assert grid < H100_SMS - H100_SMS // 8, (batch, wg, cols)


def test_f32_kernels_are_the_instantiations_and_the_plans_reach_each():
    """F32_KERNELS is the list csrc/resblock.cu instantiates, and f32_plan
    gives each of them for some width and batch (none is dead code)."""
    src = (Path(K1.__file__).parent / "csrc" / "resblock.cu").read_text()
    built = {(int(wg), int(kw), int(cols), flag == "true") for wg, kw, cols, flag in
             re.findall(r"^\s*K1_TF32_TILE\((\d+), (\d+), (\d+), (true|false)\)", src, re.M)}
    assert built == K1.F32_KERNELS
    reached = {(p.wg, p.kw, p.cols, p.a_split) for h in (64, 128, 192, 256, 1024, 1856, 3712)
               for b in (1, 65, 257, 705, 1803, 3653, 4245, 7316, 7390)
               for p in [K1.f32_plan(b, h, H100_SMS)]}
    assert reached == K1.F32_KERNELS


def test_f32_plan_refuses_widths_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="hidden width 100"):
        K1.f32_plan(8, 100, H100_SMS)
    with pytest.raises(ValueError, match="batch 0"):
        K1.f32_plan(0, 1024, H100_SMS)
