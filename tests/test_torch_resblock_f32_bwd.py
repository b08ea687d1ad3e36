"""The f32 backward of the residual-block kernel (K1) on the CPU: its numerics
(three bf16 terms per operand, the six term products i + j < 3 summed per
64-deep K tile: ``ops/resblock.py:res_block_backward_terms``, the plain
emulation of what the kernel sums) against jax.grad of links_tpu's f32
res_block_apply and the Pallas backward in interpret mode, the three-term
split it rests on, the controls its check must reject, its tile plan as a
pure function and its weight planes' cache. The kernel itself runs on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu.core import nn as jnn
from links_tpu.experimental import fused_res_block
from links_tpu.models.lifters import init_res_block, res_block_apply
from links_tpu_torch.core.nn import F32
from links_tpu_torch.ops import resblock as K1

D = 128  # small width; the numerics and the plan are width-generic
H100_SMS = 132
# Three bf16 terms per operand hold each product to f32's 24 significant
# bits, so every gradient is within K1_F32_TOL of its largest value
# (chip_smoke.py's bound); one bf16 term per operand, or one TF32 pass, is
# off by ~1e-4 to 1e-3 on every gradient that goes through a product.
K1_F32_TOL = 1e-5
GRADS = ("dx", "dW1", "db1", "dW2", "db2")
# db2 is the plain sum of g2 = dy * lrelu'(a2), through no product: every
# route computes it alike, and no control can move it
THROUGH_A_PRODUCT = ("dx", "dW1", "db1", "dW2")


def _block(batch, seed):
    """Seeded numpy inputs: the JAX block's params, x and the upstream
    gradient dy."""
    p = jax.tree.map(np.asarray, init_res_block(jax.random.PRNGKey(seed), D))
    rng = np.random.default_rng(seed)
    x, dy = (rng.normal(size=(batch, D)).astype(np.float32) for _ in "xy")
    return p, x, dy


def _saved(p, x, dy):
    """dy and what the f32 forward saves (x, a1, h, a2) with W1, W2, as the
    port's tensors: -> (dy, x, W1, W2, a1, h, a2)."""
    x_t, w1, b1, w2, b2 = (torch.tensor(np.ascontiguousarray(a)) for a in
                           (x, p["l1"]["w"].T, p["l1"]["b"], p["l2"]["w"].T, p["l2"]["b"]))
    _, a1, h, a2 = K1.res_block_forward_reference(x_t, w1, b1, w2, b2, F32)
    return torch.tensor(dy), x_t, w1, w2, a1, h, a2


def _from_jax(gx, g):
    """JAX's (dx, params' gradients) -> the port's (dx, dW1, db1, dW2, db2)
    ((out, in) weights)."""
    return [np.asarray(t) for t in (gx, g["l1"]["w"].T, g["l1"]["b"], g["l2"]["w"].T,
                                    g["l2"]["b"])]


def _jax_grads(p, x, dy):
    """The gradients of JAX's f32 res_block_apply for the upstream dy."""
    _, vjp = jax.vjp(lambda xx, pp: res_block_apply(pp, xx, jnn.F32), jnp.asarray(x), p)
    gx, g = vjp(jnp.asarray(dy))
    return _from_jax(gx, g)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plans_of(batch):
    return K1.f32_bwd_plans(batch, D, H100_SMS)


@pytest.mark.parametrize("batch", [1, 37, 70, 192])
def test_three_terms_match_jax_grad(batch):
    """All five gradients within K1_F32_TOL of jax.grad of JAX's f32 block,
    at the plan's K splits; one bf16 term per operand and one TF32 pass (the
    controls) beyond it on every gradient that goes through a product."""
    p, x, dy = _block(batch, batch)
    want = _jax_grads(p, x, dy)
    args = _saved(p, x, dy)
    got = K1.res_block_backward_terms(*args, plans=_plans_of(batch))
    controls = {m: K1.res_block_backward_terms(*args, method=m) for m in ("bf16", "tf32")}
    for k, (name, g, w) in enumerate(zip(GRADS, got, want)):
        assert _rel_err(g.numpy(), w) <= K1_F32_TOL, name
        if name in THROUGH_A_PRODUCT:
            for method, c in controls.items():
                assert _rel_err(c[k].numpy(), w) > K1_F32_TOL, (method, name)


@pytest.mark.parametrize("batch", [1, 70])
def test_three_terms_match_the_pallas_backward(batch):
    """The gradients against the Pallas kernel's backward in interpret mode
    (f32), as tests/test_torch_resblock.py runs it; the controls beyond the
    bound."""
    p, x, dy = _block(batch, 100 + batch)
    w1, b1, w2, b2 = p["l1"]["w"], p["l1"]["b"], p["l2"]["w"], p["l2"]["b"]
    _, vjp = jax.vjp(lambda *a: fused_res_block(*a, 64, True), jnp.asarray(x), w1, b1, w2, b2)
    gx, gw1, gb1, gw2, gb2 = vjp(jnp.asarray(dy))
    want = _from_jax(gx, {"l1": {"w": gw1, "b": gb1}, "l2": {"w": gw2, "b": gb2}})
    args = _saved(p, x, dy)
    got = K1.res_block_backward_terms(*args, plans=_plans_of(batch))
    one = K1.res_block_backward_terms(*args, method="bf16")
    for name, g, o, w in zip(GRADS, got, one, want):
        assert _rel_err(g.numpy(), w) <= K1_F32_TOL, name
        if name in THROUGH_A_PRODUCT:
            assert _rel_err(o.numpy(), w) > K1_F32_TOL, name


def test_three_terms_are_not_the_plain_f32_backward():
    """The emulation sums bf16 term products per K tile: it differs from the
    plain f32 backward (TF32 off) where a product is summed, within the
    bound; at every tile's K depth and split, too."""
    p, x, dy = _block(256, 7)
    args = _saved(p, x, dy)
    want = K1.res_block_backward_reference(*args, F32)
    plans = [None, _plans_of(256)] + [
        (K1.f32_bwd_plan(256, D, D, H100_SMS)._replace(tk=tk, split=split),) * 2
        for _, _, tk in K1.F32_BWD_TILES for split in K1.F32_BWD_SPLITS]
    for plan in plans:
        got = K1.res_block_backward_terms(*args, plans=plan)
        for name, g, w in zip(GRADS, got, want):
            assert _rel_err(g.numpy(), w.numpy()) <= K1_F32_TOL, (plan, name)
            assert torch.equal(g, w) == (name == "db2"), (plan, name)


_SMALLEST = 2.0 ** -110  # below it, t2 can be a bf16 subnormal that rounds
_LARGEST = 3.3895313892515355e38  # bf16's largest finite value: above it t0 overflows


def _exact(v: np.ndarray) -> bool:
    t = K1.split_reference(torch.from_numpy(v), 3)
    total = sum(x.double() for x in t)
    return bool(torch.equal(total, torch.from_numpy(v).double()))


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.floats(min_value=_SMALLEST, max_value=_LARGEST, width=32), min_size=1,
                max_size=64), st.lists(st.booleans(), min_size=64, max_size=64))
def test_three_terms_are_an_exact_split(values, negative):
    """t0 + t1 + t2 == v exactly, for f32 values of every magnitude from
    2^-110 to bf16's largest, either sign; each term a bf16 value."""
    v = np.array([-a if s else a for a, s in zip(values, negative)], dtype=np.float32)
    assert _exact(v)
    for t in K1.split_reference(torch.from_numpy(v), 3):
        assert t.dtype == torch.bfloat16


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 3e38])
def test_three_terms_split_random_values_exactly(scale):
    rng = np.random.default_rng(0)
    with np.errstate(over="ignore"):  # the largest scale's tail overflows f32: dropped
        v = (rng.normal(size=4096) * scale).astype(np.float32)
    v = v[np.isfinite(v) & (np.abs(v) <= _LARGEST) & (np.abs(v) >= _SMALLEST)]
    assert _exact(v)


def test_the_subnormal_edge_of_the_split():
    """Below 2^-110 the third term can be a bf16 subnormal that rounds: then
    the split loses f32's last bits (here of an f32 normal value with all
    its mantissa bits set, and of an f32 subnormal). Zero splits into zeros."""
    for v in (np.float32(2.0 ** -120) * np.float32(2 - 2.0 ** -23), np.float32(1e-45)):
        assert not _exact(np.array([v], dtype=np.float32))
    assert _exact(np.array([0.0, -0.0, 2.0 ** -133, 2.0 ** -110], dtype=np.float32))


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_split_planes_on_the_cpu_are_the_plain_split(terms):
    """The first terms of the three-term split are the bf16 policy's hi and
    lo planes; all three sum to g2 = dy * lrelu'(a2) exactly."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=(37, D)).astype(np.float32))
    m = torch.from_numpy(rng.normal(size=(37, D)).astype(np.float32))
    for mask in (None, m):
        got = K1.split_planes(v, terms, mask)
        assert got.shape == (terms, 37, D) and got.dtype == torch.bfloat16
        assert all(torch.equal(a, b) for a, b in zip(got, K1.split_reference(v, terms, mask)))
        assert torch.equal(got, K1.split_planes(v, 3, mask)[:terms])
    g2 = v * torch.where(m >= 0, 1.0, 0.01)
    assert _exact(g2.numpy()) and torch.equal(
        sum(t.double() for t in K1.split_planes(v, 3, m)), g2.double())


def test_term_planes_are_made_once_per_weight_version():
    w = torch.nn.Linear(D, D).weight
    before = K1.term_planes.casts
    planes = K1.term_planes(w)
    assert K1.term_planes(w) is planes and K1.term_planes.casts == before + 1
    assert torch.equal(planes, torch.stack(K1.split_reference(w.detach(), 3)))
    with torch.no_grad():
        w.mul_(0.5)
    fresh = K1.term_planes(w)
    assert fresh is not planes and K1.term_planes.casts == before + 2
    assert torch.equal(fresh, torch.stack(K1.split_reference(w.detach(), 3)))


def test_term_planes_are_cached_apart_from_the_bf16_and_small_planes():
    w = torch.nn.Linear(D, D).weight
    counts = (K1.weight_plane.casts, K1.small_plane.casts, K1.term_planes.casts)
    for _ in range(2):
        assert K1.weight_plane(w).dtype == torch.bfloat16
        assert K1.small_plane(w).dtype == torch.float32
        assert K1.term_planes(w).shape == (3, D, D)
    assert (K1.weight_plane.casts, K1.small_plane.casts, K1.term_planes.casts) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)


# the plan at the checked batches (chip_smoke.py's K1_BATCHES and the trunk's
# and eval's), and at every batch to 1,100 at hidden 128
CHECKED = (1, 37, 50, 64, 65, 128, 129, 256, 300, 512, 768, 1830, 4096)


def _plans(hidden):
    batches = CHECKED if hidden in (1024, 1536) else range(1, 1100)
    for b in batches:
        act, wgt = K1.f32_bwd_plans(b, hidden, H100_SMS)
        yield b, (b, hidden, hidden), act
        yield b, (hidden, hidden, b), wgt


@pytest.mark.parametrize("hidden", [D, 1024, 1536])
def test_f32_bwd_plan_covers_every_output_once(hidden):
    """Each output element lies in one tile, and each of its K tiles in the
    share of exactly one block of the tile's cluster: row tiles cover M with
    the last one ragged, column tiles split N exactly, the split's shares
    partition K; the grid is their product."""
    for batch, (m, n, k), p in _plans(hidden):
        seen = np.zeros((p.row_tiles * p.rows, n), np.int32)
        for tm in range(p.row_tiles):
            for tn in range(p.col_tiles):
                seen[tm * p.rows:(tm + 1) * p.rows, tn * p.cols:(tn + 1) * p.cols] += 1
        assert (seen == 1).all() and p.grid == p.row_tiles * p.col_tiles * p.split, batch
        assert (p.row_tiles - 1) * p.rows < m <= p.row_tiles * p.rows, batch
        nk = -(-k // p.tk)
        shares = [range(s * nk // p.split, (s + 1) * nk // p.split) for s in range(p.split)]
        assert sorted(t for share in shares for t in share) == list(range(nk)), batch
        assert all(len(share) >= (1 if p.split == 1 else K1.F32_BWD_MIN_TILES)
                   for share in shares), batch


@pytest.mark.parametrize("hidden", [D, 1024, 1536])
def test_f32_bwd_plan_fits_a_block(hidden):
    """A tile the kernel is built for, a cluster of at most 8 blocks; the
    ring deep enough to park the epilogue's sums, else no deeper than a
    block's K tiles or F32_BWD_MAX_STAGES, 2 deep where a block has 2 K
    tiles, within a block's 232,448 bytes of shared memory (half an SM's
    where two 64-row blocks share one)."""
    for batch, (m, n, k), p in _plans(hidden):
        assert (p.wg, p.cols, p.tk) in K1.F32_BWD_TILES and p.rows == 64 * p.wg, batch
        assert p.split in K1.F32_BWD_SPLITS, batch
        local = -(-(-(-k // p.tk)) // p.split)
        stage = K1.f32_bwd_stage_bytes(p.wg, p.cols, p.tk)
        least = -(-K1.f32_bwd_parked_bytes(p.wg, p.cols) // stage)
        assert max(least, min(2, local)) <= p.stages, batch
        assert p.stages <= max(least, min(local, K1.F32_BWD_MAX_STAGES)), batch
        assert K1.f32_bwd_parked_bytes(p.wg, p.cols) <= p.stages * stage, batch
        assert p.smem == K1.f32_bwd_smem_bytes(p.wg, p.cols, p.tk, p.stages), batch
        assert p.smem <= K1.SMEM_BYTES, batch


def test_f32_bwd_plan_fills_the_card_from_1_to_4096():
    """At hidden 1024 on an H100, from B = 1 to 4096: dW1 and dW2 leave at
    most 1/3 of the SMs without a block (1/8 unsplit), and so do dh and dx
    from B = 129, split in at most one wave of clusters; below, dh and dx
    have 16 output tiles per 64 rows, each split over 2 blocks, the most the
    plan splits."""
    third, eighth = H100_SMS - H100_SMS // 3, H100_SMS - H100_SMS // 8
    for batch in range(1, 4097):
        for k, p in enumerate(K1.f32_bwd_plans(batch, 1024, H100_SMS)):
            if k == 0 and batch <= 128:
                assert (p.cols, p.split, p.grid) == (64, 2, 2 * p.row_tiles * 16), (batch, p)
            elif p.split == 1:
                assert p.grid >= eighth, (batch, p)
            else:  # one wave: two 64-row blocks per SM where each has half its memory
                pair = p.wg == 1 and p.smem <= (K1.SMEM_BYTES + 1024) // 2 - 1024
                assert third <= p.grid <= H100_SMS * (2 if pair else 1), (batch, p)


def test_f32_bwd_plan_prefers_the_wider_tile():
    """The 128 x 128 tile (half the bytes per product of 64 x 64) wherever it
    fills the card: stage 4's completers (768) and the large batches; the 64
    x 64 one for the lifters' step (512)."""
    for batch in (768, 1024, 2048, 4096):
        assert all(p.cols == 128 for p in K1.f32_bwd_plans(batch, 1024, H100_SMS)), batch
    act, wgt = K1.f32_bwd_plans(512, 1024, H100_SMS)
    assert (act.cols, act.split, act.grid, wgt.cols, wgt.split) == (64, 1, 128, 128, 2)
    act, wgt = K1.f32_bwd_plans(4096, 1024, H100_SMS)
    assert (act.split, act.grid, wgt.split, wgt.grid) == (1, 256, 2, 128)


def test_f32_bwd_tiles_are_the_kernels_instantiations():
    """F32_BWD_TILES is what csrc/resblock.cu:run_terms3 launches, and the
    plans reach each of them."""
    src = (Path(K1.__file__).parent / "csrc" / "resblock.cu").read_text()
    built = {tuple(map(int, t)) for t in
             re.findall(r"^\s*K1_TERMS3_TILE\((\d+), (\d+), (\d+)\)", src, re.M)}
    assert built == set(K1.F32_BWD_TILES)
    reached = {(p.wg, p.cols, p.tk) for b in (1, 256, 4096)
               for p in K1.f32_bwd_plans(b, 1024, H100_SMS)}
    assert reached == set(K1.F32_BWD_TILES)


def test_f32_bwd_plan_refuses_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="100 product"):
        K1.f32_bwd_plan(8, 100, 100, H100_SMS)
    with pytest.raises(ValueError, match="0 x 1024"):
        K1.f32_bwd_plans(0, 1024, H100_SMS)
    with pytest.raises(ValueError, match="product 0 deep"):
        K1.f32_bwd_plan(8, 1024, 0, H100_SMS)
