"""The CUDA kernels of links_tpu_torch on the card, each against its plain
PyTorch version. Every test here is marked ``cuda`` and skips without a CUDA
device. The file imports neither jax nor links_tpu, so it also runs on a
machine without jax, where tests/conftest.py (which imports jax) is skipped:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from links_tpu_torch.config import OcclusionTrainConfig
from links_tpu_torch.core.nn import BF16, F32
from links_tpu_torch.models.attention import AttentionLifter
from links_tpu_torch.models.completers import Completers
from links_tpu_torch.models.lifters import Lifter, StackedLifter
from links_tpu_torch.ops import fused_infer as K2
from links_tpu_torch.ops import quant as Q
from links_tpu_torch.ops import resblock as K1
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import TrainState, build_occlusion_step, draw_occlusion

# Kernel vs plain version: both sum bf16 x bf16 products in f32 in different
# orders, and a last-bit difference can flip the bf16 rounding of the next
# layer's input (the tolerance of chip_smoke.py).
TOL = {"rtol": 1e-3, "atol": 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stacked(hidden, g, device):
    return StackedLifter(Lifter(11, hidden, generator=g),
                         Lifter(11, hidden, generator=g)).to(device)


def _k2_batches(hidden, device):
    """1, 37, 256 and 512, and each batch where the kernel's tile plan
    changes shape with one batch on each side of it."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shape = [K2.plan(b, hidden, sms)[:2] for b in range(1, K2.MAX_BATCH + 1)]
    edges = [b for b in range(2, K2.MAX_BATCH + 1) if shape[b - 1] != shape[b - 2]]
    return sorted({1, 37, 256, 512} | {b + d for b in edges for d in (-1, 0, 1)})


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [128, 1024])
def test_fused_sides_kernel_matches_plain_version(cuda, hidden):
    g = torch.Generator().manual_seed(0)
    prep = K2.prepare_fused_weights(_stacked(hidden, g, cuda))
    for batch in _k2_batches(hidden, cuda):
        x = (torch.randn(2, batch, 22, generator=g) * 0.1).to(cuda)
        before = K2.fused_sides_forward.launches
        with torch.no_grad():
            got = K2.fused_sides_forward(prep, x[0], x[1])
            torch.cuda.synchronize()
            want = K2.fused_sides_forward_reference(prep, x[0], x[1])
        assert K2.fused_sides_forward.launches == before + 1
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_fused_sides_kernel_is_deterministic(cuda):
    """Every output tile is owned by one block, which sums its full K in a
    fixed order: no split-K, no atomics on values."""
    g = torch.Generator().manual_seed(1)
    prep = K2.prepare_fused_weights(_stacked(1024, g, cuda))
    for batch in (16, 200, 400):  # one batch per tile shape
        x = (torch.randn(2, batch, 22, generator=g) * 0.1).to(cuda)
        with torch.no_grad():
            first = K2.fused_sides_forward(prep, x[0], x[1])
            second = K2.fused_sides_forward(prep, x[0], x[1])
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_sides_call_is_one_kernel_and_leaves_its_counters_zero(cuda, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(9)
    prep = K2.prepare_fused_weights(_stacked(1024, g, cuda))
    x = (torch.randn(2, 256, 22, generator=g) * 0.1).to(cuda)
    K2.fused_sides_forward(prep, x[0], x[1])  # builds, allocates the counters
    torch.cuda.synchronize()
    made = []
    monkeypatch.setattr(K2.FusedWeights, "__init__", lambda *a: made.append(1))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            K2.fused_sides_forward(prep, x[0], x[1])
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.self_device_time_total > 0}
    assert len(kernels) == 1 and list(kernels.values()) == [3], kernels
    assert not made  # the prepared weights are not checked again
    assert prep._counters and all(not bool(c.any()) for c in prep._counters.values())


@pytest.mark.cuda
def test_fused_sides_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = torch.Generator().manual_seed(2)
    prep = K2.prepare_fused_weights(_stacked(128, g, cuda))
    x = torch.zeros(4, 22, device=cuda)
    with pytest.raises(ValueError, match="latency path"):
        K2.fused_sides_forward(prep, torch.zeros(513, 22, device=cuda),
                               torch.zeros(513, 22, device=cuda))
    with pytest.raises(ValueError, match="w_chain"):
        K2.fused_sides_forward({**prep, "w_chain": prep["w_chain"].float()}, x, x)
    with pytest.raises(ValueError, match="b_up"):
        K2.fused_sides_forward({**prep, "b_up": prep["b_up"].cpu()}, x, x)


# K1 against its plain version, with the tolerances of chip_smoke.py: bf16
# forward outputs elementwise (sums in another order, and a flipped rounding
# of h); f32 forward outputs within K1_F32_TOL of each one's largest value
# (three TF32 passes; one pass, the control, is off by ~1e-3); bf16-policy dx,
# dW1, dW2
# within one bf16 unit in the last place of the largest value (they are
# rounded to bf16 after the sum), with fewer than K1_FLIP_SHARE of their
# elements off by more than K1_FLIP_REL of their own value (rounding g1, g2
# to one bf16 term, as the Pallas kernel does, moves 25-54% of them); bf16
# db1 and db2 within 1e-3 of the largest value (sums over the batch of such
# flips). Every f32-policy gradient within K1_F32_TOL of its largest value
# (three bf16 terms per operand; one bf16 term, or one TF32 pass, the
# controls, are off by ~1e-4 to 3e-3 on every gradient that goes through a
# product), against f64 values: the plain f32 backward's own dW lies up to
# 1.4e-6 of the largest value from them at B = 768.
K1_TOL = {"rtol": 1e-3, "atol": 1e-3}
K1_F32_TOL = 1e-5
K1_BF16_ULP = 2.0 ** -7
K1_FLIP_REL, K1_FLIP_SHARE = 1e-5, 0.1


def _k1_grad_close(name, got, want, policy):
    err = (got - want).abs()
    if policy is F32:
        assert float(err.max()) <= K1_F32_TOL * float(want.abs().max()), name
    elif name in ("dx", "dw1", "dw2"):
        assert float(err.max()) <= K1_BF16_ULP * float(want.abs().max()), name
        assert float((err > K1_FLIP_REL * want.abs()).float().mean()) < K1_FLIP_SHARE, name
    else:
        assert float(err.max()) <= K1_TOL["rtol"] * float(want.abs().max()), name


def _f64_backward(dy, x, w1, w2, a1, h, a2):
    """The plain backward's gradients computed in f64, as f32."""
    return [t.float() for t in K1.res_block_backward_reference(
        *(t.double() for t in (dy, x, w1, w2, a1, h, a2)), F32)]


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _k1_inputs(batch, hidden, g, device):
    bound = hidden ** -0.5
    w1, w2 = (torch.empty(hidden, hidden).uniform_(-bound, bound, generator=g) for _ in "12")
    b1, b2 = (torch.empty(hidden).uniform_(-bound, bound, generator=g) for _ in "12")
    x, dy = (torch.randn(batch, hidden, generator=g) for _ in "xy")
    return [t.to(device) for t in (x, w1, b1, w2, b2, dy)]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [BF16, F32], ids=["bf16", "f32"])
def test_res_block_kernels_match_plain_version(cuda, policy):
    g = torch.Generator().manual_seed(3)
    for batch in (1, 37, 512):
        x, w1, b1, w2, b2, dy = _k1_inputs(batch, 1024, g, cuda)
        before = (K1.res_block_forward.launches, K1.res_block_backward.launches)
        y, a1, h, a2, x_saved = K1.res_block_forward(x, w1, b1, w2, b2, policy)
        want = K1.res_block_forward_reference(x, w1, b1, w2, b2, policy)
        saved = K1.kernel_saved(x, *want[1:], policy)
        if policy is F32:
            for a, b in zip((y, a1, h, a2), want):
                assert _rel_err(a, b) <= K1_F32_TOL
        else:
            for a, b in zip((y, a1, a2), (want[0], want[1], want[3])):
                torch.testing.assert_close(a, b, **K1_TOL)
            _k1_grad_close("dx", h.float(), saved[2].float(), policy)  # h's plane: rounded
        assert torch.equal(x_saved, saved[0])
        got = K1.res_block_backward(dy, saved[0], w1, w2, *saved[1:], policy)
        ref = (_f64_backward(dy, x, w1, w2, *want[1:]) if policy is F32 else
               K1.res_block_backward_reference(dy, x, w1, w2, *want[1:], policy))
        torch.cuda.synchronize()
        assert (K1.res_block_forward.launches, K1.res_block_backward.launches) == (
            before[0] + 1, before[1] + 1)
        for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, ref):
            _k1_grad_close(name, a, b, policy)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,launches", [(BF16, (3, 6)), (F32, (3, 6))], ids=["bf16", "f32"])
def test_res_block_kernel_launches_per_call(cuda, policy, launches):
    """3 forward launches, less one where the f32 plan makes A's small tiles
    in shared memory (one row tile: B = 64 here); 6 backward launches."""
    g = torch.Generator().manual_seed(7)
    x, w1, b1, w2, b2, dy = _k1_inputs(64, 256, g, cuda)
    if policy is F32:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        launches = (launches[0] - K1.f32_plan(64, 256, sms).a_split, launches[1])
    before = (K1.res_block_forward.kernel_launches, K1.res_block_backward.kernel_launches)
    y, a1, h, a2, x_saved = K1.res_block_forward(x, w1, b1, w2, b2, policy)
    K1.res_block_backward(dy, x_saved, w1, w2, a1, h, a2, policy)
    assert (K1.res_block_forward.kernel_launches - before[0],
            K1.res_block_backward.kernel_launches - before[1]) == launches


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(256, 1024), (16384, 1024), (49152, 1024),
                                          (49153, 1024), (65536, 1024), (768, 2048)])
def test_bf16_kernels_hold_the_plain_version_on_their_plan(cuda, batch, hidden):
    """The bf16 forward and backward against the plain version by the card's
    rules (the backward's rounded products within one bf16 unit, under 10%
    of elements moved), two runs bitwise equal, and every product on the
    plan's kernel: the persistent one at the training cells' rows (49,153:
    a ragged last row tile; dW's K split) and at hidden 2048, B = 768 (the
    batch-wide products' K split, db1's sums through the last slice),
    today's tile at 256."""
    g = torch.Generator().manual_seed(batch)
    x, w1, b1, w2, b2, dy = _k1_inputs(batch, hidden, g, cuda)
    before = dict(K1.bf16_products)
    fwd = K1.res_block_forward(x, w1, b1, w2, b2, BF16)
    fwd2 = K1.res_block_forward(x, w1, b1, w2, b2, BF16)
    want = K1.res_block_forward_reference(x, w1, b1, w2, b2, BF16)
    saved = K1.kernel_saved(x, *want[1:], BF16)
    for a, b in zip((fwd[0], fwd[1], fwd[3]), (want[0], want[1], want[3])):
        torch.testing.assert_close(a, b, **K1_TOL)
    _k1_grad_close("dx", fwd[2].float(), saved[2].float(), BF16)  # h's plane: rounded
    assert torch.equal(fwd[4], saved[0])
    got = K1.res_block_backward(dy, saved[0], w1, w2, *saved[1:], BF16)
    again = K1.res_block_backward(dy, saved[0], w1, w2, *saved[1:], BF16)
    ref = K1.res_block_backward_reference(dy, x, w1, w2, *want[1:], BF16)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, ref):
        _k1_grad_close(name, a, b, BF16)
    assert all(torch.equal(a, b) for a, b in zip(fwd, fwd2))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    kind = "tile" if batch == 256 else "persistent"
    assert {k: v - before[k] for k, v in K1.bf16_products.items()} == {
        "persistent": 0, "tile": 0, kind: 12}


@pytest.mark.cuda
def test_bf16_smem_bytes_match_the_kernels(cuda):
    """ops/resblock.py:bf16_smem_bytes is what csrc/resblock.cu reserves on
    every tile it builds."""
    for persistent, rows, cols in K1.BF16_KERNELS:
        for terms in (1, 2):
            for staged in (True, False):
                assert K1._lib().res_block_bf16_smem_bytes(persistent, rows, cols, terms,
                                                            staged) == K1.bf16_smem_bytes(
                    persistent, rows, cols, terms, staged)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 37, 512, 4096])
def test_split_kernel_matches_plain_split(cuda, batch):
    """Bitwise: both round to nearest even."""
    g = torch.Generator().manual_seed(batch)
    dy, a2 = (torch.randn(batch, 1024, generator=g).to(cuda) for _ in "da")
    for args in ((dy, 1), (dy, 2, a2)):
        before = K1.split_planes.launches
        got = K1.split_planes(*args)
        want = K1.split_reference(*(t.cpu() if torch.is_tensor(t) else t for t in args))
        assert K1.split_planes.launches == before + 1
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 50, 128, 256, 512, 768, 1830, 4096])
def test_f32_forward_holds_the_f32_bound(cuda, batch):
    """Every tile of the f32 plan (batches 1 and 50: 64 x 8, K over 4
    warpgroups; 128: 64 x 16; 256: 64 x 32; 512 and 768: 64 x 64; 1830 and
    4096: 128 x 128): y, a1, h, a2 within K1_F32_TOL of the largest value,
    the one-TF32-pass control beyond it, bitwise repeatable."""
    g = torch.Generator().manual_seed(batch)
    x, w1, b1, w2, b2, _ = _k1_inputs(batch, 1024, g, cuda)
    got = K1.res_block_forward(x, w1, b1, w2, b2, F32)
    again = K1.res_block_forward(x, w1, b1, w2, b2, F32)
    want = K1.res_block_forward_reference(x, w1, b1, w2, b2, F32)
    one = K1.res_block_forward_tf32(x, w1, b1, w2, b2, passes=1)
    for name, a, b, c in zip(("y", "a1", "h", "a2"), got, want, one):
        assert _rel_err(a, b) <= K1_F32_TOL, name
        assert _rel_err(c, b) > K1_F32_TOL, name
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 37, 512, 768])
def test_f32_backward_holds_the_f32_bound(cuda, batch):
    """Every tile of the f32 backward's plan (dh and dx: 64 x 64 split over 2
    blocks at B = 1 and 37, unsplit at 512, 128 x 128 split at 768; dW: 64 x
    64 below B = 97, 128 x 128 split above): dx, dW1, db1, dW2, db2 within
    K1_F32_TOL of f64 values, both controls beyond it on the gradients that
    go through a product, bitwise repeatable, all on the f32 route."""
    g = torch.Generator().manual_seed(20 + batch)
    x, w1, b1, w2, b2, dy = _k1_inputs(batch, 1024, g, cuda)
    _, a1, h, a2 = K1.res_block_forward_reference(x, w1, b1, w2, b2, F32)
    before = K1.res_block_backward.f32_launches
    got = K1.res_block_backward(dy, x, w1, w2, a1, h, a2, F32)
    again = K1.res_block_backward(dy, x, w1, w2, a1, h, a2, F32)
    assert K1.res_block_backward.f32_launches == before + 2
    want = _f64_backward(dy, x, w1, w2, a1, h, a2)
    controls = [K1.res_block_backward_terms(dy, x, w1, w2, a1, h, a2, m) for m in ("bf16", "tf32")]
    for k, name in enumerate(("dx", "dw1", "db1", "dw2", "db2")):
        _k1_grad_close(name, got[k], want[k], F32)
        if name != "db2":
            assert all(_rel_err(c[k], want[k]) > K1_F32_TOL for c in controls), name
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 37, 512, 4096])
def test_three_term_split_kernel_matches_plain_split(cuda, batch):
    """Bitwise, with and without the lrelu' mask: both round to nearest even;
    a weight's term planes are made once per version."""
    g = torch.Generator().manual_seed(30 + batch)
    v, m = (torch.randn(batch, 1024, generator=g).to(cuda) for _ in "vm")
    for mask in (None, m):
        before = K1.split_planes.launches
        got = K1.split_planes(v, 3, mask)
        assert K1.split_planes.launches == before + 1
        want = K1.split_reference(v.cpu(), 3, None if mask is None else mask.cpu())
        assert torch.equal(got.cpu(), torch.stack(want))
    w = torch.randn(1024, 1024, generator=g).to(cuda).requires_grad_(True)
    before = K1.term_planes.casts
    planes = K1.term_planes(w)
    assert K1.term_planes(w) is planes and K1.term_planes.casts == before + 1
    with torch.no_grad():
        w.add_(1.0)
    fresh = K1.term_planes(w)
    assert fresh is not planes and torch.equal(
        fresh.cpu(), torch.stack(K1.split_reference(w.detach().cpu(), 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 37, 256])
def test_tf32_pass_reads_raw_f32_as_its_big_term(cuda, batch):
    """What the f32 forward rests on: one wgmma pass on raw f32 operands is
    bitwise the pass on their tf32_big values."""
    g = torch.Generator().manual_seed(batch)
    x, w1 = _k1_inputs(batch, 1024, g, cuda)[:2]
    for scale in (1.0, 3e-20, 7e15):
        raw = K1.tf32_product(x * scale, w1)
        assert torch.equal(raw, K1.tf32_product(K1.tf32_big(x * scale), K1.tf32_big(w1)))


@pytest.mark.cuda
def test_small_planes_on_the_card(cuda):
    """The small-plane kernel is bitwise tf32_small; a weight's small plane
    is made once per version."""
    g = torch.Generator().manual_seed(9)
    x, w = _k1_inputs(37, 1024, g, cuda)[:2]
    assert torch.equal(K1._small(x).cpu(), K1.tf32_small(x.cpu()))
    w.requires_grad_(True)
    before = K1.small_plane.casts
    plane = K1.small_plane(w)
    assert K1.small_plane(w) is plane and K1.small_plane.casts == before + 1
    with torch.no_grad():
        w.add_(1.0)
    fresh = K1.small_plane(w)
    assert fresh is not plane and torch.equal(fresh.cpu(), K1.tf32_small(w.detach().cpu()))


@pytest.mark.cuda
def test_weight_plane_cache_on_the_card(cuda):
    g = torch.Generator().manual_seed(8)
    block = Lifter(11, 128, generator=g).to(cuda).res_common
    w = block.l1.weight
    before = K1.weight_plane.casts
    x = torch.randn(16, 128, generator=g).to(cuda)
    for _ in range(2):
        block(x, BF16)
    assert K1.weight_plane.casts == before + 2  # W1 and W2, once
    plane = K1.weight_plane(w)
    with torch.no_grad():
        w.add_(1.0)
    fresh = K1.weight_plane(w)
    assert fresh is not plane and torch.equal(fresh, w.detach().to(torch.bfloat16))


@pytest.mark.cuda
def test_res_block_autograd_runs_the_kernels(cuda):
    g = torch.Generator().manual_seed(4)
    x, w1, b1, w2, b2, dy = _k1_inputs(64, 256, g, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    before = K1.res_block_backward.launches
    K1.res_block(*leaves, BF16).backward(dy)
    assert K1.res_block_backward.launches == before + 1
    plain = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    K1.res_block_reference(*plain, BF16).backward(dy)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), leaves, plain):
        _k1_grad_close(name, a.grad, b.grad, BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [BF16, F32], ids=["bf16", "f32"])
def test_res_block_kernels_are_deterministic(cuda, policy):
    """Each output tile is summed by one block, or by the 2 blocks of a
    cluster that add their sums in rank order, in a fixed order: no atomics
    (the f32 backward's plan splits every product at B = 300 and 768, and
    only dW at 2048)."""
    g = torch.Generator().manual_seed(5)
    for batch in (300, 768, 2048):
        x, w1, b1, w2, b2, dy = _k1_inputs(batch, 1024, g, cuda)
        first = K1.res_block_forward(x, w1, b1, w2, b2, policy)
        second = K1.res_block_forward(x, w1, b1, w2, b2, policy)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        y, a1, h, a2, x_saved = first
        grads = [K1.res_block_backward(dy, x_saved, w1, w2, a1, h, a2, policy)
                 for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
def test_res_block_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    g = torch.Generator().manual_seed(6)
    x, w1, b1, w2, b2, _ = _k1_inputs(8, 128, g, cuda)
    with pytest.raises(ValueError, match="w1"):
        K1.res_block_forward(x, w1.double(), b1, w2, b2, BF16)
    with pytest.raises(ValueError, match="b2"):
        K1.res_block_forward(x, w1, b1, w2, b2.cpu(), BF16)
    with pytest.raises(ValueError, match="not contiguous"):
        K1.res_block_forward(x, w1.T, b1, w2, b2, BF16)
    with pytest.raises(ValueError, match="w2"):
        K1.res_block_forward(x, w1, b1, w2[:64], b2, BF16)
    with pytest.raises(ValueError, match="multiple of 64"):
        K1.res_block_forward(x[:, :100].contiguous(), w1[:100, :100].contiguous(), b1[:100],
                             w2[:100, :100].contiguous(), b2[:100], BF16)


@pytest.mark.cuda
def test_occlusion_step_casts_the_frozen_lifters_once(cuda):
    """A stage-4 step runs 38 forward and 24 backward K1 calls; the frozen
    lifters' 28 weight planes are cast on the first step only, the
    completers' 48 after every update."""
    g = torch.Generator().manual_seed(9)
    legs, torso = (Lifter(j, 128, generator=g).requires_grad_(False).to(cuda) for j in (7, 10))
    model = Completers(128, generator=g).to(cuda)
    cfg = OcclusionTrainConfig(batch_size=16)
    state = TrainState(model, Adam(model.parameters(), cfg.optim, steps_per_epoch=1))
    step = build_occlusion_step(legs, torso, cfg)
    data = (torch.randn(16, 34, generator=g) * 0.1).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)

    def counts():
        return (K1.weight_plane.casts, K1.res_block_forward.launches,
                K1.res_block_backward.launches)

    seen = []
    for _ in range(2):
        before = counts()
        aux = step(state, data, draw_occlusion(gen, 16, cuda))
        torch.cuda.synchronize()
        seen.append(tuple(a - b for a, b in zip(counts(), before)))
        assert torch.isfinite(aux["loss"])
    assert seen == [(76, 38, 24), (48, 38, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 22, 1024), (16, 1024, 1024), (37, 1024, 11),
                                   (512, 1024, 1), (3, 2, 64), (4096, 1024, 1024)])
def test_int8_product_on_the_card_is_exact(cuda, m, k, n):
    """torch._int_mm on the card with its operands padded: the exact integer
    product, as on the CPU."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    assert torch.equal(Q.int8_matmul(x.to(cuda), w.to(cuda)).cpu(), x.int() @ w.int().T)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [lambda g: Lifter(11, 1024, generator=g),
                                  lambda g: AttentionLifter(11, generator=g)],
                         ids=["mlp", "attention"])
def test_quantized_lifter_on_the_card_matches_the_cpu(cuda, make):
    """A quantized lifter on the card against the same on the CPU, with no
    residual-block kernel launched. The MLP lifter's int8 products are exact
    and the rest the same f32 elementwise ops: equal within 1e-5 (bitwise on
    an H100). The attention lifter's float einsums and softmax sum in
    another order on each device, so a token's activation can land on the
    other side of an int8 rounding tie and move its row by about one int8
    step (1.25e-4 in one row of 300 observed on an H100): rows within 1e-5,
    except at most 5% of them, within 1e-3 (8 such steps)."""
    g = torch.Generator().manual_seed(11)
    q = Q.quantize_params(make(g))
    x = torch.randn(300, 22, generator=g) * 0.1
    with torch.inference_mode():
        want = q(x)
        before = K1.res_block_forward.launches
        got = q.to(cuda)(x.to(cuda))
        torch.cuda.synchronize()
    assert K1.res_block_forward.launches == before
    for a, b in zip(got, want):
        a = a.cpu()
        flipped = ~torch.isclose(a, b, rtol=1e-5, atol=1e-5).all(dim=1)
        assert flipped.float().mean() <= (0.05 if isinstance(q, AttentionLifter) else 0.0)
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-3)


@pytest.mark.cuda
def test_attention_lifter_runs_its_blocks_on_the_kernel(cuda):
    """The attention lifter's 5 residual blocks run K1 forward on the card,
    and backward for the blocks a loss reads; its output agrees with the CPU
    within K2's bf16 tolerance."""
    g = torch.Generator().manual_seed(12)
    lifter = AttentionLifter(11, generator=g)
    x = torch.randn(64, 22, generator=g) * 0.1
    want = lifter(x, BF16)
    card = AttentionLifter(11).to(cuda)
    card.load_state_dict(lifter.state_dict())
    before = (K1.res_block_forward.launches, K1.res_block_backward.launches)
    depth, angle = card(x.to(cuda), BF16)
    depth.sum().backward()  # reads the pose blocks and the trunk, not the angle blocks
    torch.cuda.synchronize()
    assert (K1.res_block_forward.launches - before[0],
            K1.res_block_backward.launches - before[1]) == (5, 3)
    torch.testing.assert_close(depth.detach().cpu(), want[0].detach(), **TOL)
    torch.testing.assert_close(angle.detach().cpu(), want[1].detach(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [BF16, F32], ids=["bf16", "f32"])
def test_registered_op_is_the_kernel_call(cuda, policy):
    """links_tpu_torch::res_block_forward on CUDA tensors is K1's forward
    call: one call of the wrapper, its y bitwise."""
    g = torch.Generator().manual_seed(13)
    x = torch.randn(256, 1024, generator=g).to(cuda)
    w1, w2 = ((torch.randn(1024, 1024, generator=g) / 32).to(cuda) for _ in range(2))
    b1, b2 = ((torch.randn(1024, generator=g) * 0.1).to(cuda) for _ in range(2))
    before = K1.res_block_forward.launches
    with torch.no_grad():
        got = torch.ops.links_tpu_torch.res_block_forward(x, w1, b1, w2, b2, policy is BF16)
        assert K1.res_block_forward.launches == before + 1
        want = K1.res_block_forward(x, w1, b1, w2, b2, policy)[0]
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [[], ["--policy", "bf16"]], ids=["f32", "bf16"])
def test_artifact_exported_on_the_card_is_the_live_lift(cuda, tmp_path, flags):
    """export_model on the card, loaded on the card: bitwise the live lift,
    with its K1 forward calls (14 per chunk)."""
    import contextlib
    import io

    import numpy as np

    from links_tpu_torch import ckpt
    from links_tpu_torch.ckpt.torch_io import save_lifter_pt
    from links_tpu_torch.cli import export_model, lift

    g = torch.Generator().manual_seed(14)
    for side in ("left", "right"):
        save_lifter_pt(Lifter(11, generator=g), tmp_path / f"{side}_lifter.pt")
    poses = (torch.randn(300, 34, generator=g) * 0.1).numpy()
    np.save(tmp_path / "p.npy", poses)
    base = ["--model-dir", str(tmp_path), "--device", "cuda", *flags]
    with contextlib.redirect_stdout(io.StringIO()):
        summary = export_model.main(base + ["--out", str(tmp_path / "a.pt2")])
        want = lift.main(base + ["--raw-2d", str(tmp_path / "p.npy"), "--batch-size", "300",
                                 "--out", str(tmp_path / "o.npz")])
    assert summary["verified"] is True
    served = ckpt.load_exported(tmp_path / "a.pt2", cuda)
    before = K1.res_block_forward.launches
    got = served(torch.from_numpy(poses).to(cuda)).cpu().numpy()
    assert K1.res_block_forward.launches - before == 14
    np.testing.assert_array_equal(got.reshape(300, 3, 17), want)


@pytest.mark.cuda
def test_packed_feed_on_the_card(cuda, tmp_path):
    """The packed feed on the card (pinned chunks, copies overlapping the next
    gather): the batches of epoch_batches(shuffle_seed(generator)), in order,
    with the generator's next draws."""
    import numpy as np

    from links_tpu_torch.data.native_loader import PackedDataset, pack_dataset
    from links_tpu_torch.train.feed import PackedFeed, shuffle_seed
    from links_tpu_torch.train.loop import run_epoch

    data = torch.randn(1000, 34, generator=torch.Generator().manual_seed(15)).numpy()
    pack_dataset(tmp_path / "p.lnks", data)
    packed = PackedDataset(tmp_path / "p.lnks")
    gen = torch.Generator(device=cuda).manual_seed(16)
    twin = torch.Generator(device=cuda).set_state(gen.get_state())
    seen = []

    def step(state, batch, draws):
        seen.append(batch.clone())
        return {"loss": batch.sum()}

    run_epoch(step, None, PackedFeed(packed, cuda, chunk_steps=3), 64, gen)
    want = list(packed.epoch_batches(64, shuffle_seed(twin)))
    assert len(seen) == len(want) == 1000 // 64
    for got, w in zip(seen, want):
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(), w)
    packed.close()


@pytest.mark.cuda
def test_dstformer_windows_at_published_widths_hold_the_f32_reference(cuda):
    """MotionBERT's DSTformer at its published widths (dim 512, MLP 1024, 8
    heads of 64, depth 5, 243 frames, 17 joints) on three windows, the last a
    100-frame tail padded to 243 in the batch: each window against the plain
    f32 reference of its unpadded frames. Under F32 the card's sums differ
    from the reference's only in order; under BF16 each output stays within
    the benchmark's dst_gap limit (portbench/workloads/dst-lift-sat.json,
    0.07: sound bf16 runs read 0.010-0.026 of their largest value), and the
    fp8 control (0.21-0.44 there) lies beyond it."""
    import dstformer_reference as R
    import numpy as np

    from links_tpu_torch.models import dstformer

    R.full_f32()
    g = torch.Generator(cuda).manual_seed(21)
    p = R.init_params(g)
    model = dstformer.from_state_dict(p, cuda)
    lens = np.array([243, 243, 100])
    x = torch.randn(3, 243, 34, generator=g, device=cuda) * 0.1
    x[2, 100:] = 0.0
    want = [R.lift(p, x[w, :n]) for w, n in enumerate(lens)]
    for policy, tol in ((F32, 1e-4), (BF16, 0.07)):
        with torch.inference_mode():
            got = model.lift(x, lens, policy)
        for w, n in enumerate(lens):
            gap = float((got[w, :n] - want[w]).abs().max() / want[w].abs().max())
            assert gap < tol, (policy, w, gap)
    fp8 = R.lift(p, x[2, :100], prec=R.FP8)
    assert float((fp8 - want[2]).abs().max() / want[2].abs().max()) > 0.07


# The DSTformer's glue (ops/dst_glue.py) at the dst-lift-sat cell's shape: a
# forward of 269 windows of 243 frames of 17 joints, C = 512
DST_ROWS, DST_C = 269 * 243 * 17, 512


def _dst_randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g, device=g.device) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_dst_glue_kernels_hold_their_plain_versions_at_the_cells_shape(cuda, dtype):
    """Each kernel against its plain version on the card at M = 1,111,239,
    C = 512. Bit for bit where the arithmetic is elementwise: the residual
    s = x + (u + b), q, k, v, and GELU(y + b) in either output type. The
    LayerNorm within 1e-5 (abs and rel) in f32: the kernel sums a row's 512
    values in warp shuffles, mean first and then the squared deviations,
    torch's kernel by Welford's update, so mean and rstd differ in their
    last bits and an output (|x - mean| rstd |gamma| of a few units at most)
    by a few f32 ulps. Its bf16 output is its own f32 output rounded, bit
    for bit: only the store differs."""
    from links_tpu_torch.ops import dst_glue as G

    g = torch.Generator(cuda).manual_seed(22)
    M, C = DST_ROWS, DST_C
    x, u = _dst_randn(g, M, C), _dst_randn(g, M, C)
    b, gamma, beta = _dst_randn(g, C), 1 + _dst_randn(g, C, scale=0.1), _dst_randn(g, C)
    x0 = x.clone()
    for residual, norm in ((False, True), (True, True), (True, False)):
        aff = (gamma, beta) if norm else (None, None)

        def res():  # the kernel writes s over u
            return (u.clone(), b) if residual else (None, None)

        s, h = G.residual_layernorm(x, *res(), *aff, dtype=dtype)
        want_s, want_h = G.residual_layernorm_reference(x, *res(), *aff, dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(x, x0)
        assert torch.equal(s, want_s), (residual, norm)
        if not norm:
            assert h is None and want_h is None
            continue
        h32 = G.residual_layernorm(x, *res(), *aff)[1]
        torch.testing.assert_close(h32, G.residual_layernorm_reference(x, *res(), *aff)[1],
                                   rtol=1e-5, atol=1e-5)
        assert h.dtype == want_h.dtype == dtype and torch.equal(h, h32.to(dtype))
    del x, u, x0, s, h, want_s, want_h
    y, bq = _dst_randn(g, M, 3 * C), _dst_randn(g, 3 * C)
    assert torch.equal(G.qkv_bias_split(y, bq, dtype), G.qkv_bias_split_reference(y, bq, dtype))
    del y
    y, b1 = _dst_randn(g, M, 2 * C), _dst_randn(g, 2 * C)
    want = G.bias_gelu_cast_reference(y, b1, dtype)
    got = G.bias_gelu_cast(y.clone(), b1, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_dst_glue_refuses_what_the_kernels_do_not_take(cuda):
    from links_tpu_torch.ops import dst_glue as G

    y, b = torch.zeros(16, 60, device=cuda), torch.zeros(60, device=cuda)
    before = G.bias_gelu_cast.launches
    with pytest.raises(ValueError, match="row width 60 is not a multiple of 8"):
        G.bias_gelu_cast(y, b)
    with pytest.raises(ValueError, match="row width 60 is not a multiple of 8"):
        G.residual_layernorm(y, gamma=b, beta=b)
    with pytest.raises(ValueError, match="row width 60 is not a multiple of 8"):
        G.qkv_bias_split(torch.zeros(16, 180, device=cuda), torch.zeros(180, device=cuda))
    flat = torch.zeros(16 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        G.bias_gelu_cast(flat[1:].view(16, 64), torch.zeros(64, device=cuda))
    with pytest.raises(ValueError, match="on cuda"):
        G.bias_gelu_cast(torch.zeros(16, 64, device=cuda), torch.zeros(64))
    x = torch.zeros(16, 64, device=cuda)
    with pytest.raises(ValueError, match="may not be x"):
        G.residual_layernorm(x, x, torch.zeros(64, device=cuda))
    assert G.bias_gelu_cast.launches == before


@pytest.mark.cuda
def test_dstformer_forward_of_269_windows_makes_90_glue_launches(cuda):
    """One forward of the cell's 269 windows at MotionBERT's published widths
    (depth 5, two streams a level): 9 glue launches a stream, 5 LayerNorm
    passes, 2 qkv splits, 2 bias + GELU passes."""
    import dstformer_reference as R

    from links_tpu_torch.models import dstformer
    from links_tpu_torch.ops import dst_glue as G

    g = torch.Generator(cuda).manual_seed(23)
    model = dstformer.from_state_dict(R.init_params(g), cuda)
    x = torch.randn(269, 243, 34, generator=g, device=cuda) * 0.1
    counters = (G.residual_layernorm, G.qkv_bias_split, G.bias_gelu_cast)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        y = model.lift(x, None, BF16)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [50, 20, 20]
    assert bool(torch.isfinite(y).all())


@pytest.mark.cuda
def test_dst_glue_launches_are_filed_under_their_operator_on_the_calling_thread(cuda):
    """A glue kernel launched on a thread other than the profiler's own (as
    on serve's dispatcher) is linked to its operator there: its launch call
    lies inside the operator, on the thread of the operators and of a
    PyTorch op called beside them, and not on the thread that started the
    profiler, so a reader that matches launches to that thread's spans
    counts it. The profiler drops some events on the H100, so the glue runs
    20 times and each kernel kept with its launch is checked."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from links_tpu_torch.ops import dst_glue as G

    y, b = torch.randn(64, 512, device=cuda), torch.randn(512, device=cuda)
    G.bias_gelu_cast(y, b, torch.bfloat16)  # built and loaded before the profiler starts
    torch.cuda.synchronize()

    def work():
        for _ in range(20):
            G.bias_gelu_cast(y, b, torch.bfloat16)
        torch.neg(y)

    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=config) as prof:
        worker = threading.Thread(target=work)
        worker.start()
        worker.join()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    launches = {e.correlation_id(): e for e in events
                if e.device_type() == cpu and e.name().startswith("cu") and e.correlation_id()}
    neg = [e for e in events if e.name() == "aten::neg"]
    main = {e.start_thread_id() for e in events if e.name() == "cudaDeviceSynchronize"}
    assert len(neg) == 1 and main and neg[0].start_thread_id() not in main
    tid = neg[0].start_thread_id()
    kept = [launches[e.correlation_id()] for e in events if e.device_type() != cpu
            and "bias_gelu_kernel" in e.name() and e.correlation_id() in launches]
    assert kept, [e.name()[:60] for e in events if e.device_type() != cpu]
    assert all(launch.start_thread_id() == tid for launch in kept), \
        ("launches filed under another thread", tid, [e.start_thread_id() for e in kept])
    ops = [e for e in events if e.name() == "links_dst_glue::bias_gelu"]
    assert len(ops) == 20 and all(op.start_thread_id() == tid for op in ops)
    for launch in kept:
        assert any(op.start_ns() <= launch.start_ns() <= op.start_ns() + op.duration_ns()
                   for op in ops)
