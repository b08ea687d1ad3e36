"""FLOP and byte counts against hand counts at the configurations' shapes."""

from __future__ import annotations

import pytest

from portbench import flops, spec

H = 1024


def _lr():
    return spec.cell("lr3a-train").config


def _occ():
    return spec.cell("occ4-train").config


def test_lift_flops_hand_count():
    # per side: upscale 22->1024, res_common and 3 pose blocks (8 products of
    # 1024 x 1024), depth head 1024->11; both sides, 2 FLOPs per multiply-add
    per_side = 22 * H + 8 * H * H + H * 11
    assert flops.lift_flops(_lr(), 1) == 2 * 2 * per_side
    assert flops.lift_flops(_lr(), 4096) == 4096 * 2 * 2 * per_side


def test_train_step_flops_left_right_hand_count():
    b = 8192
    rows = 2 * b
    lift_fwd = 2 * rows * (22 * H + 14 * H * H + H * 11 + H * 1)
    # backward: weights' gradients everywhere, the input's everywhere but upscale
    lift_bwd = 2 * lift_fwd - 2 * rows * 22 * H
    relift_fwd = 2 * rows * (22 * H + 8 * H * H + H * 11)
    relift_bwd = 2 * relift_fwd
    full_flow = 8 * 2 * b * (17 * H + H * 34 + 34 * 34) * 2  # forward and inverse
    part_flow = 8 * 2 * rows * (11 * H + H * 22 + 22 * 22) * 2  # forward, input gradient
    want = full_flow + 2 * (lift_fwd + lift_bwd + part_flow + relift_fwd + relift_bwd)
    assert flops.train_step_flops(_lr(), b) == want
    assert 4.4e12 < want < 4.8e12


def test_train_step_flops_occlusion_hand_count():
    b = 8192
    rows = 3 * b
    lifters = 2 * b * ((14 * H + 8 * H * H + H * 7) + (20 * H + 8 * H * H + H * 10))
    comps = 0
    for i, o in [(14, 3)] * 4 + [(11, 6), (7, 10), (11, 6), (11, 6)]:
        fwd = 2 * rows * (3 * i * H + 6 * H * H + H * 3 * o)
        comps += fwd + 2 * fwd - 2 * rows * 3 * i * H
    assert flops.train_step_flops(_occ(), b) == lifters + comps


def test_k1_calls_per_step():
    assert flops.k1_calls_per_step(_lr(), 8192) == [("forward", 16384, 28),
                                                    ("backward", 16384, 22)]
    assert flops.k1_calls_per_step(_occ(), 8192) == [("forward", 8192, 14),
                                                     ("forward", 24576, 24),
                                                     ("backward", 24576, 24)]


@pytest.mark.parametrize("rows", [1, 256, 4096, 16384])
def test_k1_least_time_hand_count(rows):
    fwd_flops = 2 * 2 * rows * H * H
    fwd_bytes = rows * H * 2 + rows * H * 4 + 2 * H * H * 2 + 2 * H * 4
    assert flops.k1_least_s("forward", rows, H, True) == pytest.approx(
        max(fwd_flops / 989e12, fwd_bytes / 3.35e12))
    bwd_flops = 4 * 2 * rows * H * H
    bwd_bytes = rows * H * 2 + 2 * rows * H * 4 + 2 * H * H * 2 + 2 * H * 4 + 2 * H * H * 4 \
        + 2 * H * 4
    assert flops.k1_least_s("backward", rows, H, True) == pytest.approx(
        max(bwd_flops / 989e12, bwd_bytes / 3.35e12))
    f32_bytes = rows * H * 8 + 2 * H * H * 4 + 2 * H * 4
    assert flops.k1_least_s("forward", rows, H, False) == pytest.approx(
        max(fwd_flops / 989e12, f32_bytes / 3.35e12))


def test_k1_kernel_names():
    for name in ("void (anonymous namespace)::wgmma_gemm<2, 128, 4, false, true, 0>",
                 "tf32_gemm<1, 2, 64, 0, true, false>", "split_kernel", "terms3_gemm<2>"):
        assert flops.is_k1_kernel(name)
    assert not flops.is_k1_kernel("ampere_sgemm_128x64_nn")
    assert not flops.is_k1_kernel("fused_sides_kernel")


def _trace(k1_s: float, busy_s: float = 1.0, window_s: float = 2.0):
    from portbench.trace import Trace

    return Trace(window_s=window_s, busy_s=busy_s,
                 kernels={"wgmma_gemm<2, 128, 2, false, true, 2>": [k1_s, 10],
                          "ampere_sgemm_128x64_nn": [5.0, 10]},
                 gaps={}, device_events=20)


def test_k1_roofline_reader_by_hand():
    from portbench import readers

    calls = [("forward", 32768, 28, True), ("backward", 32768, 22, True)]
    least = 28 * flops.k1_least_s("forward", 32768, H, True) \
        + 22 * flops.k1_least_s("backward", 32768, H, True)
    r = {"trace": _trace(4 * least), "k1_calls": calls, "config": _lr(),
         "counters": {"forward": 28, "backward": 22}}
    assert readers.k1_roofline(r) == pytest.approx(25.0)  # the sgemm is no K1 kernel
    r["counters"] = {"forward": 27, "backward": 22}
    assert readers.k1_roofline(r) is None  # spans and counters disagree: nothing read
    r["counters"], r["trace"] = {"forward": 28, "backward": 22}, _trace(0.0)
    assert readers.k1_roofline(r) is None  # no K1 time: no share, never 0


def test_share_readers_by_hand():
    from portbench import readers

    assert readers.idle_share({"trace": _trace(1.0, busy_s=1.5, window_s=2.0)}) == \
        pytest.approx(25.0)
    assert readers.idle_share({}) is None
    steps = {"steps": 10, "flops_per_step": 989e12, "window_s": 100.0, "host_step_s": 0.5}
    assert readers.train_mfu(steps) == pytest.approx(10.0)
    assert readers.host_ms_per_step(steps) == pytest.approx(50.0)
    assert readers.lift_mfu({"poses": 1000, "flops_per_pose": 989e9, "window_s": 10.0}) == \
        pytest.approx(10.0)
    assert readers.requests_per_run({"coalescer": {"merged_requests": 32,
                                                   "device_batches": 2}}) == 16.0
    assert readers.train_mfu({"steps": 0}) is None
