"""The DSTformer cell (dst-lift-sat) on the CPU: its FLOP count by hand, the
benchmark's reference copy against the port at a small size, its readers on
synthetic readings, the attention spans' device time from profiler events,
and the run at hidden 256: sound (``correct``), and past ``dst_gap``'s limit
under the fp8 control and the planted fault (the tail's key mask dropped)."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from conftest import small_cell

from portbench import flops_dstformer, spec
from portbench.reference import dstformer as ref

CPU = torch.device("cpu")
CONFIG = json.loads((spec.HERE / "configs" / "motionbert-dstformer-243.json").read_text())


def test_window_flops_hand_count():
    # per token: embed 3x512; per stream and level qkv 512x1536, proj 512x512,
    # fc1 512x1024, fc2 1024x512 (2 streams, spatial and temporal halves, 5
    # levels); fusion 1024x2 per level; pre_logits 512x512; head 512x3
    per_token = 3 * 512 + 20 * (512 * 1536 + 512 * 512 + 512 * 1024 + 1024 * 512) \
        + 5 * 1024 * 2 + 512 * 512 + 512 * 3
    assert per_token == 42_218_496
    temporal = 20 * 2 * 243 * 243 * 512 * 17 // 2  # 10 temporal attentions, QK^T and PV
    spatial = 20 * 2 * 17 * 17 * 512 * 243 // 2
    want = 2 * (per_token * 243 * 17 + temporal + spatial)
    assert flops_dstformer.window_flops(CONFIG, 243) == want
    assert 370e9 < want < 372e9  # ~371 GFLOP a window
    assert flops_dstformer.clip_flops(CONFIG, 500) == \
        2 * want + flops_dstformer.window_flops(CONFIG, 14)
    assert flops_dstformer.window_flops(CONFIG, 1) == 2 * (per_token * 17 + 10 * 2 * 17 * 512
                                                           + 10 * 2 * 17 * 17 * 512)


def test_widths_are_the_published_ones():
    w = flops_dstformer.widths(CONFIG)
    assert (w["dim_feat"], w["mlp_hidden"], w["depth"], w["dim_rep"], w["maxlen"]) == \
        (512, 1024, 5, 512, 243)
    assert CONFIG["num_heads"] == 8 and w["dim_feat"] // CONFIG["num_heads"] == 64
    sd = ref.init_params(torch.Generator().manual_seed(0), **w)
    assert 42.4e6 < sum(v.numel() for v in sd.values()) < 42.5e6


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_reference_copy_matches_the_port(prec):
    from links_tpu_torch.core.nn import BF16, F32
    from links_tpu_torch.models import dstformer

    p = ref.init_params(torch.Generator().manual_seed(1), dim_feat=64, mlp_hidden=128,
                        depth=2, maxlen=27)
    model = dstformer.from_state_dict(p, num_heads=4)
    x = torch.randn(2, 27, 34, generator=torch.Generator().manual_seed(2)) * 0.3
    got = model.lift(x, policy=F32 if prec == "f32" else BF16)
    for w in range(2):
        want = ref.lift(p, x[w], 4, ref.F32 if prec == "f32" else ref.BF16)
        gap = float((got[w] - want).abs().max() / want.abs().max())
        assert gap < (1e-5 if prec == "f32" else 2e-2)


def _reader(name):
    return spec.metric_reader(name).read


def test_readers_by_hand():
    c = {"device_batches": 10, "merged_requests": 160, "windows": 3000, "tail_windows": 160,
         "frames_run": 729000, "frames_padded": 18225}
    assert _reader("dst.windows_per_run")({"coalescer": c}) == 300.0
    assert _reader("dst.pad_share")({"coalescer": c}) == pytest.approx(2.5)
    assert _reader("dst.mfu")({"dst_flops": 989e12, "window_s": 10.0}) == pytest.approx(10.0)
    tr = SimpleNamespace(busy_s=2.0, window_s=2.5, device_events=10)
    assert _reader("dst.attention_share")({"trace": tr, "attention_device_s": 0.5}) == \
        pytest.approx(25.0)
    assert _reader("dst.idle_share")({"trace": tr}) == pytest.approx(20.0)


@pytest.mark.parametrize("name", ["dst.windows_per_run", "dst.pad_share", "dst.mfu",
                                  "dst.attention_share", "dst.idle_share"])
@pytest.mark.parametrize("readings", [
    {}, {"coalescer": {"device_batches": 0, "merged_requests": 0}},
    {"coalescer": {"device_batches": 4, "merged_requests": 9}},  # a program without the counters
], ids=["nothing", "no_run", "no_counter"])
def test_nothing_to_read_is_none(name, readings):
    assert _reader(name)(readings) is None


class _Event:
    def __init__(self, name, device, start, dur, thread=1, corr=0, annotation=False):
        self._v = (name, device, start, dur, thread, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_attention_device_time_follows_the_launches():
    """Kernels count when their launch lies inside a dst.attn_* span on the
    launching thread, whenever they ran on the device."""
    drv = spec.runner("serving_windows")
    events = [
        _Event("links.dst.attn_s", False, 100, 50, thread=7, corr=1, annotation=True),
        _Event("cudaLaunchKernel", False, 110, 2, thread=7, corr=11),
        _Event("cudaLaunchKernel", False, 160, 2, thread=7, corr=12),  # after the span
        _Event("cudaLaunchKernel", False, 120, 2, thread=8, corr=13),  # another thread
        _Event("gemm", True, 300, 1000, corr=11),
        _Event("add", True, 1300, 500, corr=12),
        _Event("copy", True, 1800, 250, corr=13),
        _Event("links.dst.attn_s", True, 300, 1000, corr=1, annotation=True),
        _Event("links.dst.attn_t", False, 400, 50, thread=8),
        _Event("cudaMemcpyAsync", False, 420, 2, thread=8, corr=14),
        _Event("Memcpy DtoD", True, 2100, 4000, corr=14),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert drv.attention_device_s(prof) == pytest.approx(5000 / 1e9)
    assert drv.attention_device_s(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events[1:7])))) is None


def _cell():
    cell = small_cell("dst-lift-sat")
    cell.traffic.update(check_span=4, check_requests=2)  # sent within a short window
    return cell


def test_sound_run_is_correct():
    cell = _cell()
    out = spec.runner("serving_windows").run(cell, 2 ** 31 + 9, 0.3, False, CPU, {})
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted >= 4 and out.failed == 0
    assert out.end_to_end["lift_poses_per_s"] > 0
    c = out.readings["coalescer"]
    assert c["windows"] >= out.attempted and c["frames_padded"] > 0


def test_control_and_fault_exceed_the_limit():
    cell = _cell()
    got = spec.runner("serving_windows").calibrate(cell, 2 ** 31 + 10, CPU, control=True,
                                                   seconds=0.3)
    limit = cell.limits["dst_gap"]
    assert got["program"]["dst_gap"] <= limit
    assert got["control_fp8"]["dst_gap"] > limit
    assert got["fault_no_tail_mask"]["dst_gap"] > limit


def test_sample_holds_the_longest_and_the_shortest_tail():
    drv = spec.runner("serving_windows")
    cell = spec.cell("dst-lift-sat")
    mix = cell.traffic
    reqs = drv.traffic.sequence(mix, 5, mix["check_span"])
    sample = drv.choose_sample(mix, 5, 243)
    assert len(sample) >= mix["check_requests"]
    sizes = [reqs[i][0] for i in sample]
    assert max(sizes) == max(n for n, _ in reqs)
    assert min(drv.tail(n, 243) for n in sizes) == min(drv.tail(n, 243) for n, _ in reqs)
    assert drv.tail(243, 243) == 243 and drv.tail(244, 243) == 1


def test_parent_without_the_model_fails_at_once(monkeypatch):
    """A program that lacks the DSTformer (the parent commit) fails with an
    error in the set-up, before any caller starts."""
    import links_tpu_torch.cli.lift as lift

    def missing(args, batch, device):
        raise ImportError("no links_tpu_torch.models.dstformer")

    monkeypatch.setattr(lift, "build_serving_fn", missing)
    with pytest.raises(ImportError):
        spec.runner("serving_windows").run(_cell(), 1, 0.3, False, CPU, {})
