"""The port's spans and the dispatcher's counters (train/profiling.py): the
totals across nested, sequential and concurrent spans, the profiler's
``links.*`` ranges, one of each training phase per step of every stage, the
epoch loop's draws and read-back, and serve's queue wait, merge and reply,
with /healthz reporting them. On the CPU, at tiny widths."""

import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu_torch.cli import serve as tserve
from links_tpu_torch.cli.serve import Coalescer
from links_tpu_torch.config import (
    FlowTrainConfig,
    LifterTrainConfig,
    OcclusionTrainConfig,
    PartFlowTrainConfig,
)
from links_tpu_torch.core import geometry as tgeo
from links_tpu_torch.data.synthetic import generate_poses
from links_tpu_torch.flows import Flow
from links_tpu_torch.models.completers import Completers
from links_tpu_torch.models.lifters import LegTorsoLifter, Lifter, StackedLifter
from links_tpu_torch.objectives.flow_nll import PartFlows
from links_tpu_torch.objectives.lifter import LifterFrozen
from links_tpu_torch.train import profiling, steps
from links_tpu_torch.train.loop import run_epoch
from links_tpu_torch.train.optim import Adam

HID = 32
BATCH = 8
PHASES = ("train.forward", "train.backward", "train.optim")


def _delta(after: dict, before: dict, name: str) -> tuple[int, float]:
    n0, s0 = before.get(name, (0, 0.0))
    n1, s1 = after.get(name, (0, 0.0))
    return n1 - n0, s1 - s0


def test_sequential_spans_add_count_and_seconds():
    before = profiling.totals()
    for _ in range(3):
        with profiling.span("test.sequential"):
            time.sleep(0.002)
    n, sec = _delta(profiling.totals(), before, "test.sequential")
    assert n == 3
    assert 0.006 <= sec < 1.0


def test_nested_spans_each_count_their_own_time():
    before = profiling.totals()
    with profiling.span("test.outer") as outer:
        time.sleep(0.002)
        with profiling.span("test.inner") as inner:
            time.sleep(0.004)
    after = profiling.totals()
    assert _delta(after, before, "test.outer")[0] == 1
    assert _delta(after, before, "test.inner")[0] == 1
    assert inner.seconds >= 0.004 and outer.seconds >= inner.seconds + 0.002
    assert _delta(after, before, "test.inner")[1] == pytest.approx(inner.seconds)


def test_spans_closed_on_many_threads_count_exactly():
    """More threads than cores, switching as often as the interpreter lets
    them: a lost update of the table would lose counts."""
    before = profiling.totals()
    n_threads, each = 4 * (os.cpu_count() or 4), 500
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(each):
            with profiling.span("test.threads"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _delta(profiling.totals(), before, "test.threads")[0] == n_threads * each


def test_totals_is_a_snapshot():
    with profiling.span("test.snapshot"):
        pass
    snap = profiling.totals()
    n = snap["test.snapshot"][0]
    with profiling.span("test.snapshot"):
        pass
    assert snap["test.snapshot"][0] == n
    assert profiling.totals()["test.snapshot"][0] == n + 1


def test_spans_are_ranges_under_the_profiler_and_count_without_it():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("test.profiled", "run 7 requests 2"):
            torch.ones(4) * 2
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "links.test.profiled" in names
    before = profiling.totals()
    with profiling.span("test.profiled"):
        torch.ones(4) * 2
    assert _delta(profiling.totals(), before, "test.profiled")[0] == 1


def test_trace_writes_the_spans_of_other_threads(tmp_path):
    def dispatcher():
        with profiling.span("test.other_thread", "run 1"):
            torch.ones(4) + 1

    with profiling.trace(str(tmp_path)):
        t = threading.Thread(target=dispatcher)
        t.start()
        t.join(timeout=30)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert "links.test.other_thread" in {e.get("name") for e in events}


# -- the training step's phases -------------------------------------------------------------

def _poses(n: int) -> torch.Tensor:
    p = generate_poses(n, seed=5)["poses_2d"].astype(np.float32)
    return tgeo.normalize_head(torch.from_numpy(p.transpose(0, 2, 1).reshape(n, 34)))


def _flow(dim: int, seed: int) -> Flow:
    return Flow(dim, 2, HID, generator=torch.Generator().manual_seed(seed))


def _lifter(joints: int, seed: int) -> Lifter:
    return Lifter(joints, HID, generator=torch.Generator().manual_seed(seed))


def _stage(name: str):
    """(step, model, draw) of one stage at tiny widths, f32."""
    g = torch.Generator().manual_seed(11)
    if name == "full_flow":
        model = _flow(34, 1)
        return (steps.build_full_flow_step(FlowTrainConfig(batch_size=BATCH, bf16=False)),
                model, steps.draw_noise)
    if name == "part_flows":
        model = PartFlows(_flow(22, 2), _flow(22, 3), _flow(14, 4), _flow(20, 5))
        full = _flow(34, 1).requires_grad_(False)
        return (steps.build_part_flows_step(full, PartFlowTrainConfig(batch_size=BATCH,
                                                                      bf16=False)),
                model, steps.draw_noise)
    cfg = LifterTrainConfig(batch_size=BATCH, bf16=False)
    if name == "left_right":
        frozen = LifterFrozen(*(f.requires_grad_(False)
                                for f in (_flow(34, 1), _flow(22, 2), _flow(22, 3))))
        model = StackedLifter(_lifter(11, 6), _lifter(11, 7))
        return steps.build_left_right_step(frozen, cfg), model, steps.draw_step
    if name == "leg_torso":
        frozen = LifterFrozen(*(f.requires_grad_(False)
                                for f in (_flow(34, 1), _flow(14, 4), _flow(20, 5))))
        model = LegTorsoLifter(_lifter(7, 8), _lifter(10, 9))
        return steps.build_leg_torso_step(frozen, cfg), model, steps.draw_step
    legs, torso = (_lifter(j, s).requires_grad_(False) for j, s in ((7, 8), (10, 9)))
    model = Completers(HID, generator=g)
    cfg = OcclusionTrainConfig(batch_size=BATCH, bf16=False)
    return (steps.build_occlusion_step(legs, torso, cfg), model,
            lambda gen, b, dev: steps.draw_occlusion(gen, b, dev, cfg.n_rot))


@pytest.mark.parametrize("stage", ["full_flow", "part_flows", "left_right", "leg_torso",
                                   "occlusion"])
def test_one_step_has_one_of_each_phase(stage):
    step, model, draw = _stage(stage)
    state = steps.TrainState(model, Adam(model.parameters(), LifterTrainConfig().optim, 1))
    draws = draw(torch.Generator().manual_seed(3), BATCH, "cpu")
    before = profiling.totals()
    step(state, _poses(BATCH), draws)
    after = profiling.totals()
    for name in PHASES:
        n, sec = _delta(after, before, name)
        assert n == 1 and sec > 0, name
    assert _delta(after, before, "train.all_reduce")[0] == 0  # no group, no mean


def test_epoch_has_a_draw_per_step_and_one_readback():
    step, model, draw = _stage("left_right")
    state = steps.TrainState(model, Adam(model.parameters(), LifterTrainConfig().optim, 3))
    before = profiling.totals()
    run_epoch(step, state, _poses(3 * BATCH + 2), BATCH, torch.Generator().manual_seed(4),
              draw=draw)
    after = profiling.totals()
    assert _delta(after, before, "train.draw")[0] == 3
    assert _delta(after, before, "train.readback")[0] == 1
    assert _delta(after, before, "train.forward")[0] == 3


# -- serve's dispatcher ---------------------------------------------------------------------

def _submit_all(co, payloads):
    outs = [None] * len(payloads)

    def worker(i):
        outs[i] = co.submit(payloads[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return outs


def test_coalescer_counts_queue_wait_and_one_merge_and_reply_per_run():
    def fn(chunk):
        time.sleep(0.02)  # hold the "device" so submitters queue
        return chunk * 2.0

    co = Coalescer(fn, batch=16)
    before = profiling.totals()
    rng = np.random.default_rng(0)
    payloads = [rng.normal(size=(n, 34)).astype(np.float32) for n in (3, 5, 4, 7, 2, 6)]
    try:
        outs = _submit_all(co, payloads)
    finally:
        co.close()
    for p, o in zip(payloads, outs):
        np.testing.assert_allclose(o, p * 2.0, rtol=1e-6)
    after = profiling.totals()
    runs = co.stats["device_batches"]
    assert co.stats["merged_requests"] == 6 and runs < 6
    assert co.stats["queue_wait_s"] > 0
    assert _delta(after, before, "serve.merge")[0] == runs
    assert _delta(after, before, "serve.reply")[0] == runs
    merge_reply = (_delta(after, before, "serve.merge")[1]
                   + _delta(after, before, "serve.reply")[1])
    assert co.stats["dispatch_host_s"] == pytest.approx(merge_reply)
    assert _delta(after, before, "lift.forward")[0] >= runs  # a chunk at least per run


def test_coalescer_counts_the_retry_path():
    """A poisoned request among merged ones: each is rerun alone and gets its
    own reply span."""
    gate = threading.Event()

    def fn(chunk):
        gate.wait(5)
        if bool((chunk[:, 0] > 100).any()):
            raise ValueError("poisoned")
        return chunk + 1.0

    co = Coalescer(fn, batch=64)
    before = profiling.totals()
    good = np.zeros((2, 34), np.float32)
    bad = np.full((2, 34), 1000.0, np.float32)
    got = {}

    def worker(name, p):
        try:
            got[name] = co.submit(p)
        except ValueError as e:
            got[name] = e

    first = threading.Thread(target=worker, args=("first", good))
    first.start()
    time.sleep(0.1)  # the first run holds the gate; the next two queue and merge
    rest = [threading.Thread(target=worker, args=(k, p)) for k, p in (("ok", good), ("bad", bad))]
    for t in rest:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in [first] + rest:
        t.join(timeout=30)
    co.close()
    assert isinstance(got["bad"], ValueError)
    np.testing.assert_allclose(got["ok"], good + 1.0)
    after = profiling.totals()
    assert _delta(after, before, "serve.merge")[0] == 2
    assert _delta(after, before, "serve.reply")[0] == 3  # the first run; each retried request
    assert co.stats["device_batches"] == 2 and co.stats["merged_requests"] == 2


def test_healthz_reports_queue_wait_and_spans(monkeypatch):
    """The daemon's /healthz carries the dispatcher's counters and the span
    totals (a model on an identity forward: ``make_server``'s loading is
    held elsewhere, tests/test_torch_serve.py)."""
    args = tserve.build_parser().parse_args(["--port", "0", "--device", "cpu", "--no-warmup",
                                             "--batch-size", "16"])
    monkeypatch.setattr(tserve, "build_serving_fn", lambda a, batch, device: (
        lambda p: torch.cat([p, p[:, :17]], 1), batch, {}))
    server = tserve.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        body = json.dumps({"poses_2d": np.zeros((3, 34)).tolist()}).encode()
        req = urllib.request.Request(base + "/lift", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read())["count"] == 3
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
    assert health["merged_requests"] == 1 and health["queue_wait_s"] >= 0
    assert health["dispatch_host_s"] > 0
    for name in ("serve.merge", "serve.reply", "lift.h2d", "lift.forward", "lift.d2h"):
        assert health["spans"][name]["count"] >= 1 and health["spans"][name]["seconds"] >= 0
