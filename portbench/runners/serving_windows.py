"""Windowed serving cells: the path ``serve --model dstformer`` runs, without
HTTP. Set-up draws the configuration's DSTformer from the seed
(``reference/dstformer.py:init_params``), writes it under ``TMPDIR`` and
builds the serving forward from ``serve``'s own flags
(``cli/lift.py:build_serving_fn``), warmed as ``serve`` warms it, behind the
daemon's windowed dispatcher (``cli/serve.py:WindowCoalescer``), then sends
requests of 1 window, 1 chunk and 4 chunks through it, one at a time.

The load is a closed loop of the mix's ``callers`` (``runners/serving.py:
drive``), each sending its next clip as soon as its reply comes, for
``seconds``. ``lift_poses_per_s`` is the frames of every clip sent in that
time over the time until the last of their replies: each run here merges
most callers' clips and takes seconds, so counting only the clips answered
inside the window would move by a whole run's frames with the phase of the
runs. ``dst.mfu`` divides those clips' model FLOPs (``flops_dstformer``, at
their valid frames) by the same time. With ``--trace 1`` a further stretch
of the mix runs under the profiler, every thread recorded, and the device
time of the kernels launched inside the program's ``dst.attn_s`` and
``dst.attn_t`` spans is read by their launches' correlation.

``correct``: every request sent is answered with (N, 51) poses, and a
sample drawn from the seed, with the longest request and the one with the
shortest last window in it, matches the plain f32 reference run on each
unpadded window (``dst_gap``: for each request max |program - reference| /
max |reference|, the largest over the sample).
"""

from __future__ import annotations

import bisect
import math
import shutil
import tempfile
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from portbench import core, data, flops_dstformer, trace, traffic
from portbench.reference import dstformer as ref
from portbench.runners import serving as sv

ATTENTION_SPANS = ("links.dst.attn_s", "links.dst.attn_t")


class WindowSpans:
    """The benchmark's span around each call of the windowed forward: its
    windows, and the thread that makes the calls (the dispatcher's)."""

    def __init__(self, fn):
        self.fn, self.window, self.windows, self.thread = fn, fn.window, [], None

    def __call__(self, x, lens, args=None):
        self.thread = threading.get_ident()
        with trace.span("forward"):
            self.windows.append(x.shape[0])
            return self.fn(x, lens, args=args)


def state_dict(config: dict, seed: int, device) -> dict:
    """The configuration's DSTformer, every parameter drawn from the seed."""
    g = torch.Generator(device).manual_seed(core.derive(seed, "weights"))
    return ref.init_params(g, **flops_dstformer.widths(config))


def build(cell, seed: int, device):
    """The windowed serving forward behind a WindowCoalescer, warmed, and the
    request pool."""
    from links_tpu_torch.cli import serve
    from links_tpu_torch.cli.lift import build_serving_fn, lift_windows

    mix, cfg = cell.traffic, cell.config
    sd = state_dict(cfg, seed, device)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        torch.save({k: v.cpu() for k, v in sd.items()}, tmp / "dstformer.pt")
        args = serve.build_parser().parse_args([
            "--model", "dstformer", "--dst-pt", str(tmp / "dstformer.pt"),
            "--policy", cfg["serve"]["precision"], "--batch-size", str(mix["batch_size"]),
            "--coalesce-wait-ms", str(mix["coalesce_wait_ms"]), "--device", str(device)])
        dev = serve.C.resolve_device(args.device)
        with torch.inference_mode():
            fn, batch, _ = build_serving_fn(args, args.batch_size, dev)
            lift_windows(fn, np.zeros((batch, 34), np.float32), batch, dev)  # serve's warm-up
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spans = WindowSpans(fn)
    co = serve.WindowCoalescer(spans, batch, dev, max_wait_ms=args.coalesce_wait_ms,
                               window=fn.window)
    pool = data.test_poses(mix["pool_poses"],
                           torch.Generator(device).manual_seed(core.derive(seed, "data")))
    pool = pool.cpu().numpy()
    T, chunk = fn.window, co.batch
    reps = np.resize(pool, (4 * chunk * T, 34))
    for n in (1, T + 1, chunk * T - 1, 4 * chunk * T):  # tails and full windows at each size
        co.submit(reps[:n])
    return {"coalescer": co, "spans": spans, "pool": pool, "sd": sd}


def tail(n: int, window: int) -> int:
    """The valid frames of a clip's last window."""
    return n - (-(-n // window) - 1) * window


def choose_sample(mix: dict, seed: int, window: int) -> list[int]:
    """``check_requests`` of the first ``check_span`` requests the callers
    send, drawn from the seed, with the longest and the one whose last
    window is shortest."""
    reqs = traffic.sequence(mix, seed, mix["check_span"])
    rng = np.random.default_rng(core.derive(seed, "sample"))
    pick = set(rng.choice(len(reqs), size=min(mix["check_requests"], len(reqs)),
                          replace=False).tolist())
    pick.add(max(range(len(reqs)), key=lambda i: reqs[i][0]))
    pick.add(min(range(len(reqs)), key=lambda i: tail(reqs[i][0], window)))
    return sorted(pick)


def reference_lift(sd: dict, x: torch.Tensor, config: dict, prec) -> torch.Tensor:
    """The reference's lift of one clip, window by unpadded window."""
    T, heads = config["maxlen"], config["num_heads"]
    return torch.cat([ref.lift(sd, x[i:i + T], heads, prec) for i in range(0, x.shape[0], T)])


def reference_gap(sd: dict, config: dict, pool, sched, outputs, sample, device) -> float:
    """The largest over ``sample`` of max |output - reference| / max
    |reference|, the f32 reference on each unpadded window; inf where an
    output is missing."""
    worst = 0.0
    with torch.no_grad():
        for i in sample:
            if outputs.get(i) is None:
                return math.inf
            _, n, ofs = sched[i]
            want = reference_lift(sd, torch.from_numpy(pool[ofs:ofs + n]).to(device), config,
                                  ref.F32)
            got = torch.as_tensor(outputs[i], device=device)
            worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    return worst


def attention_device_s(prof, names=ATTENTION_SPANS) -> float | None:
    """Device seconds of the kernels (and copies) whose launch call lies
    inside one of the program's spans ``names`` on the launching thread,
    matched by the profiler's correlation ids; None where the trace holds no
    such span or no device event."""
    ranges, launches, device = defaultdict(list), {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name in names:
                ranges[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith("cu") and e.correlation_id():
                launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif not e.is_user_annotation() and not name.startswith(("links.", trace.SPAN_PREFIX)):
            device.append((e.correlation_id(), e.duration_ns()))
    if not ranges or not device:
        return None
    starts = {t: sorted(r) for t, r in ranges.items()}
    total = 0
    for corr, dur in device:
        thread, t = launches.get(corr, (None, 0))
        spans = starts.get(thread)
        if spans:
            i = bisect.bisect_right(spans, (t, math.inf)) - 1
            if i >= 0 and spans[i][1] >= t:
                total += dur
    return total / 1e9


def traced(fn):
    """``fn()`` under the profiler, every thread's host activity recorded
    (the forward runs on the dispatcher's thread) -> (``trace.Trace``, the
    attention spans' device seconds)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        config = None
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, experimental_config=config) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    return trace.reduce(prof, window_s), attention_device_s(prof)


def _window(sched, records, config: dict) -> dict:
    """The readings of one closed-loop stretch: the frames and model FLOPs
    of every request sent, and the seconds until the last reply."""
    done = [i for i, r in enumerate(records) if r is not None]
    end = max((records[i][1] for i in done), default=0.0)
    frames = sum(sched[i][1] for i in done)
    return {"frames": frames, "end_s": end,
            "flops": sum(flops_dstformer.clip_flops(config, sched[i][1]) for i in done)}


def run(cell, seed: int, seconds: float, traced_run: bool, device, clock: dict) -> core.Outcome:
    """One run; sets ``clock['window_start']`` (host clock) when the window opens."""
    mix, cfg = cell.traffic, cell.config
    prog = build(cell, seed, device)
    co, spans, pool = prog["coalescer"], prog["spans"], prog["pool"]
    sample = choose_sample(mix, seed, spans.window)
    stats0 = dict(co.stats)
    clock["window_start"] = time.perf_counter()
    sched, records, note, cpu = sv.drive(co, spans, pool, mix, seed, seconds, keep=sample)
    stats = {k: co.stats[k] - stats0[k] for k in stats0}
    w = _window(sched, records, cfg)
    failed = sum(r is None for r in records)
    lat = sorted(r[0] for r in records if r is not None)
    rate = w["frames"] / w["end_s"] if w["end_s"] > 0 else 0.0
    e2e = {"lift_poses_per_s": rate}
    readings = {"config": cfg, "window_s": w["end_s"], "coalescer": stats,
                "dst_flops": w["flops"]}
    notes = [f"requests {len(sched)}, answered {len(lat)}, last reply at {w['end_s']:.3f} s, "
             f"latency p50 {sv.percentile_ms(lat, 0.50):.3f} ms p95 "
             f"{sv.percentile_ms(lat, 0.95):.3f} ms, returned {rate:.1f} poses/s; {note}",
             "host CPU seconds in the window and its drain: " + ", ".join(
                 f"{k} {v:.4f}" for k, v in cpu.items() if v is not None),
             "dispatcher: " + ", ".join(f"{k} {v}" for k, v in stats.items())]
    tr = None
    if traced_run:
        tr, attn_s = traced(lambda: sv.drive(co, spans, pool, mix, seed, mix["trace_s"],
                                             what="trace"))
        readings.update(trace=tr, attention_device_s=attn_s)
    co.close()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    sd = prog["sd"]
    del prog, co, spans
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref.full_f32()
    outputs = {i: records[i][3] for i in sample if i < len(records) and records[i] is not None}
    value = reference_gap(sd, cfg, pool, sched, outputs, sample, device)
    checks = [core.Check("dst_gap", value, cell.limits["dst_gap"])]
    return core.Outcome(attempted=len(sched), failed=failed, end_to_end=e2e,
                        readings=readings, checks=checks, memory_peak_bytes=peak, trace=tr,
                        notes=notes)


def calibrate(cell, seed: int, device, control: bool, seconds: float = 10.0) -> dict:
    """The readings behind the limit, for one seed: ``dst_gap`` of a window at
    the cell's load; with ``control``, the gap of the reference computed at
    fp8 (one precision below the configuration's bf16) against the f32
    reference, and of the program with a planted fault: the temporal key
    mask of short windows dropped, so that their padded frames take part."""
    from links_tpu_torch.models import dstformer

    mix, cfg = cell.traffic, cell.config
    prog = build(cell, seed, device)
    co, spans, pool, sd = prog["coalescer"], prog["spans"], prog["pool"], prog["sd"]
    sample = choose_sample(mix, seed, spans.window)

    def outputs():
        sched, records, _, _ = sv.drive(co, spans, pool, mix, seed, seconds, keep=sample)
        return sched, {i: records[i][3] for i in sample
                       if i < len(records) and records[i] is not None}

    sched, program = outputs()
    faulty = None
    if control:
        real = dstformer.DSTformer.forward
        dstformer.DSTformer.forward = lambda self, x, lens=None, *a, **kw: real(self, x, None,
                                                                                *a, **kw)
        try:
            _, faulty = outputs()
        finally:
            dstformer.DSTformer.forward = real
    co.close()
    del prog, co, spans
    ref.full_f32()
    out = {"program": {"dst_gap": reference_gap(sd, cfg, pool, sched, program, sample, device)}}
    if control:
        with torch.no_grad():
            fp8 = {}
            for i in sample:
                _, n, ofs = sched[i]
                x = torch.from_numpy(pool[ofs:ofs + n]).to(device)
                fp8[i] = reference_lift(sd, x, cfg, ref.FP8).cpu().numpy()
        out["control_fp8"] = {"dst_gap": reference_gap(sd, cfg, pool, sched, fp8, sample,
                                                       device)}
        out["fault_no_tail_mask"] = {"dst_gap": reference_gap(sd, cfg, pool, sched, faulty,
                                                              sample, device)}
    return out
