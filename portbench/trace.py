"""One traced stretch of a run, read from ``torch.profiler``.

``traced(fn)`` runs ``fn`` under the profiler (host and device activity),
waits for the device, and reduces the trace to what the per-layer readers
and the result line need: the window's length on the host clock, the
seconds in which some operation ran on the device (the union of the device
events' intervals), device seconds and event counts by kernel name, and the
idle gaps between device operations, each labelled by the benchmark span
and the outermost host op that were open at the gap's middle on the
threads that launch kernels (the busiest first).
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict  # name -> [seconds, count]
    gaps: dict  # label -> seconds idle
    device_events: int


def span(name: str):
    """A benchmark span (a ``record_function`` range) around a call into a layer."""
    return record_function(SPAN_PREFIX + name)


def _short(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def _events(prof):
    """(name, is_device, start_ns, end_ns, thread) of every event. A
    ``record_function`` range also appears on the device's timeline (a
    user annotation spanning the work it launched): those are no device
    operation and are left out."""
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        if dev and (e.is_user_annotation() or e.name().startswith(SPAN_PREFIX)):
            continue
        start = e.start_ns()
        yield e.name(), dev, start, start + e.duration_ns(), e.start_thread_id()


def _top_level(intervals):
    """The outermost of nested (start, end, name) intervals, sorted by start."""
    out = []
    for start, end, name in sorted(intervals):
        if out and start < out[-1][1]:
            continue
        out.append((start, end, name))
    return out


def _label(tops, t) -> str | None:
    i = bisect.bisect_right(tops[0], t) - 1
    if i >= 0 and tops[1][i] > t:
        return tops[2][i]
    return None


def reduce(prof, window_s: float) -> Trace:
    device, spans, ops, launchers = [], [], defaultdict(list), defaultdict(int)
    for name, dev, start, end, thread in _events(prof):
        if dev:
            device.append((start, end, name))
        elif name.startswith(SPAN_PREFIX):
            spans.append((start, end, name[len(SPAN_PREFIX):]))
        else:
            ops[thread].append((start, end, name))
            if name.startswith("cudaLaunch") or name.startswith("cuLaunch"):
                launchers[thread] += 1
    kernels: dict = defaultdict(lambda: [0.0, 0])
    device.sort()
    busy, gaps_raw, cur_s, cur_e = 0, [], None, None
    for start, end, name in device:
        k = kernels[_short(name)]
        k[0] += (end - start) / 1e9
        k[1] += 1
        if cur_e is None:
            cur_s, cur_e = start, end
        elif start > cur_e:
            busy += cur_e - cur_s
            gaps_raw.append((cur_e, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    # the threads that launch kernels (the caller's, autograd's), busiest first
    threads = sorted((t for t in launchers if launchers[t] * 100 >= sum(launchers.values())),
                     key=lambda t: -launchers[t])
    host_tops = []
    for t in threads:
        host = _top_level(ops[t])
        host_tops.append(([h[0] for h in host], [h[1] for h in host], [h[2] for h in host]))
    span_tops = _top_level(spans)
    span_tops = ([s[0] for s in span_tops], [s[1] for s in span_tops],
                 [s[2] for s in span_tops])
    gaps: dict = defaultdict(float)
    for a, b in gaps_raw:
        mid = (a + b) // 2
        where = _label(span_tops, mid) or "outside spans"
        what = next((w for w in (_label(h, mid) for h in host_tops) if w), "no host op")
        gaps[f"{where} / {what}"] += (b - a) / 1e9
    return Trace(window_s=window_s, busy_s=busy / 1e9, kernels=dict(kernels), gaps=dict(gaps),
                 device_events=len(device))


def traced(fn) -> Trace:
    """Run ``fn()`` under the profiler; the window ends when the device is done."""
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    return reduce(prof, window_s)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the host activity that the longest idle time fell in."""
    ops = sorted(((n, v[0]) for n, v in tr.kernels.items()), key=lambda x: -x[1])[:top]
    gaps = sorted(tr.gaps.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
