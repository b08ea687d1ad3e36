"""The port's own spans over a cell's window, and the cost of one span, on the card.

    python3 portbench/tools/spans.py [--cells lr3a-train occ4-train lr-lift-sat]
                                     [--seconds 10] [--seed 3] [--cost]

For each cell: the runner's set-up and warm-up, then a window of whole
epochs (training) or of the mix (serving) for ``--seconds``, read through
the program's span totals (``links_tpu_torch/train/profiling.py:totals``)
and the dispatcher's counters; then one traced stretch as ``run.py --trace
1`` takes it, and for serving one more with the profiler recording every
thread (the dispatcher is not the thread that starts the session). Prints
one JSON line per cell: each span's count and ms per step (per device run
for serving), the benchmark's own step span beside the training phases, the
dispatcher's queue wait, and the idle gaps of each traced stretch.
``--cost``: ns per span with no profiler and inside a profiler session.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from portbench import spec, trace  # noqa: E402


def _delta(after: dict, before: dict) -> dict:
    """{name: (count, seconds)} of the spans closed between two snapshots."""
    out = {}
    for name, (n, s) in after.items():
        n0, s0 = before.get(name, (0, 0.0))
        if n > n0:
            out[name] = (n - n0, s - s0)
    return out


def _per(spans: dict, k: int) -> dict:
    return {name: {"count": n, "ms_per": 1e3 * s / k} for name, (n, s) in sorted(spans.items())}


def _gaps(tr) -> dict:
    idle = sum(tr.gaps.values())
    none = sum(v for k, v in tr.gaps.items() if k.endswith("/ no host op"))
    return {"window_s": tr.window_s, "busy_s": tr.busy_s, "idle_gaps_s": idle,
            "no_host_op_s": none, "no_host_op_share": none / idle if idle else None,
            "top": trace.breakdown(tr, 10)["idle_gaps"]}


def _all_threads(fn):
    """``trace.traced``, with the profiler recording every thread."""
    from links_tpu_torch.train.profiling import _all_threads_config

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_all_threads_config()) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return trace.reduce(prof, window_s)


def train_cell(cell, seed: int, seconds: float, dev) -> dict:
    from links_tpu_torch.train.profiling import totals

    drv = spec.runner("train_epochs")
    prog = drv.build(cell, seed, dev)
    drv.epoch(prog)
    torch.cuda.synchronize()
    rec = prog["step"]
    calls0, host0, spans0 = rec.calls, rec.host_s, totals()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        drv.epoch(prog)
    window_s = time.perf_counter() - t0
    spans, steps = _delta(totals(), spans0), rec.calls - calls0
    phases = sum(spans[n][1] for n in ("train.forward", "train.backward", "train.optim"))
    step_ms = 1e3 * (rec.host_s - host0) / steps
    out = {"cell": cell.name, "window_s": window_s, "steps": steps,
           "poses_per_s": steps * prog["batch"] / window_s,
           "host_ms_per_step": step_ms, "phases_ms_per_step": 1e3 * phases / steps,
           "phases_over_step": 1e3 * phases / steps / step_ms, "spans": _per(spans, steps),
           "traced": _gaps(trace.traced(lambda: drv.epoch(prog)))}
    del prog
    torch.cuda.empty_cache()
    return out


def serving_cell(cell, seed: int, seconds: float, dev) -> dict:
    from links_tpu_torch.train.profiling import totals

    drv = spec.runner("serving")
    mix = cell.traffic
    prog = drv.build(cell, seed, dev)
    co, fwd, pool = prog["coalescer"], prog["spans"], prog["pool"]
    stats0, spans0 = dict(co.stats), totals()
    _, records, _, _ = drv.drive(co, fwd, pool, mix, seed, seconds)
    stats = {k: co.stats[k] - stats0[k] for k in stats0}
    spans, runs = _delta(totals(), spans0), stats["device_batches"]
    answered = sum(r is not None for r in records)
    out = {"cell": cell.name, "window_s": seconds, "runs": runs, "answered_requests": answered,
           "requests_per_run": stats["merged_requests"] / runs,
           "queue_wait_ms": 1e3 * stats["queue_wait_s"] / stats["merged_requests"],
           "dispatch_host_ms_per_run": 1e3 * stats["dispatch_host_s"] / runs,
           "spans": _per(spans, runs)}
    def stretch():
        drv.drive(co, fwd, pool, mix, seed, mix["trace_s"], what="trace")

    out["traced"] = _gaps(trace.traced(stretch))
    out["traced_all_threads"] = _gaps(_all_threads(stretch))
    co.close()
    del prog, co
    torch.cuda.empty_cache()
    return out


def span_cost(n: int = 200_000) -> dict:
    """ns per ``with span(...)`` (the name and args made beforehand)."""
    from links_tpu_torch.train.profiling import span

    def loop(k):
        t0 = time.perf_counter_ns()
        for _ in range(k):
            with span("cost", "run 1 requests 16"):
                pass
        return (time.perf_counter_ns() - t0) / k

    def bare(k):
        t0 = time.perf_counter_ns()
        for _ in range(k):
            pass
        return (time.perf_counter_ns() - t0) / k

    loop(1000)
    off = min(loop(n) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = min(loop(n // 10) for _ in range(3))
    return {"span_ns_no_profiler": off, "span_ns_profiler": on, "loop_ns": bare(n)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cells", nargs="+", default=["lr3a-train", "occ4-train", "lr-lift-sat"])
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--cost", action="store_true")
    args = p.parse_args()
    from links_tpu_torch.cli import _common as C

    dev = C.resolve_device("cuda")
    if args.cost:
        print(json.dumps(span_cost()), flush=True)
    for name in args.cells:
        cell = spec.cell(name)
        run = train_cell if cell.traffic["kind"] == "train_epochs" else serving_cell
        print(json.dumps(run(cell, args.seed, args.seconds, dev)), flush=True)


if __name__ == "__main__":
    main()
