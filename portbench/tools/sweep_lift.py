"""Offered rate against what the serving path sustains, on the card: the
sweep that sets a serving cell's fixed rate.

    python3 portbench/tools/sweep_lift.py --rates 300 600 900 [--batch-size 4096] --seconds 6

One set-up, then for each rate the cell's clips as open-loop arrivals at
that rate (a closed-loop mix's callers dropped) for ``--seconds``: one JSON
line with the poses/s returned within the window, the p50, p95 and p99
latency, the latency of the last tenth of the requests against the first
tenth (a growing backlog shows as a ratio well over 1), the requests per
device run, the caller threads the open loop took and the host CPU seconds
by thread.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench import spec, traffic  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cell", default="lr-lift-sat")
    p.add_argument("--batch-size", type=int, default=None, help="serve's --batch-size")
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args()
    cell = spec.cell(args.cell)
    cell.traffic.pop("callers", None)
    if args.batch_size:
        cell.traffic["batch_size"] = args.batch_size
    drv = spec.runner("serving")
    dev = torch.device("cuda", 0)
    prog = drv.build(cell, args.seed, dev)
    co, pool, spans = prog["coalescer"], prog["pool"], prog["spans"]
    for rate in args.rates:
        mix = dict(cell.traffic, rate_per_s=rate)
        sched = traffic.schedule(mix, args.seed, args.seconds, f"sweep{rate}")
        s0, cpu0 = dict(co.stats), drv.thread_cpu()
        records, lag, callers, cpu1 = drv.open_loop(co.submit, pool, sched)
        cpu = drv.cpu_by_thread(cpu0, cpu1, spans.thread)
        ok = [r for r in records if r is not None]
        lat = sorted(r[0] for r in ok)
        tenth = max(1, len(records) // 10)
        first = [r[0] for r in records[:tenth] if r is not None]
        last = [r[0] for r in records[-tenth:] if r is not None]
        runs = co.stats["device_batches"] - s0["device_batches"]
        print(json.dumps({
            "rate": rate, "offered_poses_per_s": traffic.mean_poses_per_s(mix),
            "returned_poses_per_s": sum(sched[i][1] for i, r in enumerate(records)
                                        if r is not None and r[1] <= args.seconds)
            / args.seconds,
            "p50_ms": drv.percentile_ms(lat, 0.5), "p95_ms": drv.percentile_ms(lat, 0.95),
            "p99_ms": drv.percentile_ms(lat, 0.99),
            "backlog_ratio": (sum(last) / len(last)) / (sum(first) / len(first))
            if first and last else None,
            "requests": len(records), "answered": len(ok),
            "requests_per_run": (co.stats["merged_requests"] - s0["merged_requests"]) / runs
            if runs else None,
            "callers": callers, "cpu_s": cpu,
            "sender_lag_p95_ms": sorted(lag)[int(0.95 * (len(lag) - 1))] * 1e3}), flush=True)
    co.close()


if __name__ == "__main__":
    main()
