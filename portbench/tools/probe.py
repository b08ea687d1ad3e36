"""Busy share of the training cells' step at several batches, on the card.

    python3 portbench/tools/probe.py [--batches 4096 8192 16384] [--cells lr3a-train occ4-train]

For each cell and batch: one warm epoch over a pool of 4 batches, then one
more under the profiler. Prints one JSON line per (cell, batch): host ms per
step (the epoch's wall time over its steps), the kernels' busy share of the
traced epoch, the number of device events, and the peak allocated bytes.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench import spec, trace  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=int, nargs="+", default=[4096, 8192, 16384])
    p.add_argument("--cells", nargs="+", default=["lr3a-train", "occ4-train"])
    p.add_argument("--seed", type=int, default=3)
    args = p.parse_args()
    from links_tpu_torch.cli import _common as C

    dev = C.resolve_device("cuda")
    drv = spec.runner("train_epochs")
    for name in args.cells:
        for b in args.batches:
            cell = copy.deepcopy(spec.cell(name))
            cell.traffic.update(batch=b, pool_batches=4)
            torch.cuda.reset_peak_memory_stats()
            prog = drv.build(cell, args.seed, dev)
            drv.epoch(prog)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv.epoch(prog)
            step_ms = (time.perf_counter() - t0) / 4 * 1e3
            tr = trace.traced(lambda: drv.epoch(prog))
            print(json.dumps({"cell": name, "batch": b, "step_ms": step_ms,
                              "busy_share": tr.busy_s / tr.window_s,
                              "traced_step_ms": tr.window_s / 4 * 1e3,
                              "device_events": tr.device_events,
                              "poses_per_s": b / step_ms * 1e3,
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "top": trace.breakdown(tr, 5)}), flush=True)
            del prog
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
