"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``links_tpu_torch``, on a machine
with as many CUDA devices as the cell asks for. It loads and warms the
cell's path (set-up), measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines on standard error).
It exits 1 and prints no result without CUDA, with too few devices, outside
such a checkout, or if the process holds a module of the JAX stack, the JAX
package or ``benchmarks`` once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 1


def metrics_of(cell, out, setup_s: float, traced: bool) -> dict:
    """The result line's metrics: end-to-end ones (``setup_s`` and the
    runner's), or with ``--trace 1`` what each per-layer reader finds."""
    from portbench import spec

    if not traced:
        values = dict(out.end_to_end, setup_s=setup_s)
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end}
    found = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"]).read(out.readings)
        if value is not None:
            found[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            print(f"portbench: {m['name']}: nothing to read", file=sys.stderr)
    return found


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import torch

        import links_tpu_torch  # noqa: F401  (the program under test)
        from portbench import core, spec
        from portbench import trace as tr_mod
        from portbench.flops import is_k1_kernel
    except ImportError as e:
        return fail(f"cannot import the program or the harness: {e}")
    if Path(links_tpu_torch.__file__).resolve().parent.parent != ROOT:
        return fail(f"the program is not in this checkout: {links_tpu_torch.__file__}")
    try:
        cell = spec.cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(str(e))
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} CUDA devices, "
                    f"{torch.cuda.device_count()} present")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    drv = spec.runner(cell.traffic["kind"])
    clock = {}
    out = drv.run(cell, args.seed, args.seconds, bool(args.trace), device, clock)
    forbidden = core.forbidden_modules()
    if forbidden:
        return fail(f"the process holds forbidden modules: {', '.join(forbidden)}")
    setup_s = clock["window_start"] - T_START
    built = ", ".join(f"{k} {v:.1f} s" for k, v in core.builds().items())
    print(f"portbench: setup_s {setup_s:.3f} s; "
          + (f"built in this run, within setup_s: {built}" if built
             else "every kernel library found built"), file=sys.stderr)
    device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                  "memory_peak_bytes": out.memory_peak_bytes}
    breakdown = None
    if args.trace:
        device_rec.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        breakdown = tr_mod.breakdown(out.trace)
        k1_seen = sum(v[1] for k, v in out.trace.kernels.items() if is_k1_kernel(k))
        print(f"portbench: profiler coverage: {k1_seen} resblock.cu kernels seen, the port's "
              f"counters launched {out.readings.get('counters', {}).get('kernels')}",
              file=sys.stderr)
    metrics = metrics_of(cell, out, setup_s, bool(args.trace))
    for note in out.notes:
        print(f"portbench: {note}", file=sys.stderr)
    for c in out.checks:
        print(f"portbench: check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(core.result_line(out, metrics, device_rec, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
