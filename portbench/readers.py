"""What the per-layer readers (``metrics/<name>.py``) compute, from the
readings a runner gathers: the window's counts and spans, the port's
counters over the traced stretch, and the reduced trace (``trace.Trace``).
Each returns None where it finds nothing to read (a CPU run has no device
trace), never 0."""

from __future__ import annotations

from portbench.flops import PEAK_FLOPS, is_k1_kernel, k1_least_s


def train_mfu(r: dict):
    """Model FLOPs of a step (``flops.train_step_flops``) x the window's
    steps / the window / the bf16 peak, in %."""
    if not r.get("steps"):
        return None
    return 100.0 * r["flops_per_step"] * r["steps"] / r["window_s"] / PEAK_FLOPS


def host_ms_per_step(r: dict):
    """Host ms to issue one step: the benchmark's span around each step call
    of the epoch loop (no synchronise), over the window's steps."""
    if not r.get("steps"):
        return None
    return 1e3 * r["host_step_s"] / r["steps"]


def k1_roofline(r: dict):
    """The least time of the traced K1 calls (``flops.k1_least_s``; the calls
    from the benchmark's spans, which must agree with the port's own K1
    counters) over the device time of ``ops/csrc/resblock.cu``'s kernels in
    the trace, in %."""
    tr, calls = r.get("trace"), r.get("k1_calls")
    if tr is None or not calls:
        return None
    for direction in ("forward", "backward"):
        counted = sum(n for d, _, n, _ in calls if d == direction)
        if counted != r["counters"].get(direction, 0):
            return None  # the spans' calls and the port's counters disagree
    hidden = r["config"]["hidden"]
    least = sum(n * k1_least_s(d, rows, hidden, bf16) for d, rows, n, bf16 in calls)
    device_s = sum(v[0] for k, v in tr.kernels.items() if is_k1_kernel(k))
    return 100.0 * least / device_s if device_s > 0 else None


def idle_share(r: dict):
    """1 - busy / window of the traced stretch, in %."""
    tr = r.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.device_events:
        return None  # no device trace (a CPU run) or an empty one
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def lift_mfu(r: dict):
    """The pair's pose-branch FLOPs per pose x the poses returned in the
    window / the window / the bf16 peak, in %."""
    if not r.get("poses"):
        return None
    return 100.0 * r["flops_per_pose"] * r["poses"] / r["window_s"] / PEAK_FLOPS


def requests_per_run(r: dict):
    """The dispatcher's own counters over the window: merged requests per
    device run."""
    c = r.get("coalescer")
    if not c or not c.get("device_batches"):
        return None
    return c["merged_requests"] / c["device_batches"]
