"""Profiling and throughput instrumentation (counterpart of
links_tpu/train/profiling.py).

``trace(dir)``: a ``torch.profiler`` session over the ``with`` block that
writes a Chrome trace (chrome://tracing, Perfetto) to ``<dir>/trace.json``;
it records the CUDA device's kernels when one is present. ``Throughput``:
poses/s (per card) across steps. ``step_time``: the median wall time of a
call, waiting for the device of its first output tensor.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str = "trace"):
    """Profile the block; on exit write ``<log_dir>/trace.json``. Yields
    ``log_dir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class Throughput:
    """Counts poses/s across steps; divide by the card count for per card."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = n_chips
        self.reset()

    def reset(self):
        self._poses = 0
        self._t0 = time.perf_counter()

    def count(self, n_poses: int):
        self._poses += n_poses

    @property
    def poses_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._poses / dt if dt > 0 else 0.0

    @property
    def poses_per_sec_per_chip(self) -> float:
        return self.poses_per_sec / self.n_chips


def _wait(out):
    """Wait for the device of ``out``'s first tensor (none for a CPU one)."""
    first = next((t for t in tree_leaves(out) if isinstance(t, torch.Tensor)), None)
    if first is not None and first.device.type == "cuda":
        torch.cuda.synchronize(first.device)


def step_time(fn, *args, iters: int = 10, warmup: int = 2, **kw) -> float:
    """Median wall seconds of ``fn(*args, **kw)`` over ``iters`` calls after
    ``warmup``, each ending when the device of its first output tensor is
    done."""
    times = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        _wait(fn(*args, **kw))
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
