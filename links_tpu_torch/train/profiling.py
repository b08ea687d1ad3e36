"""Profiling instrumentation (counterpart of links_tpu/train/profiling.py).

``span(name, args)``: a named stretch of the program's host work. Every span
adds its count and wall time to a process-wide table (``totals()``), on
whichever thread it closes; while a ``torch.profiler`` session records, it
is also a ``record_function`` range named ``links.<name>``, on the same
clock as the device's kernels. The spans are the training step's phases
(``train.*``: train/steps.py, train/loop.py) and serve's dispatcher
(``serve.*``: cli/serve.py; ``lift.*``: cli/lift.py:_chunked).

``trace(dir)``: a ``torch.profiler`` session over the ``with`` block that
writes a Chrome trace (chrome://tracing, Perfetto) to ``<dir>/trace.json``;
it records the CUDA device's kernels when one is present, and every thread's
spans where the installed torch can profile all threads. ``step_time``: the
median wall time of a call, waiting for the device of its first output
tensor.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from time import perf_counter_ns

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._pytree import tree_leaves

_TOTALS: dict[str, list[int]] = {}  # name -> [count, ns]
_LOCK = threading.Lock()


class span:
    """``with span(name, args):`` adds one to ``name``'s count and the
    block's wall nanoseconds to its total. While a profiler session records
    (torch's own process-wide flag), the block is also the range
    ``links.<name>`` with ``args`` (a string) in the trace. After the block,
    ``seconds`` holds its wall time."""

    __slots__ = ("name", "args", "seconds", "_t0", "_rf")

    def __init__(self, name: str, args: str | None = None):
        self.name, self.args = name, args

    def __enter__(self):
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = record_function("links." + self.name, self.args)
            self._rf.__enter__()
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.seconds = ns / 1e9
        with _LOCK:
            total = _TOTALS.get(self.name)
            if total is None:
                _TOTALS[self.name] = [1, ns]
            else:
                total[0] += 1
                total[1] += ns
        return False


def totals() -> dict[str, tuple[int, float]]:
    """A snapshot of every span so far: ``{name: (count, seconds)}``."""
    with _LOCK:
        return {name: (n, ns / 1e9) for name, (n, ns) in _TOTALS.items()}


def _all_threads_config():
    """The profiler option that records every thread's ranges (serve's
    dispatcher is not the thread that starts the session), or None where
    the installed torch lacks it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: str = "trace"):
    """Profile the block; on exit write ``<log_dir>/trace.json``. Yields
    ``log_dir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, experimental_config=_all_threads_config()) as prof:
        yield log_dir
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


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
