"""What every runner shares: the outcome of a run, seeds, checks, the device
record and the result line."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import sys

# top-level module names that no process of the benchmark may hold once the
# window has closed: the JAX stack, the JAX package and the JAX-era benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "links_tpu", "benchmarks")


def derive(seed: int, what: str) -> int:
    """A 63-bit seed for one use (weights, data, steps, traffic) of ``seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """One run of one cell: its end-to-end values, what the per-layer
    readers read, the checks that decide ``correct``, and the device."""

    attempted: int
    failed: int
    end_to_end: dict
    readings: dict
    checks: list
    memory_peak_bytes: int = 0
    trace: object = None  # a trace.Trace of the traced stretch, with --trace 1
    notes: list = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


def gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds, by whole name."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def builds() -> dict:
    """{library: seconds} of the kernel libraries this process built (the
    port's own build log); empty where every one was found built."""
    from links_tpu_torch.ops import _build

    return {name: sec for name, (sec, _) in getattr(_build, "BUILD_LOG", {}).items()}


def result_line(out: Outcome, metrics: dict, device: dict, breakdown: dict | None) -> str:
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return json.dumps(line)
