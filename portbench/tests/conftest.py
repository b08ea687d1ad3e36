"""Fixtures of the benchmark's CPU tests: cells cut to a size a test run
holds (hidden 256, training batches of 128, slow open-loop mixes), run on
the CPU with the kernels' plain versions."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402


def small_cell(name: str, hidden: int = 256, open_loop: bool = False):
    """The cell ``name`` at hidden ``hidden``, with small batches and mixes;
    ``open_loop``: a serving cell's mix as open-loop arrivals at a fixed
    rate instead of its callers' closed loop."""
    cell = copy.deepcopy(spec.cell(name))
    if open_loop:
        cell.traffic.pop("callers")
    cell.config["hidden"] = hidden
    if "flow_hidden" in cell.config:
        cell.config["flow_hidden"] = hidden
    if cell.traffic["kind"] == "train_epochs":
        cell.traffic.update(batch=128, pool_batches=4)
    else:
        cell.traffic.update(pool_poses=8192, min_poses=8, max_poses=256, batch_size=512,
                            check_requests=8, trace_s=0.5, settle_s=30.0)
        if "callers" in cell.traffic:
            cell.traffic.update(callers=4, check_span=32)
        else:
            cell.traffic.update(rate_per_s=40.0)
    return cell


@pytest.fixture
def cells():
    return spec.load_benchmark()["workloads"]
