"""The result line: the keys and their order, ``checks`` last, the
metrics a cell reports with and without ``--trace``, and the refusals
(no CUDA; a directory holding only the benchmark) with no result line."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import small_cell

from portbench import core, spec
from portbench import run as run_mod

CPU = torch.device("cpu")


def test_result_line_keys_and_order():
    out = core.Outcome(attempted=3, failed=0, end_to_end={}, readings={},
                       checks=[core.Check("loss_gap", 1e-4, 1e-2)])
    line = json.loads(core.result_line(
        out, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 10}, {"device_ops": [], "idle_gaps": []}))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["correct"] is True
    assert line["checks"] == {"loss_gap": {"value": 1e-4, "limit": 1e-2}}


def test_incorrect_when_a_check_fails_or_an_answer_is_missing():
    bad = core.Outcome(1, 0, {}, {}, [core.Check("g", 2.0, 1.0)])
    assert not bad.correct
    nan = core.Outcome(1, 0, {}, {}, [core.Check("g", float("nan"), 1.0)])
    assert not nan.correct
    missing = core.Outcome(1, 1, {}, {}, [core.Check("g", 0.0, 1.0)])
    assert not missing.correct
    assert not core.Outcome(1, 0, {}, {}, []).correct


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_metrics_of_a_cell(name):
    """End-to-end metrics untraced; with the trace, every per-layer reader
    that finds something (a CPU run has no device trace to read)."""
    cell = small_cell(name)
    out = spec.runner(cell.traffic["kind"]).run(cell, 21, 0.3, True, CPU, {})
    e2e = run_mod.metrics_of(cell, out, 4.2, False)
    assert set(e2e) == {m["name"] for m in cell.end_to_end}
    assert e2e["setup_s"] == {"value": 4.2, "unit": "s"}
    assert all(v["value"] > 0 for v in e2e.values())
    layered = run_mod.metrics_of(cell, out, 4.2, True)
    assert set(layered) <= {m["name"] for m in cell.per_layer}
    host = {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
    assert host and set(layered) == host  # no device trace on the CPU to read


def _run(args, cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


ARGS = ["--workload", "lr3a-train", "--seed", str(2 ** 31 + 1), "--seconds", "1",
        "--trace", "0"]


def test_no_cuda_no_result():
    out = _run(ARGS, spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".scratch"))
    out = _run(ARGS, tmp_path)
    assert out.returncode != 0 and out.stdout == ""
