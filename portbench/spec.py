"""The benchmark as data: ``BENCHMARK.json`` at the root of the checkout and
the files it names, each found by name.

* ``configs/<config>.json``: a configuration's sizes (the file that
  ``BENCHMARK.json``'s ``configs`` entry names);
* ``traffic/<mix>.json``: a traffic mix's parameters; its ``kind`` names
  the runner (``runners/<kind>.py``) that runs the mix through the port;
* ``workloads/<cell>.json``: a cell's correctness limits;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(readings)``.

A new cell, mix or metric is a new file and a new entry; no existing file
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _reported(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    """Whether ``metric`` belongs in ``cell``'s result line: its
    ``workloads`` list names the cell; with none, an end-to-end metric is
    every cell's and a per-layer one every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and metrics."""
    bench = bench or load_benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(w['name'] for w in bench['workloads'])})")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _reported(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reported(m, name, names)]
    return Cell(name=name, chips=w["chips"], config_name=w["config"],
                config=_json(ROOT / conf["file"]), traffic_name=w["traffic"],
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer)


def runner(kind: str):
    """The module ``runners/<kind>.py``, which runs a mix of that kind."""
    return _load(HERE / "runners" / f"{kind}.py", f"portbench_runner_{kind}")


def metric_reader(name: str):
    """The module ``metrics/<name>.py``: ``read(readings) -> float | None``
    and its ``LAYER``, ``UNIT``, ``SOURCE``, ``MOVES``."""
    return _load(HERE / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_")
                 .replace("-", "_"))


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
