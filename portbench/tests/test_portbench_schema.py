"""BENCHMARK.json against its schema and character rules, and discovery of every
configuration, mix, cell file and per-layer reader by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.load_benchmark()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        if "/" in word:
            assert not word.startswith("/") and ".." not in word.split("/")
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (spec.ROOT / word).exists()


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["source"].startswith("https://")
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    assert (spec.ROOT / entry["file"]).is_file()
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    conf = json.loads((spec.ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["hidden"] == 1024


def test_files_distinct_and_names_unique():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
    assert w["chips"] in (1, 4)
    cell = spec.cell(w["name"], BENCH)  # finds its configuration, mix and limits by name
    assert spec.runner(cell.traffic["kind"]).run
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_four_chip_cells_within_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


def test_setup_metric():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["source"] in SOURCES
    assert _line(m["layer"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m.get("workloads", []):
        moved = e2e[m["moves"]]
        assert cell in moved.get("workloads", [cell])  # the cell reports what it moves
    reader = spec.metric_reader(m["name"])
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == \
        (m["layer"], m["unit"], m["source"], m["moves"])
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        key = m["layer"].split(" (")[0]
        layers.setdefault(key, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_check_budget():
    """A full check of 24 cells fits: 2 + 14 x 24 runs of run_seconds + 60 s,
    2 x 90 s per cell to compile, 1200 s spare, within 43200 s."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [n for n in ("train_epochs", "serving")])
def test_runners_found_by_kind(name):
    assert hasattr(spec.runner(name), "run")


def test_files_named_from_name_characters():
    for path in spec.HERE.rglob("*"):
        if "__pycache__" in path.parts or ".scratch" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
