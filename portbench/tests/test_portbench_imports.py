"""Nothing the benchmark runs imports the JAX stack, the JAX package or the
JAX-era ``benchmarks`` (compared by whole top-level name: ``links_tpu_torch``
begins with ``links_tpu``), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import core, spec

SOURCES = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts
                 and ".scratch" not in p.parts)


def _imported_tops(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_forbidden_import(path):
    tops = _imported_tops(path)
    assert not tops & set(core.FORBIDDEN), tops & set(core.FORBIDDEN)
    if "reference" in path.parts:
        assert "links_tpu_torch" not in tops and "portbench" not in tops


def test_process_holds_no_forbidden_module():
    """Import what a run imports, runners and readers included, in a fresh
    process, and look at ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run, portbench.core as core, portbench.spec as spec\n"
        "import links_tpu_torch.cli.serve, links_tpu_torch.cli.lift, links_tpu_torch.train.loop\n"
        "import links_tpu_torch.train.steps, links_tpu_torch.ops.resblock\n"
        "b = spec.load_benchmark()\n"
        "[spec.runner(spec.cell(w['name'], b).traffic['kind']) for w in b['workloads']]\n"
        "[spec.metric_reader(m['name']) for m in b['per_layer']]\n"
        "print(core.forbidden_modules())\n") % str(spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "links_tpu_torch_x", sys)
    assert "links_tpu" not in core.forbidden_modules() or "links_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in core.forbidden_modules()
