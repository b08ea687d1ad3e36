"""End-to-end slice test: ``links_tpu_torch.cli.lift`` against
``links_tpu.cli.lift`` on one synthetic pickle and one reference-layout .pt
pair, plus the port's import hygiene and chip_smoke.py's refusal to run
without a CUDA device."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from links_tpu import ckpt as jckpt
from links_tpu import models as jmodels
from links_tpu.cli import lift as jlift
from links_tpu_torch.cli import lift as tlift
from links_tpu_torch.data.synthetic import write_synthetic_pickle

REPO = Path(__file__).resolve().parents[1]
HID = 128
F32_TOL = {"rtol": 1e-6, "atol": 2e-5}
BF16_TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("lift")
    write_synthetic_pickle(ws / "synthetic.pkl", n_per_subject=8, seed=0,
                           n_test_per_subject=150)
    for seed, side in enumerate(("left", "right")):
        tree = jmodels.init_lifter(jax.random.PRNGKey(seed), 11, hidden=HID)
        jckpt.save_pt(ws / f"{side}_lifter.pt", jckpt.lifter_to_torch(tree))
    return ws


def _args(ws, name, *flags):
    return ["--data", str(ws / "synthetic.pkl"), "--left-pt", str(ws / "left_lifter.pt"),
            "--right-pt", str(ws / "right_lifter.pt"), "--batch-size", "128",
            "--out", str(ws / f"{name}.npz"), *flags]


@pytest.fixture(scope="module")
def jax_outputs(workspace):
    """links_tpu.cli.lift at --policy f32 and bf16 (no compilation cache)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", "")
        return {policy: jlift.main(_args(workspace, f"jax_{policy}", "--policy", policy))
                for policy in ("f32", "bf16")}


@pytest.mark.parametrize("flags,reference,tol", [
    ([], "f32", F32_TOL),
    (["--policy", "bf16"], "bf16", BF16_TOL),
    (["--fused"], "bf16", BF16_TOL),
    (["--fused", "--choice", "right", "--depth", "10.0"], "bf16", BF16_TOL),
])
def test_port_lift_matches_jax_lift(workspace, jax_outputs, capsys, flags, reference, tol):
    got = tlift.main(_args(workspace, "port", "--device", "cpu", *flags))
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["poses"] == 300 and summary["mode"] == "left_right"
    assert set(summary) == {"poses", "batch", "mode", "quant", "scenario", "seconds",
                            "poses_per_sec", "out"}
    with np.load(workspace / "port.npz") as z:
        assert z["poses_3d"].shape == (300, 3, 17)
        np.testing.assert_array_equal(z["poses_3d"], got)
        assert z["poses_2d"].shape == (300, 34)
    np.testing.assert_allclose(got, jax_outputs[reference], **tol)


def test_raw_2d_and_limit(workspace, jax_outputs, tmp_path):
    with np.load(workspace / "jax_f32.npz") as z:
        p2d = z["poses_2d"]
    raw = tmp_path / "raw.npy"
    np.save(raw, p2d.reshape(-1, 2, 17))
    got = tlift.main(_args(workspace, "raw", "--device", "cpu", "--raw-2d", str(raw),
                           "--limit", "77"))
    np.testing.assert_allclose(got, jax_outputs["f32"][:77], **F32_TOL)


@pytest.mark.parametrize("flags,message", [
    (["--scenario", "ll", "--quant", "int8-static"], "int8-static calibrates the plain"),
    (["--fused", "--quant", "int8"], "--fused and --quant are mutually exclusive"),
    (["--fused", "--mode", "leg_torso"], "left_right forward only"),
])
def test_refused_flags(workspace, flags, message):
    with pytest.raises(SystemExit, match=message):
        tlift.main(_args(workspace, "refused", "--device", "cpu", *flags))


def test_model_dir_pair_is_the_fallback(workspace, tmp_path):
    args = ["--data", str(workspace / "synthetic.pkl"), "--model-dir", str(workspace),
            "--device", "cpu", "--limit", "5", "--out", str(tmp_path / "o.npz")]
    assert tlift.main(args).shape == (5, 3, 17)
    with pytest.raises(FileNotFoundError, match="left_lifter.pt"):
        tlift.main(args[:2] + ["--model-dir", str(tmp_path)] + args[4:])


_IMPORT_ALL = """
import importlib, pkgutil, sys
import links_tpu_torch
names = [m.name for m in pkgutil.walk_packages(links_tpu_torch.__path__, "links_tpu_torch.")]
assert {"links_tpu_torch.cli.eval_h36m", "links_tpu_torch.cli.run_pipeline",
        "links_tpu_torch.ckpt.run_io", "links_tpu_torch.cli.export_model",
        "links_tpu_torch.cli.pack_data", "links_tpu_torch.ckpt.export_io",
        "links_tpu_torch.data.native_loader", "links_tpu_torch.train.feed"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "links_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 30 and bad.strip() == "[]"


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
