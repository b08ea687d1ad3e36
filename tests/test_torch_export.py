"""The serving artifact of links_tpu_torch (ckpt/export_io.py,
cli/export_model.py, ``serve --artifact``) on the CPU.

The same seeded weights (hidden 128) are written once for both packages:
reference ``.pt`` files for the port, and for the JAX package the ``.pt``
side-lifter pair and orbax artifacts of the legs and torso lifters and the
completers. Each package's ``export_model`` exports them, and both artifacts
are called on the same numpy-seeded probes. The port's artifact is also held
bitwise against its live ``lift``, its graph is checked to hold one
registered residual-block op per block, and ``serve --artifact`` is driven
as tests/test_serve.py drives the JAX package's."""

import contextlib
import io
import json
import shutil
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from links_tpu import ckpt as jckpt
from links_tpu import models as jmodels
from links_tpu.cli import export_model as jexport
from links_tpu_torch import ckpt as tckpt
from links_tpu_torch.cli import export_model as texport
from links_tpu_torch.cli import lift as tlift
from links_tpu_torch.cli import serve as tserve
from links_tpu_torch.ckpt.torch_io import save_lifter_pt
from links_tpu_torch.models.completers import COMPLETER_SPECS
from links_tpu_torch.models.lifters import Lifter

from test_torch_quant import _close as _hold_int8_rows

HID = 128
F32_TOL = {"rtol": 1e-5, "atol": 1e-5}
# the port's stated bf16 tolerance against JAX (tests/test_torch_lifters.py:
# BF16_TOL): the packages sum in different orders, which can flip a bf16
# rounding of a hidden activation (5.1e-4 on a camera-frame z of 12.9 seen)
BF16_TOL = {"rtol": 1e-4, "atol": 1e-4}
LIFTERS = {"left": 11, "right": 11, "legs": 7, "torso": 10}
OP = "links_tpu_torch.res_block_forward"
# case -> (export flags, probe batches, tolerance against the JAX artifact:
# a dict, or "int8" for the int8 rounding-flip rule of tests/test_torch_quant.py)
CASES = {
    "left_right": ([], (1, 7, 64), F32_TOL),
    "batch8": (["--batch", "8"], (8,), F32_TOL),
    "leg_torso": (["--mode", "leg_torso"], (1, 7, 64), F32_TOL),
    "scenario_ll": (["--scenario", "ll"], (1, 7, 64), F32_TOL),
    "int8": (["--quant", "int8"], (1, 7, 64), "int8"),
    "bf16": (["--policy", "bf16"], (1, 7, 64), BF16_TOL),
}
# registered residual-block ops in each program: 7 blocks per lifter; a
# scenario lifts with all four lifters and runs one completer's 3 blocks; a
# quantized block composes its int8 linears
OPS = {"left_right": 14, "batch8": 14, "leg_torso": 14, "scenario_ll": 4 * 7 + 3, "int8": 0,
       "bf16": 14}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """One model directory holding the seeded weights in both packages'
    layouts."""
    ws = tmp_path_factory.mktemp("export")
    keys = jax.random.split(jax.random.PRNGKey(11), 1 + len(LIFTERS))
    trees = {name: jmodels.init_lifter(k, j, hidden=HID)
             for k, (name, j) in zip(keys[1:], LIFTERS.items())}
    completers = jmodels.init_all_completers(keys[0], hidden=HID)
    for name, f in (("left", "left_lifter.pt"), ("right", "right_lifter.pt"),
                    ("legs", "leg_lifter.pt"), ("torso", "torso_lifter.pt")):
        jckpt.save_pt(ws / f, jckpt.lifter_to_torch(trees[name]))
    (ws / "occlusion_model_weights").mkdir()
    for name in COMPLETER_SPECS:
        jckpt.save_pt(ws / "occlusion_model_weights" / f"{name}_estimator.pt",
                      jckpt.completer_to_torch(completers[name]))
    for name, params in (("lifter_legs", trees["legs"]), ("lifter_torso", trees["torso"]),
                         ("occlusion_models", completers)):
        jckpt.save_checkpoint(ws / name, {"params": params})
    return ws


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


def _port_export(models, out, *flags):
    return _quiet(texport.main, ["--model-dir", str(models), "--out", str(out), "--device",
                                 "cpu", "--platforms", "cpu", *flags])


@pytest.fixture(scope="module")
def exported(models, tmp_path_factory):
    """case -> (path, summary) of the port's artifact, exported once."""
    out_dir, done = tmp_path_factory.mktemp("artifacts"), {}

    def get(case):
        if case not in done:
            path = out_dir / f"{case}.pt2"
            done[case] = path, _port_export(models, path, *CASES[case][0])
        return done[case]

    return get


def _probe(n, seed):
    p = np.random.default_rng(seed).normal(size=(n, 34)).astype(np.float32)
    p[:, 0] = 0.0
    return p


@pytest.mark.parametrize("case", list(CASES))
def test_port_artifact_matches_the_jax_artifact(models, exported, tmp_path, monkeypatch, case):
    """Both packages' export_model on the same weights; both artifacts load,
    verified, and agree on the same probes at each batch."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    flags, batches, tol = CASES[case]
    path, summary = exported(case)
    jpath = tmp_path / "jax.stablehlo"
    jsummary = _quiet(jexport.main, ["--model-dir", str(models), "--out", str(jpath),
                                     "--platforms", "cpu", *flags])
    assert summary["verified"] is True and jsummary["verified"] is True
    assert summary["batch"] == jsummary["batch"] and summary["platforms"] == ["cpu"]
    assert set(summary) == set(jsummary)
    served, jserved = tckpt.load_exported(path, "cpu"), jckpt.load_exported(str(jpath))
    for n in batches:
        probe = _probe(n, seed=n)
        got = served(torch.from_numpy(probe)).numpy()
        want = np.asarray(jserved(probe))
        assert got.shape == want.shape == (n, 51)
        if tol == "int8":
            _hold_int8_rows(got, want, f"{case} B={n}")
        else:
            np.testing.assert_allclose(got, want, **tol, err_msg=f"{case} B={n}")


@pytest.mark.parametrize("case", ["left_right", "leg_torso", "scenario_ll", "int8", "bf16"])
def test_artifact_is_bitwise_the_live_lift(models, exported, tmp_path, case):
    """The loaded artifact and ``lift`` with the same flags give the same
    bits (each chunk of the lift is one call of the same forward)."""
    path, _ = exported(case)
    probe = _probe(37, seed=3)
    np.save(tmp_path / "p.npy", probe)
    want = _quiet(tlift.main, ["--model-dir", str(models), "--device", "cpu", "--raw-2d",
                               str(tmp_path / "p.npy"), "--out", str(tmp_path / "o.npz"),
                               *CASES[case][0]])
    got = tckpt.load_exported(path, "cpu")(torch.from_numpy(probe)).numpy()
    np.testing.assert_array_equal(got.reshape(37, 3, 17), want)


@pytest.mark.parametrize("case", list(OPS))
def test_exported_graph_runs_the_registered_residual_block_op(exported, case):
    """One links_tpu_torch::res_block_forward node per residual block."""
    path, _ = exported(case)
    program = tckpt.deserialize_exported(path, "cpu").program
    ops = [n for n in program.graph.nodes if n.op == "call_function" and str(n.target)
           .startswith(OP)]
    assert len(ops) == OPS[case]


def test_inspect_gives_the_jax_keys(models, exported, tmp_path, monkeypatch):
    """--inspect prints JAX's keys, the torch version standing in for the
    calling convention's; the symbolic batch reads 'b'."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    path, summary = exported("left_right")
    info = _quiet(texport.main, ["--inspect", str(path)])
    jpath = tmp_path / "jax.stablehlo"
    _quiet(jexport.main, ["--model-dir", str(models), "--out", str(jpath), "--platforms", "cpu",
                          "--no-verify"])
    jinfo = _quiet(jexport.main, ["--inspect", str(jpath)])
    assert set(info) == set(jinfo) - {"calling_convention_version"} | {"torch_version"}
    assert info["torch_version"] == torch.__version__ and info["bytes"] == summary["bytes"]
    assert info["platforms"] == ["cpu"] and info["inputs"] == ["float32[b,34]"]
    assert info["outputs"] == summary["outputs"] == ["float32[b,51]"]
    fixed = _quiet(texport.main, ["--inspect", str(exported("batch8")[0])])
    assert fixed["inputs"] == ["float32[8,34]"]


def test_fixed_batch_artifact_refuses_other_batches(exported):
    served = tckpt.load_exported(exported("batch8")[0], "cpu")
    assert served(torch.from_numpy(_probe(8, 0))).shape == (8, 51)
    with pytest.raises(Exception):
        served(torch.from_numpy(_probe(4, 0)))


def test_mlir_out_writes_the_program(models, tmp_path):
    summary = _port_export(models, tmp_path / "a.pt2", "--batch", "8", "--no-verify",
                           "--mlir-out", str(tmp_path / "a.txt"))
    text = (tmp_path / "a.txt").read_text()
    assert summary["verified"] is None
    assert text.count("torch.ops." + OP) == 14 and "8, 34" in text


def test_int8_artifact_is_a_third_of_the_f32_one(tmp_path):
    """At the lifters' width (hidden 1024) the int8 artifact holds a quarter
    of the f32 weight bytes: under 0.35 of the f32 file, as the JAX package's
    end-to-end test asserts of its artifacts."""
    g = torch.Generator().manual_seed(0)
    for side in ("left", "right"):
        save_lifter_pt(Lifter(11, generator=g), tmp_path / f"{side}_lifter.pt")
    f32 = _port_export(tmp_path, tmp_path / "f32.pt2")
    int8 = _port_export(tmp_path, tmp_path / "int8.pt2", "--quant", "int8")
    shutil.rmtree(tmp_path)  # ~150 MB
    assert f32["verified"] and int8["verified"]
    assert f32["bytes"] > 50_000_000 and int8["bytes"] < 0.35 * f32["bytes"]


@pytest.mark.parametrize("flags,message", [
    (["--fused"], "--fused is a live-serving option"),
    (["--scenario", "ll", "--quant", "int8-static"], "--quant int8-static calibrates"),
    ([], "--out is required"),
    (["--platforms", "cuda"], "--platforms cuda does not name cpu"),
])
def test_export_refuses(models, tmp_path, flags, message):
    argv = ["--model-dir", str(models), "--device", "cpu", *flags]
    if message != "--out is required":
        argv += ["--out", str(tmp_path / "x.pt2")]
    with pytest.raises(SystemExit, match=message):
        texport.main(argv)
    assert not (tmp_path / "x.pt2").exists()


def test_artifact_refuses_a_device_its_platforms_do_not_name(models, tmp_path):
    """An artifact exported for the card alone is refused on the CPU, as a
    JAX artifact refuses a platform it was not lowered for; --inspect still
    reads it."""
    path = tmp_path / "cuda.pt2"
    _quiet(texport.main, ["--model-dir", str(models), "--out", str(path), "--device", "cpu",
                          "--platforms", "cuda", "--no-verify"])
    assert tckpt.exported_info(path)["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match=r"exported for platforms \['cuda'\], not cpu"):
        tckpt.load_exported(path, "cpu")


@contextlib.contextmanager
def _server(*flags):
    args = tserve.build_parser().parse_args(["--port", "0", "--device", "cpu", *flags])
    srv = tserve.make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    try:
        yield f"http://{host}:{port}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)
    assert not thread.is_alive()


def _post(url, data: bytes, content_type: str):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _health(base):
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        return json.loads(resp.read())


def test_serve_artifact_json_and_npy(exported):
    """A JSON and a .npy ((N, 2, 17)) request answered with the artifact's
    own output; /healthz names the artifact, its platforms and inputs."""
    path, _ = exported("left_right")
    poses = _probe(5, seed=5) * 0.1
    want = tckpt.load_exported(path, "cpu")(torch.from_numpy(poses)).numpy().reshape(5, 3, 17)
    with _server("--artifact", str(path)) as base:
        health = _health(base)
        assert health["ok"] and health["model"]["artifact"] == str(path)
        assert health["model"]["platforms"] == ["cpu"]
        assert health["model"]["inputs"] == ["float32[b,34]"] and health["batch"] == 256
        out = _post(base + "/lift", json.dumps({"poses_2d": poses.tolist()}).encode(),
                    "application/json")
        assert out["count"] == 5 and out["ms"] >= 0
        np.testing.assert_array_equal(np.asarray(out["poses_3d"], np.float32), want)
        buf = io.BytesIO()
        np.save(buf, poses.reshape(5, 2, 17))
        out2 = _post(base + "/lift", buf.getvalue(), "application/octet-stream")
        np.testing.assert_array_equal(np.asarray(out2["poses_3d"], np.float32), want)
        health = _health(base)
    assert health["requests"] == 2 and health["poses"] == 10 and health["errors"] == 0


def test_serve_fixed_batch_artifact(exported):
    """A pinned-batch artifact sets the chunk size; a request of another size
    is padded through it and answered with the symbolic artifact's rows."""
    path, _ = exported("batch8")
    poses = _probe(13, seed=6) * 0.1
    want = tckpt.load_exported(exported("left_right")[0], "cpu")(torch.from_numpy(poses))
    with _server("--artifact", str(path), "--batch-size", "64") as base:
        assert _health(base)["batch"] == 8
        out = _post(base + "/lift", json.dumps({"poses_2d": poses.tolist()}).encode(),
                    "application/json")
    assert out["count"] == 13
    np.testing.assert_allclose(np.asarray(out["poses_3d"], np.float32),
                               want.numpy().reshape(13, 3, 17), **F32_TOL)


def test_serve_artifact_warns_of_ignored_flags(exported, capsys):
    path, _ = exported("left_right")
    with _server("--artifact", str(path), "--quant", "int8", "--mode", "leg_torso", "--policy",
                 "bf16", "--no-warmup") as base:
        assert _health(base)["model"]["artifact"] == str(path)
    err = capsys.readouterr().err
    assert "--quant --mode --policy ignored" in err
