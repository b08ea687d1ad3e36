"""Stage 5 of links_tpu_torch against links_tpu on the CPU: the metrics
(``get_all`` with both CPS variants, ``procrustes_batch``, ``pmpjpe_batch``,
``mpjpe_single``), the keypoint-dropout poses, the --from-detections plan,
and ``links_tpu_torch.cli.eval_h36m`` on one model directory against
``links_tpu.cli.eval_h36m`` on the same pickle and weights (the port reads
its ``.pt`` files; the JAX package reads orbax artifacts written from
them)."""

import argparse
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import ckpt as jckpt
from links_tpu import metrics as jm
from links_tpu import models as jmodels
from links_tpu.cli import _common as J
from links_tpu.cli import eval_h36m as jeval
from links_tpu.core import nn as jnn
from links_tpu.objectives import occlusion as jocc
from links_tpu_torch import metrics as tm
from links_tpu_torch.cli import _common as C
from links_tpu_torch.cli import eval_h36m as teval
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.data.synthetic import write_synthetic_pickle
from links_tpu_torch.models.completers import COMPLETER_SPECS
from links_tpu_torch.objectives import occlusion as tocc
from test_torch_occlusion import (  # noqa: F401  (models: a fixture)
    BF16_TOL,
    F32_TOL,
    SCENARIO_BF16_SHARE,
    SCENARIO_BF16_TOL,
    _port_completers,
    _port_lifters,
    models,
)
from test_torch_train_step import _poses

HID = 64
# the CLI's f32 results: sums in another order through 7 + 3 blocks and a 3x3
# SVD per pose
CLI_RTOL = 1e-4
# metrics of the same f32 poses in mm (values up to ~1000): only the
# reductions' order differs, a few f32 ulps
METRIC_TOL = {"rtol": 1e-5, "atol": 1e-3}
# the thresholded metrics are counts: equal on the same f32 inputs
COUNTED = ("PCK", "AUC", "CPS", "CPS_correct")


def _pose_pair(seed: int, n: int = 257):
    """(n, 51) ground truth in mm and a noisy, rotated, rescaled prediction."""
    rng = np.random.default_rng(seed)
    gt = (rng.normal(size=(n, 3, 17)) * 200.0).astype(np.float32)
    theta = rng.uniform(-0.5, 0.5, size=n)
    rot = np.zeros((n, 3, 3))
    rot[:, 0, 0] = rot[:, 2, 2] = np.cos(theta)
    rot[:, 0, 2], rot[:, 2, 0] = np.sin(theta), -np.sin(theta)
    rot[:, 1, 1] = 1.0
    pred = 0.9 * np.einsum("nij,njk->nik", rot, gt) + rng.normal(size=gt.shape) * 40.0
    return gt.reshape(n, 51), pred.astype(np.float32).reshape(n, 51)


@pytest.mark.parametrize("use_scaling", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_all_matches_jax(seed, use_scaling):
    gt, pred = _pose_pair(seed)
    want = jm.get_all(jnp.asarray(gt), jnp.asarray(pred), use_scaling=use_scaling)
    got = tm.get_all(torch.from_numpy(gt), torch.from_numpy(pred), use_scaling=use_scaling)
    assert list(got) == list(want)
    np.testing.assert_allclose(float(got["MPJPE"]), float(want["MPJPE"]), rtol=1e-5)
    for k in COUNTED:
        assert float(got[k]) == float(want[k]), k
    assert 0.0 < float(got["CPS"]) < float(got["CPS_correct"])


@pytest.mark.parametrize("use_reflection", [False, True])
def test_procrustes_and_pmpjpe_match_jax(use_reflection):
    gt, pred = _pose_pair(3)
    g3, p3 = gt.reshape(-1, 3, 17), pred.reshape(-1, 3, 17)
    want = jm.procrustes_batch(jnp.asarray(p3), jnp.asarray(g3), use_reflection=use_reflection)
    got = tm.procrustes_batch(torch.from_numpy(p3), torch.from_numpy(g3),
                              use_reflection=use_reflection)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **METRIC_TOL)
    np.testing.assert_allclose(
        tm.pmpjpe_batch(torch.from_numpy(gt), torch.from_numpy(pred), use_reflection).numpy(),
        np.asarray(jm.pmpjpe_batch(jnp.asarray(gt), jnp.asarray(pred), use_reflection)),
        **METRIC_TOL)


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("mean_align", [False, True])
def test_mpjpe_single_matches_jax(scale, mean_align):
    gt, pred = _pose_pair(5, n=1)
    g, p = gt.reshape(3, 17), pred.reshape(3, 17)
    np.testing.assert_allclose(
        float(tm.mpjpe_single(torch.from_numpy(g), torch.from_numpy(p), scale, mean_align)),
        float(jm.mpjpe_single(jnp.asarray(g), jnp.asarray(p), scale, mean_align)), rtol=1e-5)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_dropout_eval_poses_match_jax(models, policy):  # noqa: F811
    trees, lifters = models
    poses = _poses(16, seed=41)
    want = jocc.dropout_eval_poses(trees, lifters, jnp.asarray(poses), 10.0,
                                   getattr(jnn, policy), choice="right")
    with torch.no_grad():
        got = tocc.dropout_eval_poses(_port_completers(trees), _port_lifters(lifters),
                                      torch.from_numpy(poses), 10.0, getattr(tnn, policy),
                                      "right")
    assert list(got) == list(want) == list(tocc.DROPOUT_SCENARIO_JOINTS)
    for name, pair in got.items():
        for which, g, w in zip(("recovered", "naive"), pair, want[name]):
            g, w = g.numpy(), np.asarray(w)
            msg = f"{name} {which}"
            if policy == "F32":
                np.testing.assert_allclose(g, w, err_msg=msg, **F32_TOL)
                continue
            # held as the occlusion tests hold bf16 scenario poses
            np.testing.assert_allclose(g, w, err_msg=msg, **SCENARIO_BF16_TOL)
            assert (np.abs(g - w) > BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(w)).mean() \
                < SCENARIO_BF16_SHARE, msg


def test_detection_plan():
    """Smallest covering scenario, else the smallest covering pair (in the
    JAX package's order), else none (a lost root)."""
    missing = np.zeros((6, 17), dtype=bool)
    for row, joints in ((1, [5]), (2, [5, 12]), (3, [2, 12]), (4, [0]), (5, [1, 8, 16])):
        missing[row, joints] = True
    names, _, assigned, composed = teval.detection_plan(missing)
    assert names[:4] == ["ll", "rl", "la", "ra"] and names[-1] == "torso"
    assert list(assigned) == ["", "ll", "left", "", "", ""]
    assert composed == [(3, "rl", "la"), (5, "rl", "torso")]


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """One synthetic pickle with detector keypoints; seeded lifters and
    completers at hidden HID written as the port's trainers name them, and a
    JAX model directory holding the same weights: the left/right pair as a
    reference .pt pair, the legs/torso lifters and the completers as orbax
    artifacts made from the port's files."""
    ws = tmp_path_factory.mktemp("eval")
    write_synthetic_pickle(ws / "synthetic.pkl", n_per_subject=8, seed=0,
                           n_test_per_subject=60)
    port, jdir = ws / "port", ws / "jax"
    (port / "occlusion_model_weights").mkdir(parents=True)
    jdir.mkdir()
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    files = {"left_side_lifter_final.pt": 11, "right_side_lifter_final.pt": 11,
             "leg_lifter.pt": 7, "torso_lifter.pt": 10}
    for k, (name, joints) in zip(keys, files.items()):
        jckpt.save_pt(port / name, jckpt.lifter_to_torch(
            jmodels.init_lifter(k, joints, hidden=HID)))
    for name, tree in jmodels.init_all_completers(keys[-1], hidden=HID).items():
        jckpt.save_pt(port / "occlusion_model_weights" / f"{name}_estimator.pt",
                      jckpt.completer_to_torch(tree))
    for side in ("left", "right"):
        (jdir / f"{side}_lifter.pt").write_bytes(
            (port / f"{side}_side_lifter_final.pt").read_bytes())
    for name, pt in (("lifter_legs", "leg_lifter.pt"), ("lifter_torso", "torso_lifter.pt")):
        jckpt.save_checkpoint(jdir / name, {"params": jckpt.load_lifter_pt(port / pt)})
    jckpt.save_checkpoint(jdir / "occlusion_models", {"params": {
        name: jckpt.load_completer_pt(port / "occlusion_model_weights" / f"{name}_estimator.pt")
        for name in COMPLETER_SPECS}})
    return ws, port, jdir


EVAL_CASES = {
    "left_right": [],
    "leg_torso": ["--mode", "leg_torso"],
    "occlusion": ["--occlusion", "--dropout", "--from-detections", "--no-gt-2d"],
}


def _eval(main, ws, model_dir, flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = main(["--data", str(ws / "synthetic.pkl"), "--model-dir", str(model_dir),
                        "--json", *flags])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == results
    return results


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_cli_matches_jax(model_dirs, case, monkeypatch):
    """Every key the JAX eval prints, values within CLI_RTOL, counts equal."""
    ws, port, jdir = model_dirs
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    want = _eval(jeval.main, ws, jdir, EVAL_CASES[case])
    got = _eval(teval.main, ws, port, [*EVAL_CASES[case], "--device", "cpu"])
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str) or k.startswith(("det_n_", "det_frames", "det_uncovered",
                                              "det_root", "det_unserved")):
            assert g == w and type(g) is type(w), k
        else:
            assert np.isfinite(g), k
            np.testing.assert_allclose(g, w, rtol=CLI_RTOL, err_msg=k)
    if case == "occlusion":
        assert got["det_n_composed"] > 0 and got["det_frames"] == 120
        assert {f"pa_{s}" for s in tocc.DROPOUT_SCENARIO_JOINTS} <= set(got)
        assert {f"dropout_naive_pa_{s}" for s in tocc.DROPOUT_SCENARIO_JOINTS} <= set(got)


def test_eval_prints_the_jax_text(model_dirs, capsys):
    ws, port, _ = model_dirs
    results = teval.main(["--data", str(ws / "synthetic.pkl"), "--model-dir", str(port),
                          "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"The PA-MPJPE error was {results['pa_mpjpe']}"
    assert lines[1] == f"The N-MPJPE error was {results['n_mpjpe']}"
    assert f"mpjpe: {results['mpjpe']:.4f} [unscaled reconstruction units, not mm]" in lines
    assert len(lines) == 2 + 5  # cps, cps_correct, mpjpe, pck, auc


@pytest.mark.parametrize("flags,message", [
    (["--quant", "int4"], "argument --quant: invalid choice: 'int4'"),
    (["--from-detections"], "--from-detections needs --no-gt-2d"),
])
def test_eval_refuses(model_dirs, capsys, flags, message):
    """What eval refuses, as the JAX package's eval does: a --quant scheme
    other than int8 and int8-static (argparse's message on stderr), and
    --from-detections without --no-gt-2d."""
    ws, port, _ = model_dirs
    with pytest.raises(SystemExit) as refused:
        teval.main(["--data", str(ws / "synthetic.pkl"), "--model-dir", str(port), "--device",
                    "cpu", *flags])
    assert message in f"{refused.value}\n{capsys.readouterr().err}"


@pytest.mark.parametrize("flags", [
    [], ["--no-gt-2d"], ["--no-gt-2d", "--keep-incomplete"], ["--test-scale", "auto"],
    ["--no-gt-2d", "--test-scale", "auto"], ["--test-scale", "150.5"]])
def test_data_options_match_jax(model_dirs, flags):
    """--no-gt-2d, --keep-incomplete and --test-scale select and normalize the
    test split as the JAX package's loaders do."""
    ws = model_dirs[0]
    argv = ["--data", str(ws / "synthetic.pkl"), *flags]
    jparser = J.add_common_flags(argparse.ArgumentParser())
    got = C.load_test(teval.build_parser().parse_args(argv))
    want = J.load_test(jparser.parse_args(argv))
    assert got.poses_2d.shape[0] == want.poses_2d.shape[0] == got.poses_3d.shape[0]
    np.testing.assert_allclose(got.poses_2d.numpy(), np.asarray(want.poses_2d), **F32_TOL)
    np.testing.assert_array_equal(got.poses_3d.numpy(), np.asarray(want.poses_3d))
    assert got.use_gt == ("--no-gt-2d" not in flags)
    if flags == ["--no-gt-2d"]:
        assert got.poses_2d.shape[0] < 120  # the incomplete frames dropped
