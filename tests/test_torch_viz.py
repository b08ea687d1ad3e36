"""The visualisation slice of links_tpu_torch against links_tpu on the CPU:
each of links_tpu's tests/test_viz.py cases has a counterpart here that
compares data, not pixels (the 32-slot buffer, the plotted line data, the
aligned prediction and its PA-MPJPE, the occlusion panels of every
scenario, the video clips' aligned sequences, the flow samples of one
standard-normal draw), plus ``links_tpu_torch.cli.visualise`` in every
mode, its PA-MPJPE line against ``links_tpu.cli.visualise`` on one ``.pt``
pair, its refusal without matplotlib, and ``dropout_eval_poses`` on one
scenario. Both packages get the same weights (``*_params_from_jax``)."""

import contextlib
import io
import re
import sys

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from _torch_suite import one_cpu_thread  # noqa: E402, F401  (an autouse fixture)
from links_tpu import ckpt as jckpt  # noqa: E402
from links_tpu import flows as jflows  # noqa: E402
from links_tpu import metrics as jm  # noqa: E402
from links_tpu import viz as jviz  # noqa: E402
from links_tpu.cli import visualise as jvisualise  # noqa: E402
from links_tpu.core.skeleton import split_data_left_right  # noqa: E402
from links_tpu.data import generate_poses  # noqa: E402
from links_tpu.flows import sequence as jsequence  # noqa: E402
from links_tpu.objectives import lift_left_right_eval as jlift  # noqa: E402
from links_tpu.objectives import occlusion as jocc  # noqa: E402
from links_tpu.viz import prediction as jprediction  # noqa: E402
from links_tpu.viz import skeletons as jskeletons  # noqa: E402
from links_tpu_torch import viz  # noqa: E402
from links_tpu_torch.ckpt.torch_io import (  # noqa: E402
    flow_from_state_dict,
    flow_params_from_jax,
    lifter_from_state_dict,
    lifter_params_from_jax,
    save_completer_pt,
    save_flow_pt,
    save_lifter_pt,
)
from links_tpu_torch.cli import visualise as tvisualise  # noqa: E402
from links_tpu_torch.data.synthetic import write_synthetic_pickle  # noqa: E402
from links_tpu_torch.models.completers import COMPLETER_SPECS  # noqa: E402
from links_tpu_torch.models.lifters import ResBlock, StackedLifter  # noqa: E402
from links_tpu_torch.objectives import occlusion as tocc  # noqa: E402
from links_tpu_torch.viz import skeletons as tskeletons  # noqa: E402
from test_torch_eval import CLI_RTOL  # noqa: E402
from test_torch_occlusion import (  # noqa: E402, F401  (models: a fixture)
    F32_TOL,
    _port_completers,
    _port_lifters,
    models,
)
from test_torch_train_step import _poses  # noqa: E402

SCENARIOS = tuple(jocc.DROPOUT_SCENARIO_JOINTS)
# An aligned pose is its ground truth's scale and place (camera frame, mm,
# z ~ 5000) plus the rotated prediction: two f32 3x3 SVDs by two libraries
# put each coordinate within a few f32 ulps of the pose's largest coordinate
# (5.3e-7 of it at most, observed), not of its own value. Held within
# ALIGN_REL of the ground truth's largest coordinate.
ALIGN_REL = 1e-5
N = 8
CLIP = 6


@pytest.fixture(scope="module")
def poses():
    """(N, 34) normalized 2D and (N, 51) 3D (mm) poses of one synthetic set."""
    p3d = generate_poses(N, seed=3)["poses_3d"].astype(np.float32)
    return _poses(N, seed=3), p3d.transpose(0, 2, 1).reshape(N, 51).copy()


@pytest.fixture(scope="module")
def port_models(models):  # noqa: F811
    trees, lifters = models
    return _port_completers(trees), _port_lifters(lifters)


def _stacked(lifters):
    return StackedLifter(lifters["left"], lifters["right"])


def _jax_stacked(lifters):
    return jax.tree.map(lambda a, b: jnp.stack([a, b]), lifters["left"], lifters["right"])


def _assert_aligned(got, want, gt, msg=""):
    """Aligned poses (..., 51) or (..., 3, 17) within ALIGN_REL of the
    largest coordinate of their ground truth ``gt``, pose by pose."""
    n = np.asarray(gt).reshape(-1, 51).shape[0]
    err = np.abs(np.asarray(got) - np.asarray(want)).reshape(n, 51).max(axis=1)
    scale = np.abs(np.asarray(gt)).reshape(n, 51).max(axis=1)
    assert (err <= ALIGN_REL * scale).all(), f"{msg}: {err} vs {ALIGN_REL} x {scale}"


def _lines(ax) -> list:
    return [np.asarray(line.get_data_3d() if hasattr(line, "get_data_3d") else line.get_data())
            for line in ax.lines]


def test_plot_skeletons(poses, tmp_path):
    """plot_skeleton_2d and plot_skeleton_3d draw JAX's line data on one
    pose; compare_poses_3d writes its file."""
    p2d, p3d = poses
    for plot, pose in ((viz.plot_skeleton_2d, p2d[0]), (viz.plot_skeleton_3d, p3d[0])):
        got = plot(pose)
        want = getattr(jviz, plot.__name__)(pose)
        assert len(got.lines) == len(want.lines) == 16
        np.testing.assert_array_equal(_lines(got), _lines(want))
        assert [line.get_color() for line in got.lines] == \
            [line.get_color() for line in want.lines]
        plt.close(got.figure)
        plt.close(want.figure)
    viz.compare_poses_3d([p3d[0], p3d[1]], ["a", "b"], out_path=tmp_path / "cmp.png")
    assert (tmp_path / "cmp.png").stat().st_size > 0


def test_32slot_expansion_and_render(poses, tmp_path):
    """The 32-slot buffer equals JAX's (3D and 2D), the constants are JAX's,
    and the render draws JAX's line data."""
    p2d, p3d = poses
    assert tskeletons.H36M_32SLOT_INDICES == jskeletons.H36M_32SLOT_INDICES
    np.testing.assert_array_equal(tskeletons.H36M_32SLOT_KIN_TREE,
                                  jskeletons.H36M_32SLOT_KIN_TREE)
    for pose, rows in ((p3d[0], 3), (p2d[0], 2)):
        buff = viz.expand_to_32_slots(pose)
        assert buff.shape == (rows, 32)
        np.testing.assert_array_equal(buff, jviz.expand_to_32_slots(pose))
    got = viz.plot_skeleton_3d_32slot(p3d[0], title="gt")
    want = jviz.plot_skeleton_3d_32slot(p3d[0], title="gt")
    np.testing.assert_array_equal(_lines(got), _lines(want))
    assert (got.azim, got.elev) == (want.azim, want.elev) == (-45, 15)
    got.figure.savefig(tmp_path / "slot32.png")
    plt.close(got.figure)
    plt.close(want.figure)
    assert (tmp_path / "slot32.png").stat().st_size > 0


def test_32slot_vertical_axis_is_negated_y(poses):
    """The vertical axis of the 32-slot render carries the negated pose y:
    every kinematic-tree edge is drawn as (x, z, -y)."""
    _, p3d = poses
    buff = viz.expand_to_32_slots(p3d[0])
    ax = viz.plot_skeleton_3d_32slot(p3d[0])
    for line, (a, b) in zip(ax.lines, tskeletons.H36M_32SLOT_KIN_TREE):
        xs, ys, zs = line.get_data_3d()
        np.testing.assert_allclose(xs, [buff[0][a], buff[0][b]], rtol=1e-6)
        np.testing.assert_allclose(ys, [buff[2][a], buff[2][b]], rtol=1e-6)
        np.testing.assert_allclose(zs, [-buff[1][a], -buff[1][b]], rtol=1e-6)
    plt.close(ax.figure)


def test_visualise_prediction(models, port_models, poses, tmp_path):  # noqa: F811
    """The aligned prediction and the PA-MPJPE of each frame against JAX's
    (its lift, ``_align_to_gt`` of its renderer on frame 0, the same
    alignment batched over the others, ``pa_mpjpe``); the render writes its
    file and returns the same error."""
    _, lifters = models
    p2d, p3d = poses
    stacked = _stacked(port_models[1])
    frames = 3
    pred = jlift(_jax_stacked(lifters), jnp.asarray(p2d[:frames]), 10.0, "right")
    want = np.asarray(jm.procrustes_align(p3d[:frames], pred)).reshape(frames, 51)
    want_err = np.asarray(jm.pa_mpjpe(p3d[:frames], pred))
    _assert_aligned(jprediction._align_to_gt(p3d[0], pred[0]), want[0], p3d[0])
    for frame in range(frames):
        gt, aligned, err = viz.prediction_data(stacked, torch.from_numpy(p2d),
                                               torch.from_numpy(p3d), frame)
        np.testing.assert_array_equal(gt, p3d[frame])
        _assert_aligned(aligned, want[frame], gt)
        np.testing.assert_allclose(err, want_err[frame], **F32_TOL)
    fig, err = viz.visualise_prediction(stacked, torch.from_numpy(p2d), torch.from_numpy(p3d),
                                        2, out_path=tmp_path / "pred.png")
    assert err == viz.prediction_data(stacked, torch.from_numpy(p2d),
                                      torch.from_numpy(p3d), 2)[2]
    assert (tmp_path / "pred.png").stat().st_size > 0


def _jax_samples(monkeypatch, flow, x, eps, zero_root):
    """links_tpu's draw_samples with its normal draw pinned to ``eps``."""
    monkeypatch.setattr(jsequence, "add_noise",
                        lambda key, z, f: z + f * jnp.asarray(eps) * z)
    return np.asarray(jsequence.draw_samples(flow, jnp.asarray(x), jax.random.PRNGKey(0),
                                             0.2, zero_root=zero_root))


@pytest.mark.parametrize("part", ["full", "left"])
def test_visualise_flow_samples(poses, tmp_path, monkeypatch, part):
    """Samples of the full flow (root pinned) and of a part flow (not
    pinned, as the JAX CLI draws them) from one normal draw, against JAX's
    with its draw pinned; the grid writes its file."""
    p2d, _ = poses
    inputs = p2d if part == "full" else np.array(split_data_left_right(jnp.asarray(p2d))[0])
    dim, n = inputs.shape[1], 4
    jflow = jflows.init_flow(jax.random.PRNGKey(2), dim, n_blocks=3, hidden=32)
    flow = flow_from_state_dict(flow_params_from_jax(jflow.params, jflow.perm))
    eps = np.random.default_rng(5).normal(size=(n, dim)).astype(np.float32)
    real, samples = viz.flow_samples_data(flow, torch.from_numpy(inputs), torch.from_numpy(eps))
    np.testing.assert_array_equal(real, inputs[:n])
    want = _jax_samples(monkeypatch, jflow, inputs[:n], eps, zero_root=dim == 34)
    np.testing.assert_allclose(samples, want, **F32_TOL)
    assert (samples[:, [0, dim // 2]] == 0).all() == (dim == 34)
    viz.visualise_flow_samples(flow, torch.from_numpy(inputs), torch.from_numpy(eps), n=n,
                               out_path=tmp_path / "samples.png")
    assert (tmp_path / "samples.png").stat().st_size > 0
    with pytest.raises(ValueError, match="eps must be"):
        viz.visualise_flow_samples(flow, torch.from_numpy(inputs), torch.from_numpy(eps), n=3)


def test_visualise_occlusion(models, port_models, poses, tmp_path):  # noqa: F811
    """The completed pose of a frame under each of the 8 scenarios, aligned,
    and its PA-MPJPE against JAX's; the render writes its file."""
    trees, lifters = models
    completers, port_lifters = port_models
    p2d, p3d = poses
    frame = 1
    poses_j = jocc.occlusion_validation_poses(trees, lifters, jnp.asarray(p2d[frame:frame + 1]))
    pred = jnp.concatenate([poses_j[s] for s in SCENARIOS])
    gt8 = np.repeat(p3d[frame:frame + 1], len(SCENARIOS), axis=0)
    want = np.asarray(jm.procrustes_align(gt8, pred)).reshape(-1, 51)
    want_err = np.asarray(jm.pa_mpjpe(gt8, pred))
    for i, scenario in enumerate(SCENARIOS):
        gt, aligned, err = viz.occlusion_data(completers, port_lifters, torch.from_numpy(p2d),
                                              torch.from_numpy(p3d), frame, scenario)
        _assert_aligned(aligned, want[i], gt, scenario)
        np.testing.assert_allclose(err, want_err[i], err_msg=scenario, **F32_TOL)
    fig, err = viz.visualise_occlusion(completers, port_lifters, torch.from_numpy(p2d),
                                       torch.from_numpy(p3d), frame, scenario="torso",
                                       out_path=tmp_path / "occ.png")
    assert np.isfinite(err) and (tmp_path / "occ.png").stat().st_size > 0


@pytest.fixture(scope="module")
def jax_dropout_clip(models, poses):  # noqa: F811
    """links_tpu's dropout_eval_poses on the clip, every scenario."""
    trees, lifters = models
    return jocc.dropout_eval_poses(trees, lifters, jnp.asarray(poses[0][:CLIP]), 10.0,
                                   choice="right")


@pytest.mark.parametrize("scenario", [None, *SCENARIOS])
def test_comparison_video(models, port_models, poses, jax_dropout_clip, tmp_path,  # noqa: F811
                          scenario):
    """The clip's aligned sequences, as the JAX CLI computes them: GT vs the
    aligned left/right lift, or with a scenario GT | aligned naive lift |
    aligned recovered pose; the 2- and 3-panel writers write their files."""
    _, lifters = models
    completers, port_lifters = port_models
    p2d, p3d = poses
    x, gt3d = p2d[:CLIP], p3d[:CLIP]
    if scenario is None:
        got = viz.sequence_data(_stacked(port_lifters), torch.from_numpy(x),
                                torch.from_numpy(gt3d), 10.0, "right")
        want = [jm.procrustes_align(gt3d, jlift(_jax_stacked(lifters), jnp.asarray(x), 10.0,
                                                "right"))]
    else:
        got = viz.occlusion_sequence_data(completers, port_lifters, torch.from_numpy(x),
                                          torch.from_numpy(gt3d), scenario, 10.0, "right")
        rec, naive = jax_dropout_clip[scenario]
        want = [jm.procrustes_align(gt3d, naive), jm.procrustes_align(gt3d, rec)]
    np.testing.assert_array_equal(got[0], gt3d.reshape(-1, 3, 17))
    assert len(got) == 1 + len(want)
    for g, w in zip(got[1:], want):
        assert g.shape == (CLIP, 3, 17)
        _assert_aligned(g, w, gt3d, str(scenario))
    if scenario in (None, "torso"):
        out = tmp_path / "clip.gif"
        if scenario is None:
            viz.render_comparison_video(*got, out, fps=2)
        else:
            viz.render_multi_video(list(got), ["gt", "naive", "recovered"], out, fps=2)
        assert out.stat().st_size > 0


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_dropout_eval_poses_one_scenario(models, poses, scenario):  # noqa: F811
    """``scenarios=(s,)`` returns the 8-scenario call's values for s, bitwise,
    with 45 residual-block calls (4 lifters x 7 + 3 completer blocks + the
    naive pair's 14) instead of 360."""
    trees, lifters = models
    p2d = torch.from_numpy(poses[0])
    completers, port_lifters = _port_completers(trees), _port_lifters(lifters)
    calls = []
    for model in (completers, *port_lifters.values()):
        for m in model.modules():
            if isinstance(m, ResBlock):
                m.register_forward_hook(lambda *_: calls.append(1))
    with torch.no_grad():
        every = tocc.dropout_eval_poses(completers, port_lifters, p2d)
        n_every = len(calls)
        one = tocc.dropout_eval_poses(completers, port_lifters, p2d, scenarios=(scenario,))
    assert list(one) == [scenario]
    for g, w in zip(one[scenario], every[scenario]):
        assert torch.equal(g, w)
    assert (n_every, len(calls) - n_every) == (360, 45)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, models):  # noqa: F811
    """A synthetic pickle and a model directory holding the JAX models as the
    port's trainers name them (lifters, completers, a full and a left flow),
    plus the left/right pair as reference .pt files written by links_tpu."""
    trees, lifters = models
    ws = tmp_path_factory.mktemp("viz")
    write_synthetic_pickle(ws / "s.pkl", n_per_subject=8, seed=0, n_test_per_subject=30)
    (ws / "occlusion_model_weights").mkdir()
    names = {"left": "left_side_lifter_final.pt", "right": "right_side_lifter_final.pt",
             "legs": "leg_lifter.pt", "torso": "torso_lifter.pt"}
    for side, name in names.items():
        save_lifter_pt(lifter_from_state_dict(lifter_params_from_jax(lifters[side])), ws / name)
    completers = _port_completers(trees)
    for name in COMPLETER_SPECS:
        save_completer_pt(completers[name], ws / "occlusion_model_weights"
                          / f"{name}_estimator.pt")
    for name, dim in (("full_flow", 34), ("flow_left", 22)):
        f = jflows.init_flow(jax.random.PRNGKey(dim), dim, n_blocks=2, hidden=32)
        save_flow_pt(flow_from_state_dict(flow_params_from_jax(f.params, f.perm)),
                     ws / f"{name}.pt")
    for side in ("left", "right"):
        jckpt.save_pt(ws / f"ref_{side}.pt", jckpt.lifter_to_torch(lifters[side]))
    return ws


MODES = {
    "gt3d": [], "gt3d 32slot": ["--style", "32slot"], "gt2d": [], "prediction": [],
    "occlusion": ["--scenario", "ll"], "video": ["--frames", "3", "--fps", "2"],
    "video scenario": ["--frames", "3", "--scenario", "torso", "--choice", "left"],
    "samples": [], "samples part": ["--flow", "flow_left"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_visualise_cli_writes_each_mode(model_dir, mode, tmp_path, capsys):
    what = mode.split()[0]
    out = tmp_path / f"out.{'gif' if what == 'video' else 'png'}"
    tvisualise.main(["--data", str(model_dir / "s.pkl"), "--model-dir", str(model_dir),
                     "--device", "cpu", "--what", what, "--frame", "2", "--out", str(out),
                     *MODES[mode]])
    assert out.stat().st_size > 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1] == f"wrote {out}"
    if what in ("prediction", "occlusion"):
        assert re.fullmatch(r"frame 2(: PA-MPJPE| scenario ll: PA) [0-9.]+mm", printed[-2])


def _pa_line(main, argv) -> float:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    line = out.getvalue().strip().splitlines()[-2]
    return float(re.fullmatch(r"frame 0: PA-MPJPE ([0-9.]+)mm", line).group(1))


def test_visualise_prediction_cli_matches_jax(model_dir, tmp_path, monkeypatch):
    """``--what prediction`` on one reference .pt pair prints JAX's
    PA-MPJPE."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    args = ["--data", str(model_dir / "s.pkl"), "--model-dir", str(tmp_path), "--what",
            "prediction", "--left-pt", str(model_dir / "ref_left.pt"),
            "--right-pt", str(model_dir / "ref_right.pt")]
    want = _pa_line(jvisualise.main, [*args, "--out", str(tmp_path / "j.png")])
    got = _pa_line(tvisualise.main, [*args, "--device", "cpu", "--out",
                                     str(tmp_path / "t.png")])
    np.testing.assert_allclose(got, want, rtol=CLI_RTOL)


def test_visualise_refuses_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib the CLI exits 2 naming it, before it reads any data
    (the pickle does not exist), and writes nothing."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "p.png"
    with pytest.raises(SystemExit) as exc:
        tvisualise.main(["--data", str(tmp_path / "missing.pkl"), "--device", "cpu",
                         "--out", str(out)])
    assert exc.value.code == 2
    assert "matplotlib" in capsys.readouterr().err
    assert not out.exists()
