"""The trainer lifecycle of links_tpu_torch on the CPU: run checkpoints
(``--resume`` of each of the five trainers ends bitwise where a run made
straight ends), ``--save-every``, ``--flip-guard``, the ``_best`` weights
and their sidecars, ``--use-best``/``--use-final`` in the consumers, and the
helpers (``BestTracker``, ``FlipGuard``, ``best_suffix``, ``EpochTimer``,
``select_metric``) against links_tpu's on the same record streams. The
trainers run at narrow widths (the constructors patched) on a tiny
synthetic corpus."""

import argparse
import contextlib
import functools
import io
import json
import shutil

import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu.cli import _common as J
from links_tpu_torch.ckpt import run_io
from links_tpu_torch.cli import _common as C
from links_tpu_torch.cli import eval_h36m as teval
from links_tpu_torch.cli import lift as tlift
from links_tpu_torch.cli import train_full_pose_norm_flow as stage1
from links_tpu_torch.cli import train_left_right_lifter as stage3a
from links_tpu_torch.cli import train_leg_torso_lifter as stage3b
from links_tpu_torch.cli import train_occlusion_models as stage4
from links_tpu_torch.cli import train_part_norm_flows as stage2
from links_tpu_torch.config import OptimConfig
from links_tpu_torch.data.synthetic import write_synthetic_pickle
from links_tpu_torch.flows import Flow
from links_tpu_torch.models.completers import Completers
from links_tpu_torch.models.lifters import Lifter
from links_tpu_torch.train.optim import Adam

BATCH = 16
PER_SUBJECT = 8  # 5 train subjects x 8 = 40 poses: 2 steps of 16
WIDTH = 32
# stage -> (its CLI, its run checkpoint's name, its log, the files it writes)
STAGES = {
    "1": (stage1, "full_flow", "full_pose_norm_flow", ["full_flow.pt"]),
    "2": (stage2, "part_flows", "part_norm_flows",
          ["flow_left.pt", "flow_right.pt", "flow_legs.pt", "flow_torso.pt"]),
    "3a": (stage3a, "left_right", "left_right_lifter",
           [*C.LR_LIFTERS, *C.LR_LIFTERS_BEST, "lifter_left_right_best.meta.json"]),
    "3b": (stage3b, "leg_torso", "leg_torso_lifter",
           ["leg_lifter.pt", "torso_lifter.pt", "leg_lifter_best.pt", "torso_lifter_best.pt",
            "lifter_legs_best.meta.json", "lifter_torso_best.meta.json"]),
    "4": (stage4, "occlusion", "occlusion_models",
          ["occlusion_model_weights/torso_estimator.pt",
           "occlusion_model_weights_best/left_leg_estimator.pt",
           "occlusion_models_best.meta.json"]),
}


def narrow(mp):
    """Build every trained model at WIDTH (the trainers' defaults are the
    reference's 1024)."""
    for module in (stage1, stage2):
        mp.setattr(module, "Flow", functools.partial(Flow, n_blocks=2, hidden=WIDTH))
    for module in (stage3a, stage3b):
        mp.setattr(module, "Lifter", functools.partial(Lifter, hidden=WIDTH))
    mp.setattr(stage4, "Completers", functools.partial(Completers, WIDTH))


def _args(ws, *flags):
    return ["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws), "--device", "cpu",
            "--batch-size", str(BATCH), *flags]


def _run(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = module.main(argv)
    return state, out.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A workspace where stages 1 -> 4 ran one epoch each at WIDTH: every
    stage's frozen inputs."""
    ws = tmp_path_factory.mktemp("lifecycle")
    write_synthetic_pickle(ws / "synthetic.pkl", n_per_subject=PER_SUBJECT, seed=0,
                           n_test_per_subject=20)
    with pytest.MonkeyPatch.context() as mp:
        narrow(mp)
        for module, *_ in STAGES.values():
            _run(module, _args(ws, "--epochs", "1"))
        yield ws


@pytest.fixture()
def narrow_models(monkeypatch):
    narrow(monkeypatch)


def _copy_inputs(src, dst):
    """The pickle and every weight file (the frozen inputs of any stage)."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "synthetic.pkl", dst)
    for path in src.glob("*.pt"):
        if not path.name.endswith("_run.pt"):
            shutil.copy(path, dst)
    return dst


def _records(path, epoch):
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    return [{k: v for k, v in r.items() if k != "_time"} for r in recs if r.get("_step") == epoch]


@pytest.mark.parametrize("stage", list(STAGES))
def test_resume_is_bitwise_a_straight_run(inputs, narrow_models, tmp_path, stage):
    """One epoch, then --resume to two, ends where two epochs straight end:
    the weights, Adam's moments and count, the step, the generator's state,
    the epoch-1 record and every file the stage writes."""
    module, run_name, log, files = STAGES[stage]
    straight = _copy_inputs(inputs, tmp_path / "straight")
    resumed = _copy_inputs(inputs, tmp_path / "resumed")
    want, _ = _run(module, _args(straight, "--epochs", "2"))
    _run(module, _args(resumed, "--epochs", "1"))
    got, lines = _run(module, _args(resumed, "--epochs", "2", "--resume"))
    assert lines[-2].startswith("epoch 1: ") and not any(x.startswith("epoch 0") for x in lines)
    assert json.loads(lines[-1])["steps"] == got.step == want.step == 4
    a, b = (torch.load(d / f"{run_name}_run.pt", weights_only=True) for d in (straight, resumed))
    assert a["next_epoch"] == b["next_epoch"] == 2 and a["step"] == b["step"] == 4
    assert a["opt"]["count"] == b["opt"]["count"] == got.opt.count == 4
    assert torch.equal(a["generator"], b["generator"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for p, q in zip(want.model.parameters(), got.model.parameters()):
        assert torch.equal(p, q)
    assert _records(straight / f"{log}.jsonl", 1) == _records(resumed / f"{log}.jsonl", 1)
    for name in files:
        x, y = (d / name for d in (straight, resumed))
        if name.endswith(".json"):
            assert json.loads(x.read_text()) == json.loads(y.read_text()), name
        else:
            sa, sb = (torch.load(p, weights_only=True) for p in (x, y))
            assert all(torch.equal(sa[k], sb[k]) for k in sa), name


def test_resume_without_a_checkpoint_starts_fresh(inputs, narrow_models, tmp_path):
    ws = _copy_inputs(inputs, tmp_path / "ws")
    state, lines = _run(stage3a, _args(ws, "--epochs", "1", "--resume"))
    assert state.step == 2 and lines[-2].startswith("epoch 0: ")


def test_resume_warns_and_casts_on_a_moment_dtype_change(inputs, narrow_models, tmp_path):
    """A bf16-moment checkpoint resumed under --no-bf16-opt-state: a warning
    naming the flag that keeps the checkpoint's recipe, then f32 moments."""
    ws = _copy_inputs(inputs, tmp_path / "ws")
    _run(stage3a, _args(ws, "--epochs", "1"))
    with pytest.warns(UserWarning, match="--bf16-opt-state to resume"):
        state, _ = _run(stage3a, _args(ws, "--epochs", "2", "--resume", "--no-bf16-opt-state"))
    assert state.opt.count == 4 and state.opt.mu[0].dtype == torch.float32


def test_adam_state_round_trips(rng):
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
              for s in ((4, 3), (5,))]
    opt = Adam(params, OptimConfig(bf16_moments=True), steps_per_epoch=3)
    for _ in range(2):
        opt.step([torch.ones_like(p) for p in params])
    again = Adam(params, OptimConfig(bf16_moments=True), steps_per_epoch=3)
    again.load_state_dict(opt.state_dict())
    assert again.count == 2 and again.mu[0].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(again.mu + again.nu, opt.mu + opt.nu))
    with pytest.raises(ValueError, match="does not match"):
        Adam(params[:1], OptimConfig(), 3).load_state_dict(opt.state_dict())


def test_save_every_paces_the_run_checkpoint(inputs, narrow_models, tmp_path, monkeypatch):
    """3 epochs at --save-every 2: run checkpoints after epochs 2 and 3, the
    best flushed at each, the final weights once, at the end."""
    ws = _copy_inputs(inputs, tmp_path / "ws")
    saved, finals = [], []
    save_run = run_io.save_run
    monkeypatch.setattr(run_io, "save_run", lambda args, stage, state, g, n: (
        saved.append((n, (ws / C.LR_LIFTERS_BEST[0]).exists())),
        save_run(args, stage, state, g, n)))
    save_artifact = C.save_artifact
    monkeypatch.setattr(C, "save_artifact", lambda args, name, m, best=False: (
        best or finals.append(name), save_artifact(args, name, m, best)))
    _run(stage3a, _args(ws, "--epochs", "3", "--save-every", "2"))
    assert saved == [(2, True), (3, True)] and finals == [C.LIFTER_LR]


def test_flip_guard_stops_the_run(inputs, narrow_models, tmp_path, monkeypatch):
    ws = _copy_inputs(inputs, tmp_path / "ws")
    monkeypatch.setattr(C.FlipGuard, "update", lambda self, epoch, rec: self.patience == 1)
    state, lines = _run(stage3b, _args(ws, "--epochs", "3", "--flip-guard", "1"))
    assert state.step == 2 and lines[-2].startswith("epoch 0: ")
    assert json.loads(lines[-1])["last"]["flip_guard_stop"] == 1.0
    assert torch.load(ws / "leg_torso_run.pt", weights_only=True)["next_epoch"] == 1
    assert (ws / "leg_lifter.pt").exists() and (ws / "leg_lifter_best.pt").exists()


@pytest.mark.parametrize("select_by,metric", [("pa", "pa"), ("nll", "val_nll"),
                                              ("loss", "val_unsup_loss")])
def test_select_by_names_the_sidecar_metric(inputs, narrow_models, tmp_path, select_by, metric):
    ws = _copy_inputs(inputs, tmp_path / "ws")
    _, lines = _run(stage3b, _args(ws, "--epochs", "1", "--select-by", select_by))
    rec = json.loads(lines[-1])["last"]
    for name in ("lifter_legs", "lifter_torso"):
        assert json.loads((ws / f"{name}_best.meta.json").read_text()) == {
            "epoch": 0, metric: rec[metric]}
    assert lines[-2].endswith(" [best]")


@pytest.mark.parametrize("select_by,metric", [("pa", "pa_scenario_mean"), ("mse", "val_mse")])
def test_stage4_select_by(inputs, narrow_models, tmp_path, select_by, metric):
    ws = _copy_inputs(inputs, tmp_path / "ws")
    _, lines = _run(stage4, _args(ws, "--epochs", "1", "--select-by", select_by))
    rec = json.loads(lines[-1])["last"]
    assert json.loads((ws / "occlusion_models_best.meta.json").read_text()) == {
        "epoch": 0, metric: rec[metric]}


def _streams(seed, n=40):
    rng = np.random.default_rng(seed)
    for epoch in range(n):
        rec = {"val_nll": float(rng.normal()), "val_tilt": float(rng.normal())}
        if rng.uniform() < 0.15:
            del rec["val_nll"]
        if rng.uniform() < 0.1:
            del rec["val_tilt"]
        yield epoch, rec


@pytest.mark.parametrize("gate", [None, "val_tilt"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_tracker_decides_as_jax(seed, gate, tmp_path):
    args = argparse.Namespace(model_dir=tmp_path)
    port = C.BestTracker("val_nll", gate, deferred=True)
    ref = J.BestTracker("val_nll", gate, deferred=True)
    for epoch, rec in _streams(seed):
        assert port.update(args, epoch, rec, {}) == ref.update(args, epoch, rec, {})
        assert (port.best, port.epoch, port.gated_out) == (ref.best, ref.epoch, ref.gated_out)


@pytest.mark.parametrize("patience", [None, 1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_flip_guard_fires_as_jax(seed, patience):
    port, ref = C.FlipGuard(patience), J.FlipGuard(patience)
    for epoch, rec in _streams(seed, 60):
        assert port.update(epoch, rec) == ref.update(epoch, rec)
        assert (port.armed, port.streak, port.fired_epoch) == (ref.armed, ref.streak,
                                                                ref.fired_epoch)


def test_best_tracker_restores_its_bar_from_the_sidecar(tmp_path):
    args = argparse.Namespace(model_dir=tmp_path)
    (tmp_path / "lifter_legs_best.meta.json").write_text(json.dumps({"epoch": 4, "pa": 12.5}))
    assert (C.BestTracker("pa").maybe_restore(args, "lifter_legs").best,
            C.BestTracker("pa").maybe_restore(args, "lifter_legs").epoch) == (12.5, 4)
    assert C.BestTracker("val_nll").maybe_restore(args, "lifter_legs").best == float("inf")
    assert C.BestTracker("pa").maybe_restore(args, "lifter_torso").epoch == -1


def test_deferred_best_is_a_copy_and_its_sidecar_follows_the_weights(tmp_path, monkeypatch):
    """The deferred best keeps the weights of its epoch though the live ones
    change in place after it; at the flush the weights are written before
    the sidecar, and a sidecar of an earlier best is gone meanwhile."""
    args = argparse.Namespace(model_dir=tmp_path)
    lifter = Lifter(7, WIDTH, generator=torch.Generator().manual_seed(0))
    kept = {k: v.clone() for k, v in lifter.state_dict().items()}
    sidecar = tmp_path / "lifter_legs_best.meta.json"
    sidecar.write_text(json.dumps({"epoch": 0, "pa": 99.0}))
    tracker = C.BestTracker("pa", deferred=True)
    assert tracker.update(args, 3, {"pa": 10.0}, {C.LIFTER_LEGS: lifter})
    with torch.no_grad():
        for p in lifter.parameters():
            p.add_(1.0)
    seen = []
    save_artifact = C.save_artifact
    monkeypatch.setattr(C, "save_artifact", lambda *a, **k: (
        seen.append(sidecar.exists()), save_artifact(*a, **k)))
    tracker.flush(args)
    assert seen == [False]
    assert json.loads(sidecar.read_text()) == {"epoch": 3, "pa": 10.0}
    written = torch.load(tmp_path / "leg_lifter_best.pt", weights_only=True)
    assert all(torch.equal(written[k], v) for k, v in kept.items())


@pytest.mark.parametrize("flags", [(), ("use_best",), ("use_final",)])
@pytest.mark.parametrize("exists", [False, True])
def test_best_suffix_decides_as_jax(tmp_path, flags, exists):
    port = argparse.Namespace(model_dir=tmp_path / "port", use_best="use_best" in flags,
                              use_final="use_final" in flags)
    ref = argparse.Namespace(**dict(vars(port), model_dir=tmp_path / "jax"))
    for d in (port.model_dir, ref.model_dir):
        d.mkdir()
    if exists:
        (port.model_dir / "leg_lifter_best.pt").write_bytes(b"")
        (ref.model_dir / "lifter_legs_best").mkdir()
    outcome = []
    for fn, args in ((C.best_suffix, port), (J.best_suffix, ref)):
        try:
            outcome.append(fn(args, "lifter_legs"))
        except FileNotFoundError:
            outcome.append(FileNotFoundError)
    assert outcome[0] == outcome[1]
    assert C.best_suffix(port) == J.best_suffix(ref)


def test_selection_flags_match_jax():
    for select_by in ("pa", "nll", "loss", "nll-tilt"):
        args = argparse.Namespace(select_by=select_by)
        assert C.select_metric(args, "pa_mean") == J.select_metric(args, "pa_mean")
        assert C.select_gate(args) == J.select_gate(args)


def test_epoch_timer_reports_the_jax_keys():
    port, ref = C.EpochTimer().start(), J.EpochTimer().start()
    for timer in (port, ref):
        for name in ("step", "validate", "checkpoint", "step", "validate"):
            with timer.section(name):
                pass
    with contextlib.redirect_stdout(io.StringIO()):
        want = ref.report(100)
    got = port.report(100)
    assert set(got) == set(want) and got["poses_per_sec_step"] > 0


def test_clear_stage_artifacts(tmp_path):
    args = argparse.Namespace(model_dir=tmp_path, resume=False)
    doomed = [*C.artifact_paths(args, C.OCCLUSION), *C.artifact_paths(args, C.OCCLUSION, True),
              tmp_path / "occlusion_models_best.meta.json", tmp_path / "occlusion_run.pt"]
    kept = [tmp_path / f for f in (*C.LR_LIFTERS, *C.LR_LIFTERS_BEST, "leg_lifter.pt",
                                   "lifter_left_right_best.meta.json")]
    for path in doomed + kept:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")
    C.clear_stage_artifacts(argparse.Namespace(model_dir=tmp_path, resume=True), "occlusion",
                            [C.OCCLUSION])
    assert all(p.exists() for p in doomed + kept)
    C.clear_stage_artifacts(args, "occlusion", [C.OCCLUSION])
    assert not any(p.exists() for p in doomed) and all(p.exists() for p in kept)


@pytest.fixture(scope="module")
def two_epochs(inputs, tmp_path_factory):
    """3a and 3b trained again in a copy: their final weights differ from the
    best ones, which keep the first epoch's (the selection metric forced to
    improve only then)."""
    ws = _copy_inputs(inputs, tmp_path_factory.mktemp("best"))
    with pytest.MonkeyPatch.context() as mp:
        narrow(mp)
        update = C.BestTracker.update
        mp.setattr(C.BestTracker, "update",
                   lambda self, args, epoch, rec, arts: epoch == 0 and update(
                       self, args, epoch, rec, arts))
        for module in (stage3a, stage3b):
            _run(module, _args(ws, "--epochs", "2"))
    return ws


@pytest.mark.parametrize("mode", ["left_right", "leg_torso"])
def test_lift_and_eval_read_best_unless_use_final(two_epochs, tmp_path, mode):
    ws = two_epochs
    common = ["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws), "--device", "cpu",
              "--mode", mode]
    lifts = {flag: tlift.main(common + [*flag, "--out", str(tmp_path / "o.npz")])
             for flag in ((), ("--use-best",), ("--use-final",))}
    np.testing.assert_array_equal(lifts[()], lifts[("--use-best",)])
    assert not np.array_equal(lifts[()], lifts[("--use-final",)])
    evals = {flag: teval.main(common + [*flag]) for flag in ((), ("--use-final",))}
    assert evals[()]["pa_mpjpe"] != evals[("--use-final",)]["pa_mpjpe"]


def test_use_best_requires_the_best_weights(two_epochs, tmp_path):
    ws = _copy_inputs(two_epochs, tmp_path / "ws")
    for f in C.LR_LIFTERS_BEST:
        (ws / f).unlink()
    common = ["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="--use-best: .*left_side_lifter_best.pt"):
        tlift.main(common + ["--use-best", "--out", str(tmp_path / "o.npz")])
    assert tlift.main(common + ["--out", str(tmp_path / "o.npz")]).shape == (40, 3, 17)


def test_stage4_reads_the_lifters_use_best_or_final(two_epochs, narrow_models, tmp_path):
    """Stage 4 learns from the frozen lifters --use-best/--use-final name:
    different pseudo-3D, so a different first loss."""
    losses = {}
    for flag in ("--use-best", "--use-final"):
        ws = _copy_inputs(two_epochs, tmp_path / flag)
        _, lines = _run(stage4, _args(ws, "--epochs", "1", flag))
        losses[flag] = json.loads(lines[-1])["last"]["loss"]
    assert losses["--use-best"] != losses["--use-final"]
