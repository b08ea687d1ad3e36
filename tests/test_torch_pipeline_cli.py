"""End-to-end slice test: the port's own trainers, stage 1 -> stage 2 -> 3a ->
3b -> 4, on the CPU on one tiny synthetic pickle with no file written by the
JAX package, then ``links_tpu_torch.cli.lift`` serving both lifter pairs and
every occlusion scenario from ``--model-dir`` alone. The JAX package reads
the flows, lifters and completers the port wrote."""

import contextlib
import io
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import module_scratch, one_cpu_thread, scratch  # noqa: F401  (fixtures)
from links_tpu import ckpt as jckpt
from links_tpu import flows as jflows
from links_tpu.objectives import occlusion as jocc
from links_tpu_torch import flows as tflows
from links_tpu_torch.ckpt.torch_io import load_flow_pt, load_lifter_pt
from links_tpu_torch.cli import _common as C
from links_tpu_torch.cli import lift as tlift
from links_tpu_torch.cli import train_full_pose_norm_flow as stage1
from links_tpu_torch.cli import train_left_right_lifter as stage3a
from links_tpu_torch.cli import train_leg_torso_lifter as stage3b
from links_tpu_torch.cli import train_occlusion_models as stage4
from links_tpu_torch.cli import train_part_norm_flows as stage2
from links_tpu_torch.data.synthetic import write_synthetic_pickle
from links_tpu_torch.models.completers import COMPLETER_SPECS

BATCH = 16
PER_SUBJECT = 8  # 5 train subjects x 8 = 40 poses: 2 steps of 16
FLOWS = ("full_flow", "flow_left", "flow_right", "flow_legs", "flow_torso")
STAGES = {
    "1": (stage1, ["full_flow.pt", "full_pose_norm_flow.jsonl"],
          ("dist_2d", "dist_2d_sample", "loss")),
    "2": (stage2, ["flow_left.pt", "flow_right.pt", "flow_legs.pt", "flow_torso.pt",
                   "part_norm_flows.jsonl"],
          ("dist_2d_left", "dist_2d_torso_sample", "loss")),
    "3a": (stage3a, ["left_side_lifter_final.pt", "right_side_lifter_final.pt",
                     "left_right_lifter.jsonl"],
           ("loss", "likeli", "pa_left", "val_nll")),
    "3b": (stage3b, ["leg_lifter.pt", "torso_lifter.pt", "leg_torso_lifter.jsonl"],
           ("loss", "leg_likeli", "torso_likeli", "pa", "mpjpe_scaled", "auc", "pck",
            "val_tilt", "val_nll", "val_unsup_loss")),
    "4": (stage4, [f"occlusion_model_weights/{name}_estimator.pt" for name in COMPLETER_SPECS]
          + ["occlusion_models.jsonl"],
          ("loss", "threed_loss_torso", "pa_la", "mpjpe_scaled_right", "pa_scenario_mean",
           "val_mse")),
}
SCENARIOS = ("la", "ra", "ll", "rl", "torso", "legs", "left", "right")
# a flow read by both packages: f32 sums in another order (tests/test_torch_flows.py)
F32_TOL = {"rtol": 1e-5, "atol": 1e-5}


def _args(ws, *flags):
    return ["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws), "--device", "cpu",
            "--batch-size", str(BATCH), "--epochs", "1", *flags]


def _run(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = module.main(argv)
    return state, out.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def pipeline(module_scratch):
    """Stages 1, 2, 3a and 3b, one epoch each, in one model directory; with
    the stage config each trainer ran."""
    ws = module_scratch("pipeline")
    write_synthetic_pickle(ws / "synthetic.pkl", n_per_subject=PER_SUBJECT, seed=0,
                           n_test_per_subject=20)
    runs, cfgs = {}, []
    summary = C.print_summary
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C, "print_summary", lambda cfg, *a: cfgs.append(cfg) or summary(cfg, *a))
        for name, (module, _, _) in STAGES.items():
            runs[name] = _run(module, _args(ws))
    return ws, runs, dict(zip(STAGES, cfgs))


@pytest.mark.parametrize("stage", list(STAGES))
def test_each_stage_trains_writes_and_reports(pipeline, stage):
    ws, runs, _ = pipeline
    _, files, keys = STAGES[stage]
    state, lines = runs[stage]
    assert state.step == 2 and state.opt.count == 2
    assert lines[-2].startswith("epoch 0: ")
    summary = json.loads(lines[-1])
    assert summary["steps"] == 2 and summary["batch"] == BATCH and summary["device"] == "cpu"
    assert all(np.isfinite(v) for v in summary["last"].values())
    assert set(keys) <= set(summary["last"])
    for name in files:
        assert (ws / name).exists(), name
    log = [json.loads(x) for x in (ws / files[-1]).read_text().splitlines()]
    assert log[0]["_config"]["BATCH_SIZE"] == BATCH and log[-1]["_step"] == 0


def test_stage_defaults_follow_the_jax_package(pipeline):
    """The flow trainers keep f32 Adam moments and no NLL cap; the lifter
    trainers store bf16 moments and cap the NLL at 500."""
    _, runs, cfgs = pipeline
    for stage, moments, cap in (("1", torch.float32, 0.0), ("2", torch.float32, 0.0),
                                ("3a", torch.bfloat16, 500.0), ("3b", torch.bfloat16, 500.0)):
        assert runs[stage][0].opt.mu[0].dtype == moments, stage
        assert cfgs[stage].optim.bf16_moments == (moments == torch.bfloat16), stage
        assert cfgs[stage].nll_cap == cap, stage


def test_lift_serves_both_pairs_from_model_dir(pipeline, tmp_path):
    ws, runs, _ = pipeline
    common = ["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws), "--device", "cpu"]
    lr = tlift.main(common + ["--out", str(tmp_path / "lr.npz")])
    lt = tlift.main(common + ["--mode", "leg_torso", "--out", str(tmp_path / "lt.npz")])
    for pred in (lr, lt):
        assert pred.shape == (40, 3, 17) and np.isfinite(pred).all()
    model = runs["3b"][0].model
    for lifter, name in zip((model.legs, model.torso), ("leg_lifter.pt", "torso_lifter.pt")):
        for a, b in zip(lifter.state_dict().values(),
                        load_lifter_pt(ws / name).state_dict().values()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", FLOWS)
def test_the_jax_package_reads_the_port_flows(pipeline, name, rng):
    ws = pipeline[0]
    port = load_flow_pt(ws / f"{name}.pt")
    flow = jckpt.load_flow_pt(ws / f"{name}.pt", n_blocks=8)
    dim = port.module_list[0].w_perm.shape[0]
    x = (rng.normal(size=(6, dim)) * 0.1).astype(np.float32)
    with torch.no_grad():
        z, ld = tflows.forward(port, torch.from_numpy(x))
    jz, jld = jflows.forward(flow, jnp.asarray(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **F32_TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), **F32_TOL)


def test_seed_decides_the_flows(pipeline, tmp_path):
    """The same --seed gives the same flows: init, permutation and every draw
    come from generators seeded by it."""
    ws = pipeline[0]
    shutil.copy(ws / "synthetic.pkl", tmp_path)
    for module in (stage1, stage2):
        _run(module, _args(tmp_path))
    for name in FLOWS:
        a, b = (torch.load(d / f"{name}.pt", weights_only=True) for d in (ws, tmp_path))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name


def test_flow_trainers_save_every_due_epoch(pipeline, tmp_path, monkeypatch):
    """--save-every N writes the flows every N-th epoch and at the last."""
    ws = pipeline[0]
    shutil.copy(ws / "synthetic.pkl", tmp_path)
    for module, per_save in ((stage1, 1), (stage2, 4)):
        saved = []
        monkeypatch.setattr(module, "save_flow_pt", lambda flow, path: saved.append(path.name))
        # stage 2 reads full_flow.pt, which a fresh stage-1 run removes first
        shutil.copy(ws / "full_flow.pt", tmp_path)
        _run(module, _args(tmp_path, "--epochs", "3", "--save-every", "2"))
        assert len(saved) == 2 * per_save, saved


LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_launcher(monkeypatch):
    """No launcher's variables: --distributed is refused."""
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("flags,message", [
    # an accepted flag beside a refused one: only the refused one is named
    (["--resume", "--distributed"], "^--distributed: .*not set"),
    (["--save-every", "2", "--num-devices", "0"], "^--num-devices 0: "),
    (["--packed-data", "x.lnks", "--distributed"], "^--distributed: .*not set"),
    (["--distributed"], "--distributed: .*not set"),
    (["--num-devices", "2", "--batch-size", "18"], "--batch-size 18: not a multiple of 4"),
    (["--wandb", "--num-devices", "-1"], "--num-devices -1: "),
    (["--select-by", "nll", "--save-pt", "--num-devices", "0"], "^--num-devices 0: "),
    (["--flip-guard", "3", "--packed-data", "x.lnks", "--wandb", "--num-devices", "2",
      "--device", "cuda"], r"^--num-devices 2: \d+ CUDA device"),
])
def test_leg_torso_trainer_refuses_unported_flags(pipeline, no_launcher, flags, message):
    ws = pipeline[0]
    with pytest.raises(SystemExit, match=message):
        stage3b.main(_args(ws, *flags))


@pytest.mark.parametrize("module", [stage1, stage2], ids=["stage1", "stage2"])
@pytest.mark.parametrize("flags,message", [
    (["--distributed"], "^--distributed: .*not set"),
    (["--wandb", "--num-devices", "0"], "^--num-devices 0: "),
], ids=["--distributed", "--wandb"])
def test_flow_trainers_refuse_unported_flags(pipeline, no_launcher, module, flags, message):
    with pytest.raises(SystemExit, match=message):
        module.main(_args(pipeline[0], *flags))


def test_missing_full_flow_is_named(pipeline, tmp_path):
    ws = pipeline[0]
    shutil.copy(ws / "synthetic.pkl", tmp_path)
    with pytest.raises(FileNotFoundError, match="train_full_pose_norm_flow"):
        stage2.main(_args(tmp_path))


def test_occlusion_trainer_defaults_follow_the_jax_package(pipeline):
    """Stage 4 keeps f32 Adam moments and the reference's two rotations and
    no input noise; its config has no NLL cap (it has no flow term)."""
    _, runs, cfgs = pipeline
    state, lines = runs["4"]
    assert state.opt.mu[0].dtype == torch.float32 and not cfgs["4"].optim.bf16_moments
    assert (cfgs["4"].n_rot, cfgs["4"].input_noise, cfgs["4"].depth) == (2, 0.0, 10.0)
    assert not hasattr(cfgs["4"], "nll_cap")
    assert len(list(state.model.parameters())) == len(state.opt.mu) == 8 * 16


def test_occlusion_trainer_ignores_nll_cap(pipeline, scratch):
    """--nll-cap is a flow-term flag: stage 4 accepts and ignores it, as the
    JAX package's resolve_cfg does."""
    ws = pipeline[0]
    for name in ("synthetic.pkl", "left_side_lifter_final.pt", "right_side_lifter_final.pt",
                 "leg_lifter.pt", "torso_lifter.pt"):
        shutil.copy(ws / name, scratch)
    state, lines = _run(stage4, _args(scratch, "--nll-cap", "100"))
    assert state.step == 2 and np.isfinite(json.loads(lines[-1])["last"]["loss"])


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_lift_scenario_serves_every_scenario_from_model_dir(pipeline, tmp_path, scenario):
    """lift --scenario from --model-dir alone, against the JAX package's
    scenario poses of the same dropped 2D with the lifters and completers it
    reads from the files the port wrote (f32)."""
    ws = pipeline[0]
    out = tmp_path / "o.npz"
    got = tlift.main(["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws), "--device",
                      "cpu", "--scenario", scenario, "--out", str(out)])
    assert got.shape == (40, 3, 17) and np.isfinite(got).all()
    lifters = {side: jckpt.load_lifter_pt(ws / f"{side}_side_lifter_final.pt")
               for side in ("left", "right")}
    lifters.update(legs=jckpt.load_lifter_pt(ws / "leg_lifter.pt"),
                   torso=jckpt.load_lifter_pt(ws / "torso_lifter.pt"))
    completers = {name: jckpt.load_completer_pt(
        ws / "occlusion_model_weights" / f"{name}_estimator.pt") for name in COMPLETER_SPECS}
    with np.load(out) as z:
        dropped = jocc.drop_keypoints(jnp.asarray(z["poses_2d"]),
                                      jocc.DROPOUT_SCENARIO_JOINTS[scenario])
    want = jocc.occlusion_validation_poses(completers, lifters, dropped,
                                           scenarios=(scenario,))[scenario]
    np.testing.assert_allclose(got.reshape(40, 51), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("flags,message", [
    # an accepted flag beside a refused one: only the refused one is named
    (["--select-by", "mse", "--packed-data", "x.lnks", "--num-devices", "0"],
     "^--num-devices 0: "),
    (["--use-best", "--distributed"], "^--distributed: .*not set"),
    (["--resume", "--num-devices", "3"], "^--batch-size 16: not a multiple of 3 "),
    (["--save-every", "2", "--wandb", "--distributed"], "^--distributed: .*not set"),
    (["--wandb", "--save-pt", "--num-devices", "0"], "--num-devices 0: "),
])
def test_occlusion_trainer_refuses_unported_flags(pipeline, no_launcher, flags, message):
    with pytest.raises(SystemExit, match=message):
        stage4.main(_args(pipeline[0], *flags))


def test_lift_refuses_fused_scenario(pipeline, tmp_path):
    ws = pipeline[0]
    with pytest.raises(SystemExit, match="cannot serve --scenario"):
        tlift.main(["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws), "--device",
                    "cpu", "--fused", "--scenario", "ll", "--out", str(tmp_path / "o.npz")])


def test_missing_completers_are_named(pipeline, scratch):
    ws = pipeline[0]
    for name in ("left_side_lifter_final.pt", "right_side_lifter_final.pt", "leg_lifter.pt",
                 "torso_lifter.pt"):
        shutil.copy(ws / name, scratch)
    with pytest.raises(FileNotFoundError, match="train_occlusion_models"):
        tlift.main(["--data", str(ws / "synthetic.pkl"), "--model-dir", str(scratch),
                    "--device", "cpu", "--scenario", "torso", "--out", str(scratch / "o.npz")])
