"""End-to-end slice test: the port's own trainers, stage 1 -> stage 2 -> 3a ->
3b, on the CPU on one tiny synthetic pickle with no file written by the JAX
package, then ``links_tpu_torch.cli.lift`` serving both lifter pairs from
``--model-dir`` alone. The JAX package reads the flows the port wrote."""

import contextlib
import io
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from links_tpu import ckpt as jckpt
from links_tpu import flows as jflows
from links_tpu_torch import flows as tflows
from links_tpu_torch.ckpt.torch_io import load_flow_pt, load_lifter_pt
from links_tpu_torch.cli import _common as C
from links_tpu_torch.cli import lift as tlift
from links_tpu_torch.cli import train_full_pose_norm_flow as stage1
from links_tpu_torch.cli import train_left_right_lifter as stage3a
from links_tpu_torch.cli import train_leg_torso_lifter as stage3b
from links_tpu_torch.cli import train_part_norm_flows as stage2
from links_tpu_torch.data.synthetic import write_synthetic_pickle

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
}
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
def pipeline(tmp_path_factory):
    """Stages 1, 2, 3a and 3b, one epoch each, in one model directory; with
    the stage config each trainer ran."""
    ws = tmp_path_factory.mktemp("pipeline")
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
    for name in ("synthetic.pkl", "full_flow.pt"):
        shutil.copy(ws / name, tmp_path)
    for module, per_save in ((stage1, 1), (stage2, 4)):
        saved = []
        monkeypatch.setattr(module, "save_flow_pt", lambda flow, path: saved.append(path.name))
        _run(module, _args(tmp_path, "--epochs", "3", "--save-every", "2"))
        assert len(saved) == 2 * per_save, saved


@pytest.mark.parametrize("flags,message", [
    (["--resume"], "--resume: not yet ported"),
    (["--save-every", "2"], "--save-every: not yet ported"),
    (["--packed-data", "x.lnks"], "--packed-data: not yet ported"),
    (["--distributed"], "--distributed: not yet ported"),
    (["--num-devices", "2"], "--num-devices: not yet ported"),
    (["--wandb"], "--wandb: not yet ported"),
    (["--select-by", "nll"], "--select-by: not yet ported"),
    (["--flip-guard", "3"], "--flip-guard: not yet ported"),
])
def test_leg_torso_trainer_refuses_unported_flags(pipeline, flags, message):
    ws = pipeline[0]
    with pytest.raises(SystemExit, match=message):
        stage3b.main(_args(ws, *flags))


@pytest.mark.parametrize("module", [stage1, stage2], ids=["stage1", "stage2"])
@pytest.mark.parametrize("flag", ["--resume", "--wandb"])
def test_flow_trainers_refuse_unported_flags(pipeline, module, flag):
    with pytest.raises(SystemExit, match=f"{flag}: not yet ported"):
        module.main(_args(pipeline[0], flag))


def test_missing_full_flow_is_named(pipeline, tmp_path):
    ws = pipeline[0]
    shutil.copy(ws / "synthetic.pkl", tmp_path)
    with pytest.raises(FileNotFoundError, match="train_full_pose_norm_flow"):
        stage2.main(_args(tmp_path))
