"""End-to-end slice test: ``links_tpu_torch.cli.train_left_right_lifter`` on the
CPU, on a tiny synthetic pickle with seeded frozen flows written by the JAX
package (``save_pt(flow_to_torch(...))``), and the lifters it writes served
by both packages, ``links_tpu_torch.cli.lift --model-dir`` included."""

import contextlib
import io
import json
import shutil

import jax
import numpy as np
import pytest

from _torch_suite import module_scratch, one_cpu_thread, scratch  # noqa: F401  (fixtures)
from links_tpu import ckpt as jckpt
from links_tpu import flows as jflows
from links_tpu_torch.cli import lift as tlift
from links_tpu_torch.cli import train_left_right_lifter as ttrain
from links_tpu_torch.data.synthetic import write_synthetic_pickle

FLOW_HID = 32
BATCH = 16
PER_SUBJECT = 8  # 5 train subjects x 8 = 40 poses: 2 steps of 16


@pytest.fixture(scope="module")
def run(module_scratch):
    """A workspace: a synthetic pickle and the seeded JAX flows as FrEIA .pt."""
    ws = module_scratch("train")
    write_synthetic_pickle(ws / "synthetic.pkl", n_per_subject=PER_SUBJECT, seed=0,
                           n_test_per_subject=20)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    for k, (name, dim) in zip(keys, (("full_flow", 34), ("flow_left", 22), ("flow_right", 22))):
        flow = jflows.init_flow(k, dim, n_blocks=3, hidden=FLOW_HID)
        jckpt.save_pt(ws / f"{name}.pt", jckpt.flow_to_torch(flow))
    return ws


def _args(ws, *flags):
    return ["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws), "--device", "cpu",
            "--batch-size", str(BATCH), "--epochs", "1", *flags]


@pytest.fixture(scope="module")
def trained(run):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = ttrain.main(_args(run))
    return state, out.getvalue().strip().splitlines()


def test_one_epoch_trains_and_reports(run, trained):
    state, lines = trained
    assert state.step == 2 and state.opt.count == 2
    assert lines[-2].startswith("epoch 0: loss=") and " pa_left=" in lines[-2]
    summary = json.loads(lines[-1])
    assert summary["epochs"] == 1 and summary["steps"] == 2 and summary["batch"] == BATCH
    assert summary["device"] == "cpu" and summary["poses_per_sec"] > 0
    last = summary["last"]
    for k in ("loss", "likeli", "L3d", "rep_rot", "re_rot_3d", "bl_prior", "pa_left",
              "pa_right", "mpjpe_scaled_left", "val_tilt", "val_nll", "val_unsup_loss"):
        assert np.isfinite(last[k]), k
    log = [json.loads(x) for x in (run / "left_right_lifter.jsonl").read_text().splitlines()]
    assert log[0]["_config"]["BATCH_SIZE"] == BATCH
    assert log[-1]["_step"] == 0 and log[-1]["loss"] == pytest.approx(last["loss"])


def test_written_lifters_serve_in_both_packages(run, trained, tmp_path):
    state, _ = trained
    left, right = run / "left_side_lifter_final.pt", run / "right_side_lifter_final.pt"
    pred = tlift.main(["--data", str(run / "synthetic.pkl"), "--left-pt", str(left),
                       "--right-pt", str(right), "--device", "cpu",
                       "--out", str(tmp_path / "o.npz")])
    assert pred.shape == (40, 3, 17) and np.isfinite(pred).all()
    tree = jckpt.load_lifter_pt(right)
    np.testing.assert_array_equal(np.asarray(tree["res_angle1"]["l2"]["w"]),
                                  state.model.right.res_angle1.l2.weight.detach().numpy().T)


def test_lift_finds_the_trainers_lifters_in_model_dir(run, trained, tmp_path):
    """``lift --model-dir`` alone serves the pair the trainer wrote
    (``{left,right}_side_lifter_final.pt``), as the JAX package's lift
    serves its trainer's artifact."""
    state, _ = trained
    pred = tlift.main(["--data", str(run / "synthetic.pkl"), "--model-dir", str(run),
                       "--device", "cpu", "--out", str(tmp_path / "o.npz")])
    want = tlift.main(["--data", str(run / "synthetic.pkl"), "--device", "cpu",
                       "--left-pt", str(run / "left_side_lifter_final.pt"),
                       "--right-pt", str(run / "right_side_lifter_final.pt"),
                       "--out", str(tmp_path / "want.npz")])
    assert pred.shape == (40, 3, 17) and np.isfinite(pred).all()
    np.testing.assert_array_equal(pred, want)


def test_seed_decides_the_run(run, trained, scratch):
    """The same --seed gives the same weights: init and every draw come from
    generators seeded by it."""
    state, _ = trained
    for name in ("full_flow", "flow_left", "flow_right"):
        shutil.copy(run / f"{name}.pt", scratch)
    again = ttrain.main(_args(run, "--model-dir", str(scratch)))
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        assert np.array_equal(a.detach().numpy(), b.detach().numpy())


@pytest.mark.parametrize("flags,message", [
    # an accepted flag beside a refused one: only the refused one is named
    (["--resume", "--attention", "--packed-data", "x.lnks", "--distributed"],
     "^--distributed: .*not set"),
    (["--save-every", "2", "--packed-data", "x.lnks", "--wandb", "--num-devices", "0"],
     "^--num-devices 0: "),
    (["--packed-data", "x.lnks", "--num-devices", "2", "--batch-size", "6"],
     "^--batch-size 6: not a multiple of 4"),
    (["--attention", "--num-devices", "2", "--device", "cuda"],
     r"^--num-devices 2: \d+ CUDA device"),
    (["--select-by", "nll", "--wandb", "--distributed"], "^--distributed: .*not set"),
    (["--flip-guard", "3", "--save-pt", "--distributed"], "^--distributed: .*not set"),
    (["--wandb", "--num-devices", "0"], "--num-devices 0: "),
    (["--test-scale", "auto", "--num-devices", "2", "--batch-size", "10"],
     "^--batch-size 10: not a multiple of 4"),
])
def test_unported_flags_are_refused(run, flags, message, monkeypatch):
    """The data-parallel flags are checked before any data is read."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=message):
        ttrain.main(_args(run, *flags))


@pytest.mark.parametrize("bone_means", ["data", "mpi_vnect_interesting"])
def test_bone_means_choices_train(run, trained, scratch, bone_means):
    """3a trains with the prior means of the train split's 3D ground truth and
    with the MPI means; the bone prior differs from the H36M run's."""
    for name in ("full_flow", "flow_left", "flow_right"):
        shutil.copy(run / f"{name}.pt", scratch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = ttrain.main(_args(run, "--model-dir", str(scratch), "--bone-means", bone_means))
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert state.step == 2 and all(np.isfinite(v) for v in summary["last"].values())
    assert (scratch / "left_side_lifter_final.pt").exists()
    h36m = json.loads(trained[1][-1])["last"]
    assert summary["last"]["bl_prior"] != pytest.approx(h36m["bl_prior"], rel=1e-3)


def test_missing_flows_are_named(run, tmp_path):
    args = _args(run)
    args[args.index("--model-dir") + 1] = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="full_flow.pt"):
        ttrain.main(args)

