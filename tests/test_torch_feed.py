"""The packed streaming feed of links_tpu_torch (data/native_loader.py,
train/feed.py, cli/pack_data.py and ``--packed-data`` on the trainers) on
the CPU, against the JAX package's loader: its packs byte for byte, its
epoch batches bitwise; what a packed epoch feeds the steps; every trainer
with a pack it creates and with one that exists; a packed 3a run resumed."""

import argparse
import contextlib
import filecmp
import io
import json
import shutil

import numpy as np
import pytest
import torch

from links_tpu.cli import pack_data as jpack
from links_tpu.data import native_loader as jloader
from links_tpu_torch.cli import _common as C
from links_tpu_torch.cli import pack_data as tpack
from links_tpu_torch.cli import train_full_pose_norm_flow as stage1
from links_tpu_torch.cli import train_left_right_lifter as stage3a
from links_tpu_torch.cli import train_leg_torso_lifter as stage3b
from links_tpu_torch.cli import train_occlusion_models as stage4
from links_tpu_torch.cli import train_part_norm_flows as stage2
from links_tpu_torch.data import native_loader as tloader
from links_tpu_torch.data.synthetic import write_synthetic_pickle
from links_tpu_torch.train import feed
from links_tpu_torch.train.loop import run_epoch
from links_tpu_torch.train.steps import draw_step

BATCH = 16
PER_SUBJECT = 8  # 5 train subjects x 8 = 40 poses: 2 steps of 16, a ragged 8 dropped
# trainer -> (module, the files of the model directory it reads, a file it writes)
TRAINERS = {
    "stage1": (stage1, [], "full_flow.pt"),
    "stage2": (stage2, ["full_flow.pt"], "flow_torso.pt"),
    "3a": (stage3a, ["full_flow.pt", "flow_left.pt", "flow_right.pt"],
           "left_side_lifter_final.pt"),
    "3b": (stage3b, ["full_flow.pt", "flow_legs.pt", "flow_torso.pt"], "torso_lifter.pt"),
    "stage4": (stage4, ["left_side_lifter_final.pt", "right_side_lifter_final.pt",
                        "leg_lifter.pt", "torso_lifter.pt"],
               "occlusion_model_weights/torso_estimator.pt"),
}


def _args(ws, *flags):
    return ["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws), "--device", "cpu",
            "--batch-size", str(BATCH), "--epochs", "1", *flags]


def _run(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = module.main(argv)
    return state, out.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The five trainers run in memory, one epoch each, in one model
    directory: the inputs each packed run reads (removed afterwards: the
    full-width run checkpoints take hundreds of MB)."""
    ws = tmp_path_factory.mktemp("feed")
    write_synthetic_pickle(ws / "synthetic.pkl", n_per_subject=PER_SUBJECT, seed=0,
                           n_test_per_subject=20)
    for module, _, _ in TRAINERS.values():
        _run(module, _args(ws))
    yield ws
    shutil.rmtree(ws, ignore_errors=True)


@pytest.fixture
def scratch(tmp_path):
    """``tmp_path``, removed after the test (trainer runs write full-width
    checkpoints)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _inputs(trained, ws, name):
    """A fresh model directory ``ws`` with the corpus and what trainer
    ``name`` reads."""
    ws.mkdir(exist_ok=True)
    for f in ["synthetic.pkl", *TRAINERS[name][1]]:
        shutil.copy(trained / f, ws)
    return ws


@pytest.mark.parametrize("shape", [(1000, 34), (37, 51)])
def test_pack_is_byte_identical_to_the_jax_packs(tmp_path, shape):
    data = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    tloader.pack_dataset(tmp_path / "t.lnks", data)
    jloader.pack_dataset(tmp_path / "j.lnks", data)
    assert filecmp.cmp(tmp_path / "t.lnks", tmp_path / "j.lnks", shallow=False)


def test_each_package_opens_the_others_pack(tmp_path):
    data = np.random.default_rng(1).normal(size=(300, 34)).astype(np.float32)
    tloader.pack_dataset(tmp_path / "t.lnks", data)
    jloader.pack_dataset(tmp_path / "j.lnks", data)
    with tloader.PackedDataset(tmp_path / "j.lnks") as t:
        j = jloader.PackedDataset(tmp_path / "t.lnks")
        assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols) == data.shape
        np.testing.assert_array_equal(t.gather(0, 300), data)
        np.testing.assert_array_equal(j.gather(0, 300), data)
        j.close()


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_epoch_batches_are_the_jax_batches(tmp_path, seed):
    data = np.random.default_rng(2).normal(size=(1000, 34)).astype(np.float32)
    tloader.pack_dataset(tmp_path / "p.lnks", data)
    with tloader.PackedDataset(tmp_path / "p.lnks") as t:
        j = jloader.PackedDataset(tmp_path / "p.lnks")
        got, want = list(t.epoch_batches(64, seed)), list(j.epoch_batches(64, seed))
        j.close()
    assert len(got) == len(want) == 1000 // 64
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[0], data[:64])  # shuffled


def test_gathers_with_one_and_eight_threads_agree(tmp_path):
    data = np.random.default_rng(3).normal(size=(5000, 34)).astype(np.float32)
    tloader.pack_dataset(tmp_path / "p.lnks", data)
    one, eight = (tloader.PackedDataset(tmp_path / "p.lnks", n_threads=n) for n in (1, 8))
    one.shuffle(5)
    eight.shuffle(5)
    into = torch.empty(4096, 34)
    np.testing.assert_array_equal(eight.gather(100, 4096, into).numpy(), one.gather(100, 4096))
    one.close()
    eight.close()


@pytest.mark.parametrize("start,count", [(-1, 4), (0, 101), (98, 3), (0, -1)])
def test_gather_out_of_range_raises(tmp_path, start, count):
    tloader.pack_dataset(tmp_path / "p.lnks", np.zeros((100, 34), np.float32))
    with tloader.PackedDataset(tmp_path / "p.lnks") as ds, pytest.raises(IndexError):
        ds.gather(start, count)


def test_gather_refuses_a_wrong_buffer(tmp_path):
    tloader.pack_dataset(tmp_path / "p.lnks", np.zeros((100, 34), np.float32))
    with tloader.PackedDataset(tmp_path / "p.lnks") as ds, pytest.raises(ValueError):
        ds.gather(0, 8, torch.empty(8, 33))


def test_open_or_pack_needs_a_split_or_a_pack(tmp_path):
    with pytest.raises(FileNotFoundError, match="pack_data"):
        feed.open_or_pack(tmp_path / "missing.lnks")
    data = np.ones((20, 34), np.float32)
    with feed.open_or_pack(tmp_path / "sub" / "p.lnks", data) as ds:
        assert ds.n_rows == 20


@pytest.mark.parametrize("chunk_steps", [1, 3, 16])
def test_a_packed_epoch_feeds_the_batches_of_its_shuffle_seed(tmp_path, chunk_steps):
    """A recording step sees exactly the batches of
    ``epoch_batches(shuffle_seed(generator))``, and each step gets the draws
    that follow that seed in the generator, as run_epoch's in-memory steps
    get theirs; the ragged tail is dropped."""
    data = np.random.default_rng(4).normal(size=(100, 34)).astype(np.float32)
    tloader.pack_dataset(tmp_path / "p.lnks", data)
    packed = tloader.PackedDataset(tmp_path / "p.lnks")
    gen = torch.Generator().manual_seed(9)
    twin = torch.Generator().set_state(gen.get_state())
    seen = []

    def step(state, batch, draws):
        seen.append((batch.clone(), draws))
        return {"loss": batch.sum()}

    rec = run_epoch(step, None, feed.PackedFeed(packed, "cpu", chunk_steps), 8, gen)
    seed = feed.shuffle_seed(twin)
    want = list(packed.epoch_batches(8, seed))
    assert len(seen) == len(want) == 12
    for (batch, draws), w in zip(seen, want):
        np.testing.assert_array_equal(batch.numpy(), w)
        for got, exp in zip(draws, draw_step(twin, 8, "cpu")):
            assert torch.equal(got, exp)
    assert rec["loss"] == pytest.approx(float(np.mean([w.sum() for w in want])), rel=1e-5)
    assert torch.equal(gen.get_state(), twin.get_state())
    packed.close()


@pytest.mark.parametrize("mode", ["create", "read"])
@pytest.mark.parametrize("name", list(TRAINERS))
def test_every_trainer_trains_from_a_pack(trained, scratch, monkeypatch, name, mode):
    """--packed-data on each trainer: packing the train split first
    ('create'), or reading a pack made by pack_data without loading the
    train split ('read'), which then trains bitwise as the creating run."""
    module, _, writes = TRAINERS[name]
    runs = {}
    for run in ("create", "read") if mode == "read" else ("create",):
        ws = _inputs(trained, scratch / run, name)
        pack = ws / "train.lnks"
        if run == "read":
            _run(tpack, ["--data", str(ws / "synthetic.pkl"), "--out", str(pack)])
            monkeypatch.setattr(C, "load_train", _no_train_split)
            monkeypatch.setattr(C, "load_train_test", _no_train_split)
        state, lines = _run(module, _args(ws, "--packed-data", str(pack)))
        summary = json.loads(lines[-1])
        assert pack.exists() and (ws / writes).exists()
        assert state.step == summary["steps"] == 2 and np.isfinite(summary["last"]["loss"])
        runs[run] = [p.detach().clone() for p in state.model.parameters()]
    if mode == "read":
        assert all(torch.equal(a, b) for a, b in zip(runs["create"], runs["read"]))


def _no_train_split(args):
    raise AssertionError("the train split was loaded beside an existing pack")


def test_packed_3a_resumes_bitwise(trained, scratch):
    """A 3a run resumed after epoch 1 with --packed-data ends bitwise equal to
    a straight two-epoch run: the run checkpoint carries the generator, whose
    next draw is epoch 2's shuffle seed."""
    states = {}
    for name, runs in (("straight", [["--epochs", "2"]]),
                       ("resumed", [["--epochs", "1"], ["--epochs", "2", "--resume"]])):
        ws = _inputs(trained, scratch / name, "3a")
        for flags in runs:
            states[name], lines = _run(stage3a, _args(ws, "--packed-data", str(ws / "t.lnks"))
                                       + flags)
        assert lines[-2].startswith("epoch 1")
    pairs = list(zip(states["straight"].model.parameters(), states["resumed"].model.parameters()))
    assert states["resumed"].step == states["straight"].step == 4
    assert all(torch.equal(a, b) for a, b in zip(*(s.opt.mu for s in states.values())))
    assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.parametrize("what", ["poses_2d", "poses_3d"])
def test_pack_data_round_trips(trained, tmp_path, what):
    """pack_data writes the train split's normalized array; --inspect prints
    the JAX tool's keys and numbers."""
    out = tmp_path / "p.lnks"
    info = _run(tpack, ["--data", str(trained / "synthetic.pkl"), "--out", str(out),
                        "--what", what])[0]
    parser = C.add_common_flags(argparse.ArgumentParser())
    train = C.load_train(parser.parse_args(["--data", str(trained / "synthetic.pkl")]))
    want = getattr(train, what).numpy()
    assert info == {"out": str(out), "what": what, "n_rows": 40, "n_cols": want.shape[1],
                    "native": True}
    with tloader.PackedDataset(out) as ds:
        np.testing.assert_array_equal(ds.gather(0, ds.n_rows), want)
    got = _run(tpack, ["--inspect", str(out)])[0]
    with contextlib.redirect_stdout(io.StringIO()) as text:
        jpack.main(["--inspect", str(out)])
    assert got == json.loads(text.getvalue())


@pytest.mark.parametrize("name", ["3a", "3b"])
def test_bone_means_from_data_need_the_train_split(trained, scratch, name):
    """With an existing pack the train split's 3D ground truth is not loaded:
    --bone-means data is refused with the JAX package's message."""
    ws = _inputs(trained, scratch, name)
    _run(tpack, ["--data", str(ws / "synthetic.pkl"), "--out", str(ws / "t.lnks")])
    with pytest.raises(SystemExit, match="--bone-means data needs the train split's 3D GT"):
        TRAINERS[name][0].main(_args(ws, "--packed-data", str(ws / "t.lnks"),
                                     "--bone-means", "data"))
