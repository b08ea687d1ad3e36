"""The port's trainers on data-parallel ranks (``--num-devices 2 --device cpu``:
two gloo ranks spawned by the trainer) against one process, on a tiny
synthetic corpus: stage 1's records and flow, 3a's records (validation
included) and lifters in memory and from a pack, a 2-rank ``--resume``
against a straight 2-rank run, and the refusals of the data-parallel
flags. The frozen flows 3a reads are seeded ones written with the port's own
``.pt`` writer; the trainers build their models at full width. ``--f32``
keeps the comparisons tight (tests/test_torch_parallel.py holds the bf16
steps)."""

import json
import shutil

import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread, scratch  # noqa: F401  (fixtures)
from links_tpu_torch.ckpt.torch_io import save_flow_pt
from links_tpu_torch.cli import pack_data
from links_tpu_torch.cli import train_full_pose_norm_flow as stage1
from links_tpu_torch.cli import train_left_right_lifter as stage3a
from links_tpu_torch.data.synthetic import write_synthetic_pickle
from links_tpu_torch.flows import Flow
from links_tpu_torch.train.parallel import LAUNCHER_VARS

BATCH = 16
PER_SUBJECT = 8  # 5 train subjects x 8 = 40 poses: 2 steps of 16
FLOWS_3A = {"full_flow": 34, "flow_left": 22, "flow_right": 22}
LR_FILES = ("left_side_lifter_final.pt", "right_side_lifter_final.pt")
# a 2-rank run against one process (f32), two steps. Adam moves a
# coordinate by about lr whatever its gradient's size, so one whose gradient
# is near zero can take an opposite update, and the next step's gradient
# then differs more: the weights within 2 lr per step, and fewer than 0.1% of
# the coordinates more than 1e-5 apart (observed on the CPU for 3a's lifters
# from the pack: at most 3.4e-4, and 6.6e-5 of the coordinates).
# Such coordinates move what the records read after an update (the second
# step's loss, the validation): within rtol 1e-4 (observed 1.0e-5, 3a's
# val_unsup_loss from the pack), ten times the one-step bound.
TOL = {"rtol": 1e-4, "atol": 1e-5}
STEPS = 2
LR = 2e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A synthetic pickle, its LNKS pack and 3a's frozen flows (3 blocks at
    hidden 32, seeded)."""
    ws = tmp_path_factory.mktemp("corpus")
    write_synthetic_pickle(ws / "synthetic.pkl", n_per_subject=PER_SUBJECT, seed=0,
                           n_test_per_subject=20)
    pack_data.main(["--data", str(ws / "synthetic.pkl"), "--out", str(ws / "train.lnks")])
    g = torch.Generator().manual_seed(0)
    for name, dim in FLOWS_3A.items():
        save_flow_pt(Flow(dim, 3, 32, generator=g), ws / f"{name}.pt")
    return ws


@pytest.fixture
def model_dir(scratch, corpus):
    """``-> make(name)``: a fresh model directory holding 3a's frozen flows,
    removed after the test (the lifters' run checkpoints are large)."""
    def make(name: str):
        d = scratch / name
        d.mkdir()
        for flow in FLOWS_3A:
            shutil.copy(corpus / f"{flow}.pt", d)
        return d

    return make


def _args(corpus, model_dir, *flags):
    return ["--data", str(corpus / "synthetic.pkl"), "--model-dir", str(model_dir),
            "--device", "cpu", "--batch-size", str(BATCH), "--epochs", "1", "--f32", *flags]


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _assert_records_close(got: list, want: list):
    assert [r.keys() for r in got] == [r.keys() for r in want]
    for g, w in zip(got[1:], want[1:]):
        for k, v in w.items():
            if not k.startswith("_"):
                np.testing.assert_allclose(g[k], v, err_msg=k, **TOL)


def _assert_weights_close(got_dir, want_dir, files):
    for name in files:
        got, want = (torch.load(d / name, weights_only=True) for d in (got_dir, want_dir))
        assert got.keys() == want.keys(), name
        gaps = torch.cat([(got[k] - want[k]).abs().ravel() for k in want])
        assert float(gaps.max()) <= STEPS * 2 * LR, (name, float(gaps.max()))
        assert float((gaps > 1e-5).float().mean()) < 1e-3, name


def test_flow_trainer_on_two_ranks_matches_one_process(corpus, model_dir, capfd):
    """Stage 1 on 2 ranks: its record and ``full_flow.pt`` are the one
    process's within the step bound; rank 0 alone prints and logs (one
    epoch line, one summary, one record)."""
    one, two = model_dir("one"), model_dir("two")
    assert stage1.main(_args(corpus, one)) is not None
    capfd.readouterr()
    assert stage1.main(_args(corpus, two, "--num-devices", "2")) is None  # the ranks trained
    out = capfd.readouterr().out.splitlines()
    assert sum(line.startswith("epoch 0:") for line in out) == 1
    summaries = [json.loads(line) for line in out if line.startswith("{")]
    assert len(summaries) == 1 and summaries[0]["ranks"] == 2 and summaries[0]["steps"] == 2
    log = _records(two / "full_pose_norm_flow.jsonl")
    assert len(log) == 2 and "_config" in log[0]
    _assert_records_close(log, _records(one / "full_pose_norm_flow.jsonl"))
    _assert_weights_close(two, one, ["full_flow.pt"])


@pytest.mark.parametrize("feed", ["memory", "packed"])
def test_lifter_trainer_on_two_ranks_matches_one_process(corpus, model_dir, feed):
    """3a on 2 ranks, in memory and from the pack, against one process on the
    same feed: the loss terms, the validation (rank 0 validates the whole
    test split, reducing nothing) and the written lifters."""
    flags = ["--packed-data", str(corpus / "train.lnks")] if feed == "packed" else []
    one, two = model_dir("one"), model_dir("two")
    stage3a.main(_args(corpus, one, *flags))
    stage3a.main(_args(corpus, two, *flags, "--num-devices", "2"))
    got, want = (_records(d / "left_right_lifter.jsonl") for d in (two, one))
    assert len(got) == 2 and {"pa_left", "val_nll", "val_unsup_loss"} <= got[1].keys()
    _assert_records_close(got, want)
    _assert_weights_close(two, one, LR_FILES)


def test_resume_on_two_ranks_is_bitwise_a_straight_run(corpus, model_dir):
    """Stage 1 on 2 ranks for 2 epochs, and for 1 epoch then --resume to 2:
    every rank restores from rank 0's run checkpoint, and the flow and the
    run checkpoint end bit for bit as the straight run's."""
    straight, resumed = model_dir("straight"), model_dir("resumed")
    stage1.main(_args(corpus, straight, "--num-devices", "2", "--epochs", "2"))
    stage1.main(_args(corpus, resumed, "--num-devices", "2"))
    stage1.main(_args(corpus, resumed, "--num-devices", "2", "--epochs", "2", "--resume"))
    for name in ("full_flow.pt", "full_flow_run.pt"):
        got, want = (torch.load(d / name, weights_only=True) for d in (resumed, straight))
        flat = [torch.utils._pytree.tree_flatten(x)[0] for x in (got, want)]
        assert len(flat[0]) == len(flat[1]) and all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(*flat)), name
    assert len(_records(resumed / "full_pose_norm_flow.jsonl")) == 4  # two runs, two epochs


@pytest.mark.parametrize("flags,message", [
    (["--distributed"], "^--distributed: .*not set; start the trainer under a launcher, "
                        "e.g. python -m torch.distributed.run"),
    (["--num-devices", "0"], "^--num-devices 0: at least 1 rank"),
    (["--device", "cuda", "--num-devices", "2"], r"^--num-devices 2: 0 CUDA device\(s\) visible"),
    (["--num-devices", "2", "--batch-size", "14"], "^--batch-size 14: not a multiple of 4 "),
    (["--num-devices", "3", "--batch-size", "15"], "^--batch-size 15: not a multiple of 6 "),
], ids=["outside-a-launcher", "no-ranks", "no-cuda", "odd-shards", "ragged-shards"])
def test_refusals(corpus, model_dir, monkeypatch, flags, message):
    """Refused before any data is read (the data path does not exist)."""
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(corpus, model_dir("refused"), *flags)
    args[args.index("--data") + 1] = str(corpus / "missing.pkl")
    with pytest.raises(SystemExit, match=message):
        stage3a.main(args)


def test_distributed_world_size_must_match_num_devices(corpus, model_dir, monkeypatch):
    """--distributed reads its world from the launcher: --num-devices, when
    given, must agree with it."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(SystemExit, match="^--num-devices 4: the launcher started WORLD_SIZE=2"):
        stage1.main(_args(corpus, model_dir("launcher"), "--distributed", "--num-devices", "4"))
