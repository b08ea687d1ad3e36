"""The JAX trainers' ``--save-pt`` and ``--wandb`` on the port's five trainers:
``--save-pt`` is accepted and says, once, that it adds nothing (the port
always writes its reference-layout ``.pt`` files); ``--wandb`` mirrors the
records to wandb as the JAX package's ``MetricLogger`` does when the package
imports, and otherwise warns once and keeps the JSONL log."""

import json
import sys
import types

import pytest

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu_torch.cli import train_full_pose_norm_flow as stage1
from links_tpu_torch.cli import train_left_right_lifter as stage3a
from links_tpu_torch.cli import train_leg_torso_lifter as stage3b
from links_tpu_torch.cli import train_occlusion_models as stage4
from links_tpu_torch.cli import train_part_norm_flows as stage2
from links_tpu_torch.data.synthetic import write_synthetic_pickle

TRAINERS = {"stage1": stage1, "stage2": stage2, "3a": stage3a, "3b": stage3b, "stage4": stage4}
SAVE_PT_NOTE = "--save-pt: nothing to add"


def _args(ws, *flags):
    return ["--data", str(ws / "synthetic.pkl"), "--model-dir", str(ws / "models"),
            "--device", "cpu", "--batch-size", "16", *flags]


@pytest.mark.parametrize("name", TRAINERS)
def test_save_pt_is_accepted_and_says_it_adds_nothing(name, tmp_path, capsys):
    """Every trainer accepts --save-pt and says so once on stderr before it
    reads its data (here missing, so the run ends before a step)."""
    with pytest.raises(FileNotFoundError, match="synthetic.pkl"):
        TRAINERS[name].main(_args(tmp_path, "--save-pt", "--epochs", "1"))
    assert capsys.readouterr().err.count(SAVE_PT_NOTE) == 1


@pytest.fixture
def corpus(tmp_path):
    write_synthetic_pickle(tmp_path / "synthetic.pkl", n_per_subject=8, seed=0,
                           n_test_per_subject=4)
    return tmp_path


def _log(ws):
    return [json.loads(line) for line in (ws / "models" / "full_pose_norm_flow.jsonl")
            .read_text().splitlines()]


def test_wandb_without_the_package_warns_once_and_keeps_the_jsonl_log(corpus, capsys,
                                                                      monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ModuleNotFoundError
    stage1.main(_args(corpus, "--wandb", "--epochs", "0"))
    err = capsys.readouterr().err
    assert err.count("--wandb:") == 1 and "ModuleNotFoundError" in err
    assert "JSONL log only" in err
    assert _log(corpus)[0]["_config"]["BATCH_SIZE"] == 16


def test_wandb_mirrors_every_record(corpus, capsys, monkeypatch):
    """With a package that imports, the run is started under project LInKs,
    named after the stage, receives each epoch's record as the JSONL log
    holds it, and is finished."""
    calls = []
    run = types.SimpleNamespace(name="run-1")
    fake = types.ModuleType("wandb")
    fake.run = run
    fake.init = lambda **kw: calls.append(("init", kw))
    fake.log = lambda rec: calls.append(("log", dict(rec)))
    fake.finish = lambda: calls.append(("finish",))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    stage1.main(_args(corpus, "--wandb", "--epochs", "2"))
    assert "--wandb:" not in capsys.readouterr().err
    assert calls[0] == ("init", {"project": "LInKs", "config": _log(corpus)[0]["_config"]})
    assert run.name == "full_pose_norm_flow run-1" and calls[-1] == ("finish",)
    logged = [c[1] for c in calls if c[0] == "log"]
    want = [{k: v for k, v in r.items() if not k.startswith("_")} for r in _log(corpus)[1:]]
    assert len(logged) == 2 and logged == want
