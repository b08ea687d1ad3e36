"""``links_tpu_torch.cli.run_pipeline`` on the CPU: stages 1 -> eval in one
command at narrow widths on a tiny synthetic corpus; a crashed stage retried
with --resume; the --lifter-seeds sweep promoting its winner with the
winner's sidecar; the stage calls against links_tpu's pipeline on the same
flags."""

import contextlib
import io
import json

import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu.cli import run_pipeline as jpipe
from links_tpu_torch.cli import _common as C
from links_tpu_torch.cli import run_pipeline as tpipe
from links_tpu_torch.train import loop
from test_torch_lifecycle import narrow

FLAGS = ["--synthetic", "--synthetic-n", "8", "--synthetic-test-n", "20", "--device", "cpu",
         "--batch-size", "16"]


def _pipeline(ws, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tpipe.main(["--data", str(ws / "s.pkl"), "--model-dir", str(ws / "m"), *FLAGS, *argv])
    return out.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """Stages 1 -> eval, two epochs each, in one command."""
    ws = tmp_path_factory.mktemp("pipeline")
    with pytest.MonkeyPatch.context() as mp:
        narrow(mp)
        lines = _pipeline(ws, "--epochs", "2", "--eval-args", "--json --occlusion")
    return ws, lines


def test_one_command_trains_and_evaluates(full_run):
    ws, lines = full_run
    stages = [x for x in lines if x.startswith("[pipeline] stage")]
    assert stages == [f"[pipeline] stage {s} (attempt 1/3)" for s in tpipe.STAGES]
    results = json.loads(lines[-1])
    assert {"pa_mpjpe", "n_mpjpe", "pck", "auc", "cps", "pa_torso", "n_mpjpe_la"} <= set(results)
    for name in ("full_flow.pt", "flow_torso.pt", *C.LR_LIFTERS_BEST, "torso_lifter.pt",
                 "occlusion_model_weights_best/torso_estimator.pt", "occlusion_run.pt"):
        assert (ws / "m" / name).exists(), name


def test_a_crashed_stage_resumes(full_run, tmp_path, monkeypatch):
    """Stage 3a raises in its second epoch; the retry, with --resume, goes on
    from the run checkpoint of the first and ends as the straight run of the
    full pipeline did."""
    ws, _ = full_run
    m = tmp_path / "m"
    m.mkdir()
    for f in ("full_flow.pt", "flow_left.pt", "flow_right.pt"):
        (m / f).write_bytes((ws / "m" / f).read_bytes())
    (tmp_path / "s.pkl").write_bytes((ws / "s.pkl").read_bytes())
    narrow(monkeypatch)
    calls, run_epoch = [], loop.run_epoch

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected crash")
        return run_epoch(*a, **k)

    monkeypatch.setattr(loop, "run_epoch", flaky)
    argvs, main = [], tpipe._stage_main("3a")
    monkeypatch.setattr(tpipe, "_stage_main", lambda stage: lambda argv: (
        argvs.append(argv), main(argv))[1])
    lines = _pipeline(tmp_path, "--epochs", "2", "--stages", "3a")
    assert "[pipeline] stage 3a crashed; resuming" in lines and len(calls) == 3
    assert "--resume" not in argvs[0] and argvs[1] == argvs[0] + ["--resume"]
    a, b = (torch.load(d / "left_right_run.pt", weights_only=True) for d in (ws / "m", m))
    assert a["next_epoch"] == b["next_epoch"] == 2
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])


def test_a_stage_that_keeps_crashing_stops_the_pipeline(tmp_path, monkeypatch):
    monkeypatch.setattr(tpipe, "_stage_main", lambda stage: lambda argv: 1 / 0)
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stderr(io.StringIO()):
        _pipeline(tmp_path, "--stages", "1", "--retries", "1")
    assert exc.value.code == 1


def test_lifter_seeds_promote_the_winner_with_its_sidecar(full_run, tmp_path, monkeypatch):
    ws, _ = full_run
    m = tmp_path / "m"
    m.mkdir()
    for f in ("full_flow.pt", "flow_left.pt", "flow_right.pt"):
        (m / f).write_bytes((ws / "m" / f).read_bytes())
    (tmp_path / "s.pkl").write_bytes((ws / "s.pkl").read_bytes())
    # a selection record of an earlier run that the winner must replace
    (m / "lifter_left_right_best.meta.json").write_text('{"epoch": 9, "pa_mean": -1.0}')
    narrow(monkeypatch)
    lines = _pipeline(tmp_path, "--epochs", "1", "--stages", "3a", "--lifter-seeds", "0,1")
    scores = {s: json.loads((m / f"seed{s}" / "lifter_left_right_best.meta.json").read_text())
              for s in (0, 1)}
    winner = min(scores, key=lambda s: scores[s]["pa_mean"])
    assert f"[pipeline] stage 3a: seed {winner} wins" in " ".join(lines)
    assert json.loads((m / "lifter_left_right_best.meta.json").read_text()) == scores[winner]
    for f in (*C.LR_LIFTERS, *C.LR_LIFTERS_BEST, "left_right_run.pt"):
        assert (m / f).read_bytes() == (m / f"seed{winner}" / f).read_bytes(), f
    assert (m / "seed0" / "full_flow.pt").is_symlink()


def test_promotion_drops_a_sidecar_the_winner_lacks(tmp_path):
    src, dst = tmp_path / "seed1", tmp_path / "base"
    for d in (src, dst):
        d.mkdir()
    for f in ("leg_lifter.pt", "leg_lifter_best.pt", "torso_lifter.pt", "torso_lifter_best.pt",
              "lifter_legs_best.meta.json"):
        (src / f).write_text(f"new {f}")
    for f in ("lifter_legs_best.meta.json", "lifter_torso_best.meta.json", "leg_torso_run.pt"):
        (dst / f).write_text(f"stale {f}")
    tpipe.promote("3b", src, dst)
    assert (dst / "lifter_legs_best.meta.json").read_text() == "new lifter_legs_best.meta.json"
    assert (dst / "torso_lifter_best.pt").read_text() == "new torso_lifter_best.pt"
    assert not (dst / "lifter_torso_best.meta.json").exists()
    assert not (dst / "leg_torso_run.pt").exists()


def test_eval_gets_only_its_own_flags():
    assert tpipe._eval_flags(["--data", "x.pkl", "--epochs", "2", "--device", "cpu",
                              "--synthetic", "--save-every=3", "--test-scale", "auto"]) == [
        "--data", "x.pkl", "--device", "cpu", "--synthetic", "--test-scale", "auto"]


@pytest.mark.parametrize("argv", [
    ["--stages", "1,2,eval", "--use-best", "--eval-args", "--json --occlusion"],
    ["--stages", "3a,3b,4,eval", "--use-final", "--stage-args", "--device cpu", "--retries",
     "1"],
    ["--stages", "4", "--retries", "2"],
])
def test_stage_calls_match_the_jax_pipeline(tmp_path, argv):
    """Both pipelines call the same stages with the same flags, each crash
    retried with --resume (every stage here crashes once)."""
    def recorder(calls):
        def stage_main(stage):
            def run(flags):
                calls.append((stage, list(flags)))
                if sum(s == stage for s, _ in calls) == 1:
                    raise RuntimeError("injected crash")
            return run
        return stage_main

    flags = ["--data", str(tmp_path / "d.pkl"), "--model-dir", str(tmp_path), "--seed", "3"]
    got, want = [], []
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        mp.setattr(tpipe, "_stage_main", recorder(got))
        mp.setattr(jpipe, "_stage_main", recorder(want))
        tpipe.main(flags + argv)
        jpipe.main(flags + argv)
    assert got == want and len(got) == 2 * len(argv[1].split(","))


def test_best_record_needs_weights_and_sidecar(tmp_path):
    assert tpipe._best_record(tmp_path, C.LIFTER_LEGS) is None
    (tmp_path / "lifter_legs_best.meta.json").write_text('{"epoch": 2, "pa": 3.5}')
    assert tpipe._best_record(tmp_path, C.LIFTER_LEGS) is None
    (tmp_path / "leg_lifter_best.pt").write_bytes(b"")
    assert tpipe._best_record(tmp_path, C.LIFTER_LEGS) == (2, "pa", 3.5)
    assert tpipe._forwarded_model_dir(["--model-dir", "a", "--model-dir=b"]) == \
        jpipe._forwarded_model_dir(["--model-dir", "a", "--model-dir=b"]) == "b"
