"""The whole LInKs pipeline in one command (counterpart of
links_tpu/cli/run_pipeline.py): the port's stages 1, 2, 3a, 3b and 4 and
eval, in order, in one process, each retried after a crash with
``--resume`` (it goes on from its run checkpoint ``<stage>_run.pt``).

Flags the pipeline does not define go to every stage (eval gets only those
it defines: the trainers' own, such as ``--epochs``, are dropped for it);
``--stage-args`` adds flags for every stage, ``--eval-args`` for eval
alone. ``--use-best``/``--use-final`` go to stage 4 and eval.
``--lifter-seeds`` trains 3a and 3b once per seed in
``<model-dir>/seed<k>/`` (the flows linked in) and promotes the seed whose
best epoch scored lowest on its ``_best.meta.json`` sidecar: its final and
best weights, its sidecars and run checkpoint and curve are copied into
``--model-dir``, and a file the winner lacks is removed there, so no stale
sidecar describes the promoted weights.

Usage:
    python -m links_tpu_torch.cli.run_pipeline --data data/h36m_data.pkl \\
        [--stages 1,2,3a,3b,4,eval] [--retries 2] [--eval-args "--json --occlusion"]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import traceback
from pathlib import Path

from links_tpu_torch.cli import _common as C

STAGES = ("1", "2", "3a", "3b", "4", "eval")
# stage -> (the artifacts a seed sweep promotes, its run checkpoint's stage, its curve)
_SWEEP = {"3a": ((C.LIFTER_LR,), "left_right", "left_right_lifter.jsonl"),
          "3b": ((C.LIFTER_LEGS, C.LIFTER_TORSO), "leg_torso", "leg_torso_lifter.jsonl")}
_FLOW_FILES = tuple(f"{name}.pt" for name in (C.FULL_FLOW, C.FLOW_LEFT, C.FLOW_RIGHT,
                                              C.FLOW_LEGS, C.FLOW_TORSO))


def _forwarded_model_dir(flags) -> str:
    """The --model-dir the stages see: its last occurrence, as argparse reads it."""
    out = "models"
    for i, f in enumerate(flags):
        if f == "--model-dir" and i + 1 < len(flags):
            out = flags[i + 1]
        elif f.startswith("--model-dir="):
            out = f.split("=", 1)[1]
    return out


def _eval_flags(flags: list) -> list:
    """The flags of ``flags`` that eval defines, with their values."""
    from links_tpu_torch.cli.eval_h36m import build_parser

    known = build_parser()._option_string_actions
    out, i = [], 0
    while i < len(flags):
        j = i + 1
        while j < len(flags) and not flags[j].startswith("--"):
            j += 1
        if flags[i].split("=", 1)[0] in known:
            out += flags[i:j]
        i = j
    return out


def _best_record(model_dir: Path, name: str):
    """(epoch, metric, value) of artifact ``name``'s best epoch in
    ``model_dir``, from its sidecar, or None when its best weights or the
    sidecar are absent (a run whose selection gate vetoed every epoch keeps
    no best)."""
    args = argparse.Namespace(model_dir=model_dir)
    sidecar = C.artifact(args, f"{name}_best.meta.json")
    if not sidecar.exists() or not all(p.exists() for p in C.artifact_paths(args, name, True)):
        return None
    extra = json.loads(sidecar.read_text())
    metric = next((k for k in extra if k != "epoch"), None)
    if metric is None:
        return None
    return int(extra.get("epoch", -1)), metric, float(extra[metric])


def promote(stage: str, src_dir: Path, dst_dir: Path):
    """Copy seed directory ``src_dir``'s artifacts of ``stage`` ('3a' or
    '3b') into ``dst_dir``: the final and best weights and the sidecar of
    each artifact, the run checkpoint and the curve. A file that
    ``src_dir`` lacks is removed from ``dst_dir``."""
    names, run_stage, curve = _SWEEP[stage]
    src, dst = argparse.Namespace(model_dir=src_dir), argparse.Namespace(model_dir=dst_dir)
    pairs = [(src_dir / f, dst_dir / f) for f in (f"{run_stage}_run.pt", curve)]
    for name in names:
        for best in (False, True):
            pairs += zip(C.artifact_paths(src, name, best), C.artifact_paths(dst, name, best))
        pairs.append((C.artifact(src, f"{name}_best.meta.json"),
                      C.artifact(dst, f"{name}_best.meta.json")))
    for s, d in pairs:
        if s.exists():
            d.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(s, d)
        else:
            d.unlink(missing_ok=True)


def _drop_log(flags: list) -> list:
    kept, skip = [], False
    for f in flags:
        if skip:
            skip = False
        elif f == "--log":
            skip = True
        elif not f.startswith("--log="):
            kept.append(f)
    return kept


def _run_seed_sweep(stage: str, run_stage, flags: list, seeds: list):
    """Train stage 3a or 3b once per seed in ``<model-dir>/seed<k>/`` (the
    flows linked in) and promote the seed with the lowest best-epoch value
    of its selection metric into ``<model-dir>``. A seed that crashes
    through every retry, or keeps no best, is disqualified."""
    base = Path(_forwarded_model_dir(flags))
    names, _, curve = _SWEEP[stage]
    if "--log" in flags or any(f.startswith("--log=") for f in flags):
        print(f"[pipeline] --lifter-seeds: dropping the forwarded --log (each seed writes "
              f"<seed-dir>/{curve})", file=sys.stderr)
        flags = _drop_log(flags)
    scored = []
    for seed in seeds:
        sdir = base / f"seed{seed}"
        sdir.mkdir(parents=True, exist_ok=True)
        for f in _FLOW_FILES:
            src, dst = base / f, sdir / f
            if src.exists() and not dst.is_symlink() and not dst.exists():
                os.symlink(src.resolve(), dst)
        print(f"[pipeline] stage {stage} seed {seed} -> {sdir}")
        if not run_stage(flags + ["--model-dir", str(sdir), "--seed", str(seed)], fatal=False):
            print(f"[pipeline] stage {stage} seed {seed}: crashed through every retry; "
                  f"disqualified", file=sys.stderr)
            continue
        got = _best_record(sdir, names[0])
        if got is None:
            print(f"[pipeline] stage {stage} seed {seed}: no best weights (the selection gate "
                  f"vetoed every epoch); disqualified", file=sys.stderr)
            continue
        epoch, metric, value = got
        print(f"[pipeline] stage {stage} seed {seed}: best {metric}={value:.4f} @ epoch {epoch}")
        scored.append((value, seed, sdir, metric))
    if not scored:
        print(f"[pipeline] stage {stage}: every seed disqualified", file=sys.stderr)
        sys.exit(1)
    value, seed, sdir, metric = min(scored)
    print(f"[pipeline] stage {stage}: seed {seed} wins ({metric}={value:.4f}); promoting its "
          f"artifacts to {base}")
    promote(stage, sdir, base)


def _stage_main(stage: str):
    if stage == "1":
        from links_tpu_torch.cli.train_full_pose_norm_flow import main
    elif stage == "2":
        from links_tpu_torch.cli.train_part_norm_flows import main
    elif stage == "3a":
        from links_tpu_torch.cli.train_left_right_lifter import main
    elif stage == "3b":
        from links_tpu_torch.cli.train_leg_torso_lifter import main
    elif stage == "4":
        from links_tpu_torch.cli.train_occlusion_models import main
    elif stage == "eval":
        from links_tpu_torch.cli.eval_h36m import main
    else:
        raise ValueError(f"unknown stage {stage!r}")
    return main


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run the whole LInKs pipeline (PyTorch port)")
    parser.add_argument("--stages", default=",".join(STAGES),
                        help="comma-separated subset of 1,2,3a,3b,4,eval")
    parser.add_argument("--retries", type=int, default=2,
                        help="crash retries per stage (each resumes from the stage's run "
                             "checkpoint)")
    parser.add_argument("--stage-args", default="", help="extra flags for every stage")
    parser.add_argument("--lifter-seeds", default=None, metavar="S1,S2,..",
                        help="train stages 3a and 3b once per seed (in <model-dir>/seed<k>/, "
                             "the flows shared) and promote the seed whose best epoch scored "
                             "lowest on its selection metric; stages 4 and eval read it")
    parser.add_argument("--eval-args", default="",
                        help="extra flags for the eval stage alone (e.g. '--json --occlusion')")
    g = parser.add_mutually_exclusive_group()
    g.add_argument("--use-best", action="store_true",
                   help="stages 4 and eval require the lifters' best-epoch weights (they "
                        "prefer them by default when present)")
    g.add_argument("--use-final", action="store_true",
                   help="stages 4 and eval read the final weights even when best-epoch ones "
                        "exist")
    args, passthrough = parser.parse_known_args(argv)

    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = set(stages) - set(STAGES)
    if unknown:
        parser.error(f"unknown stages: {sorted(unknown)}")
    forwarded = passthrough + args.stage_args.split()
    seeds = ([int(s) for s in args.lifter_seeds.split(",") if s.strip()]
             if args.lifter_seeds else None)
    for stage in stages:
        stage_main = _stage_main(stage)

        def run_stage(flags, fatal=True, stage=stage, stage_main=stage_main):
            attempts = args.retries + 1
            for attempt in range(attempts):
                f2 = list(flags) + (["--resume"] if stage != "eval" and attempt else [])
                try:
                    print(f"[pipeline] stage {stage} (attempt {attempt + 1}/{attempts})")
                    stage_main(f2)
                    return True
                except Exception:
                    traceback.print_exc()
                    if attempt + 1 == attempts:
                        print(f"[pipeline] stage {stage} failed after {attempts} attempts",
                              file=sys.stderr)
                        if fatal:
                            sys.exit(1)
                        return False
                    print(f"[pipeline] stage {stage} crashed; resuming")

        flags = list(forwarded)
        if stage in ("4", "eval"):
            flags += ["--use-best"] * args.use_best + ["--use-final"] * args.use_final
        if stage == "eval":
            flags = _eval_flags(flags) + args.eval_args.split()
        if seeds and stage in _SWEEP:
            _run_seed_sweep(stage, run_stage, flags, seeds)
        else:
            run_stage(flags)


if __name__ == "__main__":
    main()
