"""Stage 3a: train the left/right side lifters, unsupervised (counterpart of
links_tpu/cli/train_left_right_lifter.py). Both lifters take one step
together against the frozen full-pose and left/right flows; every epoch
validates PA-MPJPE (reflection='best'), N-MPJPE and the depth-tilt alarm on
the test split, and the unsupervised criteria (val_nll, val_unsup_loss) on a
fixed, seed-independent rotation draw.

Inputs: the dataset pickle (``--data``) and the frozen flows
``<model-dir>/{full_flow,flow_left,flow_right}.pt`` in FrEIA's layout (the
JAX flow trainers write them with ``--save-pt``). Outputs:
``<model-dir>/{left,right}_side_lifter_final.pt`` in the reference layout
(``links_tpu_torch.cli.lift --left-pt/--right-pt`` serves them), a JSONL
log, one line per epoch on stdout and a one-line JSON summary.

Usage:
    python -m links_tpu_torch.cli.train_left_right_lifter --data data/h36m_data.pkl \\
        --model-dir models -b 50 -t 10 -r 1 -o 1 -v 1 -l 1
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from links_tpu_torch import metrics
from links_tpu_torch.ckpt.torch_io import save_lifter_pt
from links_tpu_torch.cli import _common as C
from links_tpu_torch.config import LifterTrainConfig
from links_tpu_torch.core.nn import F32
from links_tpu_torch.models.lifters import Lifter, StackedLifter
from links_tpu_torch.objectives.lifter import (
    LifterFrozen,
    left_right_loss,
    lift_left_right_eval,
)
from links_tpu_torch.train.loop import run_epoch
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import TrainState, build_left_right_step

SIDE_JOINTS = 11
# seed of the unsupervised validation's rotation draws: fixed and independent
# of --seed, so the criterion compares across epochs and across seeds
VAL_SEED = 20_000


@torch.no_grad()
def _validate(stacked, test_2d, test_3d, depth: float) -> dict[str, float]:
    """PA-MPJPE and N-MPJPE of both lift choices and the depth-tilt alarm
    (f32 lifts, as the JAX package validates)."""
    out, tilt = {}, 0.0
    for choice in ("left", "right"):
        pred = lift_left_right_eval(stacked, test_2d, depth, choice, F32)
        out[f"pa_{choice}"] = metrics.pa_mpjpe(test_3d, pred).mean()
        out[f"mpjpe_scaled_{choice}"] = metrics.n_mpjpe(test_3d, pred).mean()
        tilt = tilt + metrics.depth_tilt_score(pred)
    out["val_tilt"] = tilt / 2.0
    return dict(zip(out, torch.stack(list(out.values())).tolist()))


@torch.no_grad()
def _validate_unsup(stacked, frozen, test_2d, cfg) -> dict[str, float]:
    """The stage's own objective on the test split (no 3D ground truth):
    ``val_nll`` is its flow-likelihood term, ``val_unsup_loss`` the whole
    weighted sum."""
    n2 = test_2d.shape[0] // 2 * 2  # the pairwise term needs an even batch
    g = torch.Generator(device=test_2d.device).manual_seed(VAL_SEED)
    u_azim = torch.rand(n2, 1, generator=g, device=test_2d.device)
    eps_elev = torch.randn(n2, 1, generator=g, device=test_2d.device)
    loss, aux = left_right_loss(stacked, frozen, test_2d[:n2], u_azim, eps_elev, cfg, F32)
    return dict(zip(("val_nll", "val_unsup_loss"), torch.stack([aux["likeli"], loss]).tolist()))


def _log(fh, record: dict, **extra):
    """One JSON record per line (the JAX package's MetricLogger format)."""
    fh.write(json.dumps(dict(record, _time=time.time(), **extra)) + "\n")
    fh.flush()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Stage 3a: train the left/right side lifters (PyTorch port)")
    C.add_lifter_flags(parser)
    parser.add_argument("--bone-means", choices=["h36m", "mpi_vnect_interesting", "data"],
                        default="h36m",
                        help="bone-relation prior means (only h36m is ported yet)")
    parser.add_argument("--attention", action="store_true", help="(not yet ported)")
    parser.add_argument("--select-by", default=None, help="(not yet ported)")
    parser.add_argument("--flip-guard", type=int, default=None, help="(not yet ported)")
    C.add_common_flags(parser)
    C.add_train_flags(parser)
    args = parser.parse_args(argv)
    C.refuse_unported(args, C.UNPORTED_TRAIN_FLAGS + ("attention", "select_by", "flip_guard"))
    if args.bone_means != "h36m":
        raise SystemExit(f"--bone-means {args.bone_means}: not yet ported to links_tpu_torch; "
                         f"only the h36m means are")
    device = C.resolve_device(args.device)

    cfg = C.resolve_cfg(args, LifterTrainConfig(
        weight_bl=args.bl, depth=args.translation, weight_2d=args.rep2d,
        weight_3d=args.rot3d, weight_velocity=args.velocity, weight_likeli=args.likelihood))
    train_data, test_data = C.load_train_test(args)
    frozen = LifterFrozen(*(C.load_flow(args, name, device).requires_grad_(False)
                            for name in (C.FULL_FLOW, C.FLOW_LEFT, C.FLOW_RIGHT)))
    init = torch.Generator().manual_seed(args.seed)
    stacked = StackedLifter(Lifter(SIDE_JOINTS, generator=init),
                            Lifter(SIDE_JOINTS, generator=init)).to(device)
    steps_per_epoch = len(train_data) // cfg.batch_size
    state = TrainState(stacked, Adam(stacked.parameters(), cfg.optim, steps_per_epoch))
    step = build_left_right_step(frozen, cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = train_data.poses_2d.to(device)
    test_2d, test_3d = test_data.poses_2d.to(device), test_data.poses_3d.to(device)

    model_dir = Path(args.model_dir)
    log_path = Path(args.log) if args.log else model_dir / "left_right_lifter.jsonl"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    step_seconds, rec = 0.0, {}
    with log_path.open("a") as log:
        _log(log, {"_config": {"learning_rate": cfg.optim.learning_rate,
                               "BATCH_SIZE": cfg.batch_size, "N_epochs": cfg.n_epochs,
                               "weight_bl": cfg.weight_bl, "depth": cfg.depth}})
        for epoch in range(cfg.n_epochs):
            t0 = time.perf_counter()
            rec = run_epoch(step, state, data, cfg.batch_size, gen)
            step_seconds += time.perf_counter() - t0  # run_epoch ends with a device read
            msg = f"epoch {epoch}: loss={rec['loss']:.4f}"
            if C.due(args, epoch, cfg.n_epochs, "validate_every"):
                rec.update(_validate(stacked, test_2d, test_3d, cfg.depth))
                rec["pa_mean"] = (rec["pa_left"] + rec["pa_right"]) / 2
                rec.update(_validate_unsup(stacked, frozen, test_2d, cfg))
                msg += (f" pa_left={rec['pa_left']:.2f} pa_right={rec['pa_right']:.2f}"
                        f" n-mpjpe_l={rec['mpjpe_scaled_left']:.2f}")
            rec["epoch"] = epoch
            _log(log, rec, _step=epoch)
            print(msg, flush=True)

    model_dir.mkdir(parents=True, exist_ok=True)
    save_lifter_pt(stacked.left, model_dir / "left_side_lifter_final.pt")
    save_lifter_pt(stacked.right, model_dir / "right_side_lifter_final.pt")
    poses = state.step * cfg.batch_size
    print(json.dumps({
        "epochs": cfg.n_epochs, "steps": state.step, "batch": cfg.batch_size,
        "device": str(device), "seconds": round(step_seconds, 4),
        "poses_per_sec": round(poses / step_seconds, 1) if step_seconds > 0 else None,
        "last": {k: v for k, v in rec.items() if k != "epoch"},
    }))
    return state


if __name__ == "__main__":
    main()
