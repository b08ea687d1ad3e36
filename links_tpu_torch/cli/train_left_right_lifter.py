"""Stage 3a: train the left/right side lifters, unsupervised (counterpart of
links_tpu/cli/train_left_right_lifter.py). Both lifters take one step
together against the frozen full-pose and left/right flows; every epoch
validates PA-MPJPE (reflection='best'), N-MPJPE and the depth-tilt alarm on
the test split, and the unsupervised criteria (val_nll, val_unsup_loss) on a
fixed, seed-independent rotation draw.

Inputs: the dataset pickle (``--data``; with ``--packed-data`` the train
batches stream from an LNKS pack) and the frozen flows
``<model-dir>/{full_flow,flow_left,flow_right}.pt`` in FrEIA's layout (the
port's flow trainers write them, the JAX ones with ``--save-pt``). Outputs:
``<model-dir>/{left,right}_side_lifter_final.pt`` in the reference layout
(``links_tpu_torch.cli.lift --model-dir`` serves them) at the end, the best
validated epoch's pair ``{left,right}_side_lifter_best.pt`` and its record
``lifter_left_right_best.meta.json`` (``--select-by``), the run checkpoint
``left_right_run.pt`` every ``--save-every`` epochs (``--resume`` goes on
from it), a JSONL log, one line per epoch on stdout and a one-line JSON
summary. ``--flip-guard K`` stops the run after K depth-flipped validation
epochs. ``--attention`` trains the 2-head attention lifters
(models/attention.py) in place of the MLP ones, with the same step, files
and lifecycle; their ``.pt`` files hold the module's state dict (the
reference has no such class), which ``lift``, ``eval_h36m``, ``serve`` and
stage 4 read as they read the MLP pair.

Usage:
    python -m links_tpu_torch.cli.train_left_right_lifter --data data/h36m_data.pkl \\
        --model-dir models -b 50 -t 10 -r 1 -o 1 -v 1 -l 1
"""

from __future__ import annotations

import argparse
import torch

from links_tpu_torch import metrics
from links_tpu_torch.cli import _common as C
from links_tpu_torch.config import LifterTrainConfig
from links_tpu_torch.core.nn import F32
from links_tpu_torch.models.attention import AttentionLifter
from links_tpu_torch.models.lifters import Lifter, StackedLifter
from links_tpu_torch.objectives.lifter import (
    LifterFrozen,
    left_right_loss,
    lift_left_right_eval,
)
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import TrainState, build_left_right_step

SIDE_JOINTS = 11


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


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Stage 3a: train the left/right side lifters (PyTorch port)")
    C.add_lifter_flags(parser)
    parser.add_argument("--attention", action="store_true",
                        help="train the 2-head attention lifter variant "
                             "(models/attention.py) instead of the MLP")
    C.add_select_by_flag(parser)
    C.add_flip_guard_flag(parser)
    C.add_common_flags(parser)
    C.add_train_flags(parser, bf16_opt_state_default=True, nll_cap_default=500.0)
    args = parser.parse_args(argv)
    C.refuse_unported(args)
    device = C.resolve_device(args.device)

    cfg = C.resolve_cfg(args, LifterTrainConfig(
        weight_bl=args.bl, depth=args.translation, weight_2d=args.rep2d,
        weight_3d=args.rot3d, weight_velocity=args.velocity, weight_likeli=args.likelihood))
    train_data, test_data, n_train, packed = C.load_train_test_or_packed(args)
    bone_means = C.resolve_bone_means(args, train_data).to(device)
    frozen = LifterFrozen(*(C.load_flow(args, name, device).requires_grad_(False)
                            for name in (C.FULL_FLOW, C.FLOW_LEFT, C.FLOW_RIGHT)))
    init = torch.Generator().manual_seed(args.seed)
    make = AttentionLifter if args.attention else Lifter
    stacked = StackedLifter(make(SIDE_JOINTS, generator=init),
                            make(SIDE_JOINTS, generator=init)).to(device)
    steps_per_epoch = n_train // cfg.batch_size
    state = TrainState(stacked, Adam(stacked.parameters(), cfg.optim, steps_per_epoch))
    step = build_left_right_step(frozen, cfg, bone_means)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = C.train_batches(train_data, packed, device)
    test_2d, test_3d = test_data.poses_2d.to(device), test_data.poses_3d.to(device)

    def on_epoch(epoch, rec):
        msg = f"loss={rec['loss']:.4f}"
        if C.due(args, epoch, cfg.n_epochs, "validate_every"):
            rec.update(_validate(stacked, test_2d, test_3d, cfg.depth))
            rec["pa_mean"] = (rec["pa_left"] + rec["pa_right"]) / 2
            rec.update(C.validate_unsup(
                lambda poses, u, e: left_right_loss(stacked, frozen, poses, u, e, cfg, F32,
                                                    bone_means), test_2d))
            msg += (f" pa_left={rec['pa_left']:.2f} pa_right={rec['pa_right']:.2f}"
                    f" n-mpjpe_l={rec['mpjpe_scaled_left']:.2f}")
        return msg

    C.clear_stage_artifacts(args, "left_right", [C.LIFTER_LR])
    result = C.run_training(
        args, cfg, step, state, data, gen, "left_right_lifter",
        {"learning_rate": cfg.optim.learning_rate, "BATCH_SIZE": cfg.batch_size,
         "N_epochs": cfg.n_epochs, "weight_bl": cfg.weight_bl, "depth": cfg.depth}, on_epoch,
        stage="left_right",
        save=lambda final: final and C.save_artifact(args, C.LIFTER_LR, stacked),
        tracker=C.BestTracker(C.select_metric(args, "pa_mean"), C.select_gate(args),
                              deferred=True),
        best={C.LIFTER_LR: stacked}, guard=C.FlipGuard(args.flip_guard))
    C.print_summary(cfg, state, device, result)
    return state


if __name__ == "__main__":
    main()
