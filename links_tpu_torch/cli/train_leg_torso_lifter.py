"""Stage 3b: train the legs and torso lifters, unsupervised (counterpart of
links_tpu/cli/train_leg_torso_lifter.py). Both lifters take one step
together against the frozen full-pose, legs and torso flows; every due epoch
validates PA-MPJPE (reflection='best'), N-MPJPE, AUC, PCK and the depth-tilt
alarm on the test split, and the unsupervised criteria (val_nll,
val_unsup_loss) on a fixed, seed-independent rotation draw.

Inputs: the dataset pickle (``--data``; with ``--packed-data`` the train
batches stream from an LNKS pack) and the frozen flows
``<model-dir>/{full_flow,flow_legs,flow_torso}.pt`` in FrEIA's layout (the
port's flow trainers write them). Outputs: ``<model-dir>/{leg,torso}_lifter.pt``
in the reference layout (``links_tpu_torch.cli.lift --mode leg_torso``
serves them) at the end, the best validated epoch's
``{leg,torso}_lifter_best.pt`` and their records
``lifter_{legs,torso}_best.meta.json`` (``--select-by``), the run checkpoint
``leg_torso_run.pt`` every ``--save-every`` epochs (``--resume`` goes on
from it), a JSONL log, one line per epoch on stdout and a one-line JSON
summary. ``--flip-guard K`` stops the run after K depth-flipped validation
epochs.

``--num-devices N`` trains on N local data-parallel ranks (each on its rows
of every batch; ``--device cpu`` for gloo ranks on the CPU) and
``--distributed`` on the ranks of a launcher (``python -m
torch.distributed.run``); rank 0 writes every output (train/parallel.py).

Usage:
    python -m links_tpu_torch.cli.train_leg_torso_lifter --data data/h36m_data.pkl \\
        --model-dir models
"""

from __future__ import annotations

import argparse
import torch

from links_tpu_torch import metrics
from links_tpu_torch.cli import _common as C
from links_tpu_torch.config import LifterTrainConfig
from links_tpu_torch.core.nn import F32
from links_tpu_torch.models.lifters import LEG_JOINTS, TORSO_JOINTS, LegTorsoLifter, Lifter
from links_tpu_torch.objectives.lifter import LifterFrozen, leg_torso_loss, lift_leg_torso_eval
from links_tpu_torch.train import parallel
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import TrainState, build_leg_torso_step


@torch.no_grad()
def _validate(model, test_2d, test_3d, depth: float) -> dict[str, float]:
    """PA-MPJPE, N-MPJPE, AUC, PCK and the depth-tilt alarm of the f32 lift,
    as the JAX package validates."""
    pred = lift_leg_torso_eval(model.legs, model.torso, test_2d, depth, F32)
    out = {"pa": metrics.pa_mpjpe(test_3d, pred).mean(),
           "mpjpe_scaled": metrics.n_mpjpe(test_3d, pred).mean(),
           "auc": metrics.auc(test_3d, pred),
           "pck": metrics.pck(test_3d, pred),
           "val_tilt": metrics.depth_tilt_score(pred)}
    return dict(zip(out, torch.stack(list(out.values())).tolist()))


def main(argv=None, group=None):
    parser = argparse.ArgumentParser(
        description="Stage 3b: train the legs/torso lifters (PyTorch port)")
    C.add_lifter_flags(parser)
    C.add_select_by_flag(parser)
    C.add_flip_guard_flag(parser)
    C.add_common_flags(parser)
    C.add_train_flags(parser, bf16_opt_state_default=True, nll_cap_default=500.0)
    args = parser.parse_args(argv)
    cfg = C.resolve_cfg(args, LifterTrainConfig(
        weight_bl=args.bl, depth=args.translation, weight_2d=args.rep2d,
        weight_3d=args.rot3d, weight_velocity=args.velocity, weight_likeli=args.likelihood))
    group, device = C.start_ranks(args, cfg, main, argv, group, pairs=True)
    if group is C.SPAWNED:
        return None  # the ranks have trained the stage
    train_data, test_data, n_train, packed = C.load_train_test_or_packed(args, group=group)
    bone_means = C.resolve_bone_means(args, train_data).to(device)
    frozen = LifterFrozen(*(C.load_flow(args, name, device).requires_grad_(False)
                            for name in (C.FULL_FLOW, C.FLOW_LEGS, C.FLOW_TORSO)))
    init = torch.Generator().manual_seed(args.seed)
    model = parallel.replicate(LegTorsoLifter(Lifter(LEG_JOINTS, generator=init),
                                              Lifter(TORSO_JOINTS, generator=init)).to(device),
                               group)
    steps_per_epoch = parallel.trimmed(n_train, group) // cfg.batch_size
    state = TrainState(model, Adam(model.parameters(), cfg.optim, steps_per_epoch))
    step = build_leg_torso_step(frozen, cfg, bone_means, group)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = C.train_batches(train_data, packed, device, group)
    test_2d, test_3d = test_data.poses_2d.to(device), test_data.poses_3d.to(device)

    def on_epoch(epoch, rec):
        msg = f"loss={rec['loss']:.4f}"
        if C.due(args, epoch, cfg.n_epochs, "validate_every"):
            rec.update(_validate(model, test_2d, test_3d, cfg.depth))
            rec.update(C.validate_unsup(
                lambda poses, u, e: leg_torso_loss(model.legs, model.torso, frozen, poses, u, e,
                                                   cfg, F32, bone_means), test_2d))
            msg += (f" pa={rec['pa']:.2f} n-mpjpe={rec['mpjpe_scaled']:.2f}"
                    f" pck={rec['pck']:.2f}")
        return msg

    def save(final):
        if final:
            C.save_artifact(args, C.LIFTER_LEGS, model.legs)
            C.save_artifact(args, C.LIFTER_TORSO, model.torso)

    C.clear_stage_artifacts(args, "leg_torso", [C.LIFTER_LEGS, C.LIFTER_TORSO], group)
    result = C.run_training(
        args, cfg, step, state, data, gen, "leg_torso_lifter",
        {"learning_rate": cfg.optim.learning_rate, "BATCH_SIZE": cfg.batch_size,
         "N_epochs": cfg.n_epochs, "weight_bl": cfg.weight_bl, "depth": cfg.depth}, on_epoch,
        stage="leg_torso", save=save,
        tracker=C.BestTracker(C.select_metric(args, "pa"), C.select_gate(args), deferred=True),
        best={C.LIFTER_LEGS: model.legs, C.LIFTER_TORSO: model.torso},
        guard=C.FlipGuard(args.flip_guard), group=group)
    C.print_summary(cfg, state, device, result, group)
    return state


if __name__ == "__main__":
    main()
