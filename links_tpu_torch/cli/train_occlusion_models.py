"""Stage 4: train the eight occlusion-completion models against the frozen
lifters' pseudo-3D (counterpart of links_tpu/cli/train_occlusion_models.py).
Every due epoch validates the eight occlusion scenarios, built from mixed
lifter combinations, on the test split (PA-MPJPE with reflection='best' and
N-MPJPE per scenario, and their mean PA), and the training signal itself on
the test split's 2D (``val_mse``, no 3D ground truth) on a fixed,
seed-independent rotation draw.

Inputs: the dataset pickle (``--data``; with ``--packed-data`` the train
batches stream from an LNKS pack) and the four frozen lifters in the
reference layout: ``<model-dir>/{left,right}_side_lifter_final.pt`` (or the
``{left,right}_lifter.pt`` pair, or ``--left-pt/--right-pt``) and
``<model-dir>/{leg,torso}_lifter.pt`` (the port's stage-3 trainers write
them). Outputs: ``<model-dir>/occlusion_model_weights/<name>_estimator.pt``
for the eight completers, in the reference layout (``links_tpu_torch.cli.lift
--scenario`` serves them) at the end, the best validated epoch's in
``occlusion_model_weights_best/`` with its record
``occlusion_models_best.meta.json`` (``--select-by pa|mse``), the run
checkpoint ``occlusion_run.pt`` every ``--save-every`` epochs (``--resume``
goes on from it), a JSONL log, one line per epoch on stdout and a one-line
JSON summary. The frozen lifters are read as ``--use-best``/``--use-final``
say (by default their best epoch's when the 3a/3b trainers wrote one).

``--num-devices N`` trains on N local data-parallel ranks (each on its rows
of every batch; ``--device cpu`` for gloo ranks on the CPU) and
``--distributed`` on the ranks of a launcher (``python -m
torch.distributed.run``); rank 0 writes every output (train/parallel.py).

Usage:
    python -m links_tpu_torch.cli.train_occlusion_models --data data/h36m_data.pkl \\
        --model-dir models
"""

from __future__ import annotations

import argparse
import dataclasses
import functools

import torch

from links_tpu_torch import metrics
from links_tpu_torch.cli import _common as C
from links_tpu_torch.config import OcclusionTrainConfig
from links_tpu_torch.core.nn import F32
from links_tpu_torch.models.completers import Completers
from links_tpu_torch.objectives import occlusion as occ
from links_tpu_torch.train import parallel
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import TrainState, build_occlusion_step, draw_occlusion

# the JAX package's criterion draws its rotations as occlusion_loss's default
VAL_ROTATIONS = 2


@torch.no_grad()
def _validate(completers, lifters, test_2d, test_3d, depth: float) -> dict[str, float]:
    """PA-MPJPE and N-MPJPE of each scenario's f32 infilled pose, as the JAX
    package validates."""
    out = {}
    for name, pred in occ.occlusion_validation_poses(completers, lifters, test_2d, depth).items():
        out[f"pa_{name}"] = metrics.pa_mpjpe(test_3d, pred).mean()
        out[f"mpjpe_scaled_{name}"] = metrics.n_mpjpe(test_3d, pred).mean()
    return dict(zip(out, torch.stack(list(out.values())).tolist()))


@torch.no_grad()
def _validate_unsup(completers, lifters, test_2d, depth: float) -> dict[str, float]:
    """The stage's own loss (f32, no input noise) against the frozen lifters'
    pseudo-3D of the test split's 2D, on rotations drawn from a generator
    seeded with ``VAL_SEED``: a criterion with no 3D ground truth."""
    g = torch.Generator(device=test_2d.device).manual_seed(C.VAL_SEED)
    u_rot = torch.rand(VAL_ROTATIONS, test_2d.shape[0], 1, generator=g, device=test_2d.device)
    pose_3d = occ.pseudo_3d_from_lifters(lifters["legs"], lifters["torso"], test_2d, depth)
    loss, _ = occ.occlusion_loss(completers, pose_3d, u_rot)
    return {"val_mse": float(loss)}


def main(argv=None, group=None):
    parser = argparse.ArgumentParser(
        description="Stage 4: train the eight occlusion completers (PyTorch port)")
    parser.add_argument("-n", "--num_bases", type=int, default=26,
                        help="number of PCA bases (kept for the reference's flag set; inert: "
                             "logged in the _config record only)")
    parser.add_argument("--aug-rotations", type=int, default=2,
                        help="cumulative random y-rotations of the pseudo-3D per step "
                             "(the reference's 2)")
    parser.add_argument("--aug-input-noise", type=float, default=0.0,
                        help="Gaussian jitter of the completers' inputs only (targets stay "
                             "clean), in the root-centered reconstruction space's units")
    parser.add_argument("--weight-decay", type=float, default=None,
                        help="override Adam's weight decay for this stage (default 1e-5)")
    parser.add_argument("--select-by", choices=["pa", "mse"], default="pa",
                        help="criterion of the best epoch: 'pa' = the mean scenario PA-MPJPE "
                             "against the test split's 3D ground truth (used for selection "
                             "only); 'mse' = the completers' loss against the frozen "
                             "lifters' pseudo-3D of the test split's 2D, without ground "
                             "truth. Both are logged every validation epoch")
    C.add_lifter_flags(parser)
    C.add_common_flags(parser)
    C.add_train_flags(parser)
    C.add_lr_pt_flags(parser)
    C.add_use_best_flag(parser)
    args = parser.parse_args(argv)
    cfg = C.resolve_cfg(args, OcclusionTrainConfig(
        depth=args.translation, n_rot=args.aug_rotations, input_noise=args.aug_input_noise))
    if args.weight_decay is not None:
        cfg = dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, weight_decay=args.weight_decay))
    group, device = C.start_ranks(args, cfg, main, argv, group)
    if group is C.SPAWNED:
        return None  # the ranks have trained the stage
    train_data, test_data, n_train, packed = C.load_train_test_or_packed(args, group=group)
    lifters = {k: v.requires_grad_(False) for k, v in C.load_all_lifters(args, device).items()}
    completers = parallel.replicate(
        Completers(generator=torch.Generator().manual_seed(args.seed)).to(device), group)
    steps_per_epoch = parallel.trimmed(n_train, group) // cfg.batch_size
    state = TrainState(completers, Adam(completers.parameters(), cfg.optim, steps_per_epoch))
    step = build_occlusion_step(lifters["legs"], lifters["torso"], cfg, group)
    draw = functools.partial(draw_occlusion, n_rot=cfg.n_rot, input_noise=cfg.input_noise)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = C.train_batches(train_data, packed, device, group)
    test_2d, test_3d = test_data.poses_2d.to(device), test_data.poses_3d.to(device)

    def on_epoch(epoch, rec):
        msg = f"loss={rec['loss']:.4f}"
        if C.due(args, epoch, cfg.n_epochs, "validate_every"):
            val = _validate(completers, lifters, test_2d, test_3d, cfg.depth)
            rec.update(val)
            rec.update(_validate_unsup(completers, lifters, test_2d, cfg.depth))
            pa = [v for k, v in val.items() if k.startswith("pa_")]
            rec["pa_scenario_mean"] = sum(pa) / len(pa)
            msg += f" pa_left={rec['pa_left']:.2f} pa_torso={rec['pa_torso']:.2f}"
        return msg

    C.clear_stage_artifacts(args, "occlusion", [C.OCCLUSION], group)
    result = C.run_training(
        args, cfg, step, state, data, gen, "occlusion_models",
        {"num_bases": args.num_bases, "learning_rate": cfg.optim.learning_rate,
         "BATCH_SIZE": cfg.batch_size, "N_epochs": cfg.n_epochs, "depth": cfg.depth,
         "n_rot": cfg.n_rot, "input_noise": cfg.input_noise}, on_epoch, draw,
        stage="occlusion",
        save=lambda final: final and C.save_artifact(args, C.OCCLUSION, completers),
        tracker=C.BestTracker("val_mse" if args.select_by == "mse" else "pa_scenario_mean",
                              deferred=True),
        best={C.OCCLUSION: completers}, group=group)
    C.print_summary(cfg, state, device, result, group)
    return state


if __name__ == "__main__":
    main()
