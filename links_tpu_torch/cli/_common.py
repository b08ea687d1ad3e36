"""Shared CLI plumbing of the port: the data, checkpoint, training and
lifecycle flags that its entry points need (the serving lift, eval, the
trainers of stages 1, 2, 3a, 3b and 4, and the pipeline), the subset of
links_tpu/cli/_common.py they use.

Artifacts in ``--model-dir``: the flows ``<name>.pt``; the final lifters
and completers in the reference layout (``LR_LIFTERS``,
``LEG_TORSO_LIFTERS``, ``occlusion_model_weights/``) and their best-epoch
twins (``*_best.pt``, ``occlusion_model_weights_best/``), each described by
a ``<artifact>_best.meta.json`` sidecar under the JAX package's artifact
name, written after its weights; and each stage's run checkpoint
``<stage>_run.pt`` (``ckpt/run_io.py``).

The trainers' data-parallel flags (``--num-devices``, ``--distributed``)
are checked and their ranks set up by ``start_ranks`` before any data is
read; under a group rank 0 alone writes (``run_training``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from links_tpu_torch.core import geometry
from links_tpu_torch.core.nn import full_f32_matmuls
from links_tpu_torch.core.skeleton import (
    BONE_RELATIONS_MEAN_H36M,
    BONE_RELATIONS_MEAN_MPI_VNECT_INTERESTING,
    get_bone_lengths_all,
)
from links_tpu_torch.data.datasets import (
    MPI_SUBJECTS,
    TEST_SUBJECTS,
    TRAIN_SUBJECTS,
    load_h36m,
    load_mpi_inf_3dhp,
    read_pickle,
)
from links_tpu_torch.data.synthetic import write_synthetic_pickle
from links_tpu_torch.models.completers import COMPLETER_SPECS
from links_tpu_torch.train import parallel

# Artifact names of the flows (<name>.pt), as the JAX trainers' --save-pt names them
FULL_FLOW = "full_flow"
FLOW_LEFT = "flow_left"
FLOW_RIGHT = "flow_right"
FLOW_LEGS = "flow_legs"
FLOW_TORSO = "flow_torso"
# The JAX package's names of the lifter and completer artifacts: the names of
# their _best.meta.json sidecars here
LIFTER_LR = "lifter_left_right"
LIFTER_LEGS = "lifter_legs"
LIFTER_TORSO = "lifter_torso"
OCCLUSION = "occlusion_models"
# Lifter files: the (left, right) pair the 3a trainer writes (the reference's
# names) and its best-epoch twin, the reference-layout pair, and the (legs,
# torso) pair of 3b
LR_LIFTERS = ("left_side_lifter_final.pt", "right_side_lifter_final.pt")
LR_LIFTERS_BEST = ("left_side_lifter_best.pt", "right_side_lifter_best.pt")
LR_LIFTERS_REFERENCE = ("left_lifter.pt", "right_lifter.pt")
LEG_TORSO_LIFTERS = ("leg_lifter.pt", "torso_lifter.pt")
# Stage 4's completers: <model-dir>/occlusion_model_weights/<name>_estimator.pt
# (the reference's names; the best epoch's in occlusion_model_weights_best/),
# one per completer of models.completers.COMPLETER_SPECS
COMPLETERS_DIR = "occlusion_model_weights"
# artifact -> (final files, best-epoch files) of the lifters
_LIFTER_FILES = {
    LIFTER_LR: (LR_LIFTERS, LR_LIFTERS_BEST),
    LIFTER_LEGS: (LEG_TORSO_LIFTERS[:1], ("leg_lifter_best.pt",)),
    LIFTER_TORSO: (LEG_TORSO_LIFTERS[1:], ("torso_lifter_best.pt",)),
}
# seed of the trainers' unsupervised validation draws: fixed and independent
# of --seed, so the criterion compares across epochs and seeds
VAL_SEED = 20_000


def _test_scale(value: str):
    """--test-scale: a float, or 'auto'."""
    return value if value == "auto" else float(value)


def add_common_flags(parser: argparse.ArgumentParser):
    parser.add_argument("--data", default="data/h36m_data.pkl",
                        help="reference-schema pickle")
    parser.add_argument("--dataset", choices=["h36m", "mpi"], default="h36m",
                        help="h36m uses poses_3d GT; mpi uses poses_3d_univ")
    parser.add_argument("--test-subjects", default=None,
                        help="comma-separated test subject list override")
    parser.add_argument("--test-norm",
                        choices=["h36m", "mpi_chest", "mpi_vnect", "temporal"],
                        default=None,
                        help="test normalization scale variant; defaults by dataset")
    parser.add_argument("--test-scale", type=_test_scale, default=None,
                        help="override the fixed test-normalization scale: a float, or "
                             "'auto' for the train split's mean root-to-head 2D distance "
                             "(the quantity the reference's constant measures)")
    parser.add_argument("--model-dir", default="models", help="artifact directory")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the synthetic data and of the trainers' "
                             "torch.Generator")
    parser.add_argument("--no-gt-2d", dest="gt_2d", action="store_false", default=True,
                        help="train and evaluate on detector 2D keypoints (the pickle's "
                             "poses_2d_pred arrays when every subject has one); frames "
                             "with an undetected (zeroed) keypoint are dropped unless "
                             "--keep-incomplete")
    parser.add_argument("--keep-incomplete", action="store_true",
                        help="with --no-gt-2d: keep frames with missing keypoints")
    parser.add_argument("--synthetic", action="store_true",
                        help="generate synthetic data at --data if missing (smoke runs)")
    parser.add_argument("--synthetic-n", type=int, default=512,
                        help="synthetic poses per subject")
    parser.add_argument("--synthetic-test-n", type=int, default=None,
                        help="synthetic poses per TEST subject (default: --synthetic-n)")
    return parser


def add_lr_pt_flags(parser: argparse.ArgumentParser):
    parser.add_argument("--left-pt", default=None,
                        help="reference-layout left_lifter.pt")
    parser.add_argument("--right-pt", default=None,
                        help="reference-layout right_lifter.pt")
    return parser


def add_device_flag(parser: argparse.ArgumentParser):
    parser.add_argument("--device", default="cuda",
                        help="torch device to compute on (cuda, cuda:1, cpu)")
    return parser


def ensure_data(args) -> Path:
    path = Path(args.data)
    if path.exists():
        return path
    if not args.synthetic:
        raise FileNotFoundError(
            f"{path} not found. Produce it with links_tpu.data.preprocess "
            f"(h36m-fetch layout) or pass --synthetic for a smoke run.")
    print(f"[links_tpu_torch] generating synthetic data at {path}")
    test_subjects = ("S9", "S11")
    if args.dataset == "mpi":
        # MPI evaluates on its last two subjects; size them with the test count
        test_subjects = MPI_SUBJECTS[-2:] + test_subjects
    write_synthetic_pickle(path, n_per_subject=args.synthetic_n, seed=args.seed,
                           n_test_per_subject=args.synthetic_test_n,
                           test_subjects=test_subjects)
    return path


def add_lifter_flags(parser: argparse.ArgumentParser):
    """The reference's loss-weight flags (train_left_right_lifter.py:21-35)."""
    parser.add_argument("-b", "--bl", type=float, default=50.0, help="bone lengths")
    parser.add_argument("-t", "--translation", type=float, default=10.0,
                        help="camera translation")
    parser.add_argument("-r", "--rep2d", type=float, default=1.0, help="2d reprojection")
    parser.add_argument("-o", "--rot3d", type=float, default=1.0, help="3d reconstruction")
    parser.add_argument("-v", "--velocity", type=float, default=1.0, help="velocity")
    parser.add_argument("-l", "--likelihood", type=float, default=1.0, help="likelihood")
    parser.add_argument("--bone-means", choices=["h36m", "mpi_vnect_interesting", "data"],
                        default="h36m",
                        help="bone-relation prior means: H36M's, those of MPI-INF-3DHP's "
                             "'vnect interesting' cameras, or the train split's 3D ground "
                             "truth's")
    return parser


def add_train_flags(parser: argparse.ArgumentParser, bf16_opt_state_default: bool = False,
                    nll_cap_default: float | None = None):
    """The training flags of the JAX package's trainers that the port runs,
    with a stage's defaults as the JAX package sets them: f32 Adam moments
    and the config's NLL cap (none) for the flow trainers; the lifter
    trainers pass bf16 moments and a cap of 500."""
    parser.add_argument("--train-subjects", default=None,
                        help="comma-separated train subject list override")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override the stage's default epoch count")
    parser.add_argument("--f32", action="store_true", help="disable bf16 matmuls (full f32)")
    parser.add_argument("--clip-grad", type=float, default=None,
                        help="clip the global gradient norm before Adam (default off)")
    parser.add_argument("--nll-cap", type=float, default=nll_cap_default,
                        help="soft-cap the per-sample flow NLL (identity below the cap, "
                             "cap + log1p above); 0 disables")
    parser.add_argument("--bf16-opt-state", action=argparse.BooleanOptionalAction,
                        default=bf16_opt_state_default,
                        help="store Adam moments in bfloat16 at rest (f32 update math)")
    parser.add_argument("--validate-every", type=int, default=1,
                        help="validate every N epochs (always on the final epoch)")
    parser.add_argument("--save-every", type=int, default=None,
                        help="write the run checkpoint (and the flow trainers' flows) every "
                             "N epochs (default 1; always the final epoch)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the stage's run checkpoint <model-dir>/<stage>_run.pt "
                             "(weights, Adam state, epoch, generator state); without it a "
                             "run first removes the stage's own artifacts")
    parser.add_argument("--log", default=None,
                        help="JSONL metrics path (default <model-dir>/<stage>.jsonl)")
    add_device_flag(parser)
    parser.add_argument("--packed-data", default=None,
                        help="stream the train batches from an LNKS pack through the native "
                             "loader (data/native_loader.py, train/feed.py). When the file "
                             "exists the train split is not loaded; otherwise it is packed "
                             "from --data first (or with links_tpu_torch.cli.pack_data)")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="data-parallel ranks (default 1: one process on --device). N > 1 "
                             "starts N local ranks, each on its shard of every batch: rank i "
                             "on cuda:i (NCCL), or N gloo ranks under --device cpu. With "
                             "--distributed it must equal the launcher's WORLD_SIZE")
    parser.add_argument("--distributed", action="store_true",
                        help="join the data-parallel group a launcher describes in the "
                             "environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                             "MASTER_PORT), e.g. python -m torch.distributed.run --standalone "
                             "--nproc_per_node N -m links_tpu_torch.cli.<trainer> "
                             "--distributed; a CUDA rank computes on cuda:LOCAL_RANK")
    parser.add_argument("--wandb", action="store_true",
                        help="mirror the metric records to wandb when the package imports "
                             "(otherwise a warning, and the JSONL log alone)")
    parser.add_argument("--save-pt", action="store_true",
                        help="accepted for the JAX trainers' command lines: the port always "
                             "writes its reference-layout .pt files")
    return parser


# start_ranks' answer to the process that spawned the ranks of a run
SPAWNED = "spawned"


def _world_size(args, cfg, pairs: bool) -> int:
    """Check the data-parallel flags before any data is read. -> the number
    of ranks (1 without --distributed and --num-devices > 1)."""
    n = args.num_devices
    if n is not None and n < 1:
        raise SystemExit(f"--num-devices {n}: at least 1 rank")
    if args.distributed:
        world = parallel.launcher_world_size()
        if n is not None and n != world:
            raise SystemExit(f"--num-devices {n}: the launcher started WORLD_SIZE={world} ranks")
    else:
        world = n or 1
        if world > 1:
            parallel.local_devices(torch.device(args.device), world)  # exits when too few cards
    multiple = world * (2 if pairs else 1)
    if (args.distributed or world > 1) and cfg.batch_size % multiple:
        rule = (f"2 x {world} ranks: each rank's real and sampled halves pair their rows"
                if pairs else f"{world} ranks")
        raise SystemExit(f"--batch-size {cfg.batch_size}: not a multiple of {multiple} ({rule})")
    return world


def start_ranks(args, cfg, entry, argv, group: parallel.Group | None = None,
                pairs: bool = False):
    """The trainers' first step after their config (as the JAX trainers call
    ``maybe_init_distributed`` after ``parse_args``): check the
    data-parallel flags before any data is read (``pairs``: a lifter stage,
    whose global batch must split into even shards), say once that
    --save-pt has nothing to add, and set up the ranks. -> (group, device):
    (None, --device) for one process; this rank's group and device under
    --distributed or in a rank that ``spawn`` started (``group`` given);
    (``SPAWNED``, None) in the process that ran ``entry(argv, group=...)``
    on --num-devices local ranks, which have finished."""
    if group is None:
        world = _world_size(args, cfg, pairs)
        if args.distributed:
            resolve_device(args.device)  # refuses --device cuda without a card
            group = parallel.init_from_env(torch.device(args.device))
        if parallel.writes(group) and args.save_pt:
            print("[links_tpu_torch] --save-pt: nothing to add, the port always writes its "
                  "reference-layout .pt files", file=sys.stderr)
        if world > 1 and not args.distributed:
            parallel.spawn(entry, (argv,),
                           parallel.local_devices(torch.device(args.device), world))
            return SPAWNED, None
    return group, resolve_device(str(group.device) if group is not None else args.device)


def resolve_cfg(args, cfg):
    """Apply --epochs/--batch-size/--f32/--nll-cap/--clip-grad/
    --bf16-opt-state to a stage config."""
    kw = {}
    if args.epochs is not None:
        kw["n_epochs"] = args.epochs
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.f32:
        kw["bf16"] = False
    if args.nll_cap is not None and any(f.name == "nll_cap" for f in dataclasses.fields(cfg)):
        kw["nll_cap"] = args.nll_cap  # ignored by a stage with no flow term (stage 4)
    opt_kw = {"bf16_moments": bool(args.bf16_opt_state)}
    if args.clip_grad is not None:
        opt_kw["clip_grad_norm"] = args.clip_grad
    kw["optim"] = dataclasses.replace(cfg.optim, **opt_kw)
    return dataclasses.replace(cfg, **kw)


def due(args, epoch: int, n_epochs: int, attr: str) -> bool:
    """True when the periodic action named by ``attr`` ('save_every',
    'validate_every') is due this epoch. The final epoch is always due."""
    every = max(1, getattr(args, attr, 1) or 1)
    return (epoch + 1) % every == 0 or epoch + 1 == n_epochs


_TEST_NORMS = {
    "h36m": geometry.normalize_head_test,
    "mpi_chest": geometry.normalize_head_test_mpi_chest,
    "mpi_vnect": geometry.normalize_head_test_mpi_vnect,
    "temporal": geometry.normalize_head_test_temporal,
}


def _split_spec(args):
    """(path, loader, train subjects, test subjects, test normalizer, use_gt)."""
    path = ensure_data(args)
    if args.dataset == "mpi":
        # held out: train S1-S6, evaluate on S7/S8
        loader, train_s, test_s = load_mpi_inf_3dhp, MPI_SUBJECTS[:-2], MPI_SUBJECTS[-2:]
        norm = _TEST_NORMS[args.test_norm or "mpi_vnect"]
    else:
        loader, train_s, test_s = load_h36m, TRAIN_SUBJECTS, TEST_SUBJECTS
        norm = _TEST_NORMS[args.test_norm or "h36m"]
    if getattr(args, "train_subjects", None):
        train_s = tuple(args.train_subjects.split(","))
    if args.test_subjects:
        test_s = tuple(args.test_subjects.split(","))
    use_gt = getattr(args, "gt_2d", True)
    if args.test_scale:
        scale = (_train_head_scale(path, train_s, use_gt) if args.test_scale == "auto"
                 else args.test_scale)
        norm = functools.partial(geometry.normalize_head_test, scale=scale)
    return path, loader, train_s, test_s, norm, use_gt


def _complete_only(args) -> bool:
    """Drop frames with an undetected keypoint: detector 2D without
    --keep-incomplete."""
    return not getattr(args, "gt_2d", True) and not getattr(args, "keep_incomplete", False)


def _train_head_scale(path, train_subjects, use_gt: bool = True) -> float:
    """The mean root-to-head 2D distance over the train subjects (what the
    reference's fixed test scales measure), from the 2D keypoints the loaders
    read (ground truth, or the detector's under --no-gt-2d, then only over
    frames whose root and head were both detected)."""
    d = read_pickle(path)
    key_2d = "poses_2d"
    if not use_gt and all("poses_2d_pred" in d[s] for s in train_subjects):
        key_2d = "poses_2d_pred"
    p2 = np.concatenate([np.asarray(d[s][key_2d]) for s in train_subjects])
    if key_2d == "poses_2d_pred":
        ok = ~(np.all(p2[:, 0] == 0.0, axis=-1) | np.all(p2[:, 10] == 0.0, axis=-1))
        p2 = p2[ok]
    p2 = p2.transpose(0, 2, 1).reshape(-1, 2, 17)
    c = p2 - p2[:, :, 0:1]
    return float(np.linalg.norm(c[:, :, 0] - c[:, :, 10], axis=1).mean())


def load_test(args):
    """The normalized test split (S9/S11 for h36m, S7/S8 for mpi)."""
    path, loader, _, test_s, norm, use_gt = _split_spec(args)
    return loader(path, test_s, normalize_func=norm, use_gt=use_gt,
                  complete_only=_complete_only(args))


def load_train(args):
    """The train split, normalized with ``normalize_head``."""
    path, loader, train_s, _, _, use_gt = _split_spec(args)
    return loader(path, train_s, normalize_func=geometry.normalize_head, use_gt=use_gt,
                  complete_only=_complete_only(args))


def load_train_test(args):
    """(train split normalized with ``normalize_head``, test split)."""
    path, loader, train_s, test_s, norm, use_gt = _split_spec(args)
    co = _complete_only(args)
    return (loader(path, train_s, normalize_func=geometry.normalize_head, use_gt=use_gt,
                   complete_only=co),
            loader(path, test_s, normalize_func=norm, use_gt=use_gt, complete_only=co))


def load_train_test_or_packed(args, test: bool = True, group: parallel.Group | None = None):
    """(train split, test split, train rows, pack): ``load_train_test``, or
    ``load_train`` without ``test`` (the test split then None), except when
    --packed-data names an existing LNKS pack: the train split is then not
    loaded (None), its row count comes from the pack's header, and only the
    test split is. A --packed-data file that does not exist yet is packed
    from the train split first. The pack is None without --packed-data.
    With a ``group`` rank 0 loads first (writing the --synthetic corpus and
    the pack when they are missing) and the other ranks after it."""
    if group is None:
        return _load_train_test_or_packed(args, test)
    if not group.writes:
        parallel.barrier(group)
    out = _load_train_test_or_packed(args, test)
    if group.writes:
        parallel.barrier(group)
    return out


def _load_train_test_or_packed(args, test: bool):
    from links_tpu_torch.data.native_loader import PackedDataset
    from links_tpu_torch.train.feed import open_or_pack

    path = Path(args.packed_data) if getattr(args, "packed_data", None) else None
    if path is not None and path.exists():
        packed = PackedDataset(path)
        return None, load_test(args) if test else None, packed.n_rows, packed
    train_data, test_data = load_train_test(args) if test else (load_train(args), None)
    packed = open_or_pack(path, train_data.poses_2d.numpy()) if path is not None else None
    return train_data, test_data, len(train_data), packed


def train_batches(train_data, packed, device, group: parallel.Group | None = None):
    """What the epochs read: the train split's 2D poses on ``device`` (with
    a ``group``, cut to a multiple of the world size), or the packed feed of
    ``packed`` onto it."""
    if packed is not None:
        from links_tpu_torch.train.feed import PackedFeed

        return PackedFeed(packed, device)
    poses = train_data.poses_2d
    return poses[:parallel.trimmed(poses.shape[0], group)].to(device)


def artifact(args, name: str) -> Path:
    return Path(args.model_dir) / name


def artifact_paths(args, name: str, best: bool = False) -> list[Path]:
    """The weight files of artifact ``name`` (a flow, ``LIFTER_*`` or
    ``OCCLUSION``) in ``--model-dir``: its final ones, or its best epoch's."""
    model_dir = Path(args.model_dir)
    if name == OCCLUSION:
        folder = model_dir / (COMPLETERS_DIR + ("_best" if best else ""))
        return [folder / f"{c}_estimator.pt" for c in COMPLETER_SPECS]
    if name in _LIFTER_FILES:
        return [model_dir / f for f in _LIFTER_FILES[name][best]]
    return [model_dir / f"{name}{'_best' if best else ''}.pt"]


def save_artifact(args, name: str, module, best: bool = False):
    """Write a lifter or completer artifact's weights in the reference layout
    (each file atomically): ``LIFTER_LR`` from a ``StackedLifter``,
    ``LIFTER_LEGS``/``LIFTER_TORSO`` from a ``Lifter``, ``OCCLUSION`` from a
    ``Completers``."""
    from links_tpu_torch.ckpt.torch_io import save_completer_pt, save_lifter_pt

    if name == LIFTER_LR:
        parts, save = (module.left, module.right), save_lifter_pt
    elif name == OCCLUSION:
        parts, save = [module[c] for c in COMPLETER_SPECS], save_completer_pt
    else:
        parts, save = (module,), save_lifter_pt
    for part, path in zip(parts, artifact_paths(args, name, best)):
        path.parent.mkdir(parents=True, exist_ok=True)
        save(part, path)


def clear_stage_artifacts(args, stage: str, names, group: parallel.Group | None = None):
    """Remove this stage's artifacts of an earlier run (its run checkpoint,
    and the final and best weights and sidecar of each of ``names``) before
    a fresh run starts, so that no consumer or --resume reads a stale one as
    this run's. A --resume run keeps them, and only the writing rank of a
    group removes them. The frozen inputs are never touched."""
    if getattr(args, "resume", False) or not parallel.writes(group):
        return
    doomed = [artifact(args, f"{stage}_run.pt")]
    for name in names:
        doomed += [*artifact_paths(args, name), *artifact_paths(args, name, best=True),
                   artifact(args, f"{name}_best.meta.json")]
    for path in doomed:
        path.unlink(missing_ok=True)


def load_flow(args, name: str, device):
    """The frozen flow ``<model-dir>/<name>.pt`` (FrEIA layout) on ``device``."""
    from links_tpu_torch.ckpt.torch_io import load_flow_pt

    path = Path(args.model_dir) / f"{name}.pt"
    if not path.exists():
        raise FileNotFoundError(
            f"no flow weights at {path}: train them first with "
            f"links_tpu_torch.cli.train_full_pose_norm_flow ({FULL_FLOW}.pt) and "
            f"links_tpu_torch.cli.train_part_norm_flows ({FLOW_LEFT}.pt, {FLOW_RIGHT}.pt, "
            f"{FLOW_LEGS}.pt, {FLOW_TORSO}.pt), or pass the FrEIA-layout .pt flows the JAX "
            f"flow trainers write with --save-pt")
    return load_flow_pt(path, device)


def load_stacked_lr(args, device):
    """The (left, right) lifter pair as a ``StackedLifter`` on ``device``, in
    the JAX package's order: ``--left-pt``/``--right-pt``; else the pair
    the stage-3a trainers write in ``--model-dir``, its best epoch's
    (``{left,right}_side_lifter_best.pt``) as ``best_suffix`` decides, or
    the final one (``{left,right}_side_lifter_final.pt``); else the
    reference-layout pair there (``{left,right}_lifter.pt``)."""
    from links_tpu_torch.ckpt.torch_io import load_lifter_pt
    from links_tpu_torch.models.lifters import StackedLifter

    left_pt, right_pt = args.left_pt, args.right_pt
    if bool(left_pt) != bool(right_pt):
        raise ValueError("--left-pt and --right-pt must be given together")
    if not left_pt:
        best = bool(best_suffix(args, LIFTER_LR))  # raises for a missing --use-best pair
        pairs = [artifact_paths(args, LIFTER_LR, best)]
        if not best:
            pairs.append([Path(args.model_dir) / f for f in LR_LIFTERS_REFERENCE])
        found = [p for p in pairs if all(f.exists() for f in p)]
        if not found:
            raise FileNotFoundError(
                f"no left/right lifter weights: expected {' + '.join(map(str, pairs[0]))} "
                f"(the stage-3a trainers write them) or {' + '.join(map(str, pairs[-1]))} "
                f"(a reference .pt pair); train stage 3a first or pass --left-pt/--right-pt")
        left_pt, right_pt = found[0]
    return StackedLifter(load_lifter_pt(left_pt, device),
                         load_lifter_pt(right_pt, device))


def load_leg_torso(args, device):
    """(legs, torso) ``Lifter``s on ``device`` from the ``leg_lifter.pt`` and
    ``torso_lifter.pt`` that the stage-3b trainers write (the JAX one with
    --save-pt), or their best epoch's twins as ``best_suffix`` decides."""
    from links_tpu_torch.ckpt.torch_io import load_lifter_pt

    paths = [artifact_paths(args, name, bool(best_suffix(args, name)))[0]
             for name in (LIFTER_LEGS, LIFTER_TORSO)]
    missing = [str(p) for p in paths if not p.exists()]
    if missing:
        raise FileNotFoundError(f"no leg/torso lifter weights: expected {missing}")
    return tuple(load_lifter_pt(p, device) for p in paths)


def load_all_lifters(args, device) -> dict:
    """The four frozen lifters the occlusion paths read, as the ``{'left',
    'right', 'legs', 'torso'}`` ``Lifter``s on ``device``: the left/right
    pair as ``load_stacked_lr`` finds it, the legs and torso as
    ``load_leg_torso``."""
    stacked = load_stacked_lr(args, device)
    legs, torso = load_leg_torso(args, device)
    return {"left": stacked.left, "right": stacked.right, "legs": legs, "torso": torso}


def load_completers(args, device):
    """The eight completers from ``<model-dir>/occlusion_model_weights/`` (the
    stage-4 trainers write them, the JAX one with --save-pt; or
    ``occlusion_model_weights_best/`` as ``best_suffix`` decides) as a
    ``ModuleDict`` keyed by name, in ``COMPLETER_SPECS`` order, on
    ``device``; each completer's width is its file's."""
    from links_tpu_torch.ckpt.torch_io import load_completer_pt

    paths = dict(zip(COMPLETER_SPECS,
                     artifact_paths(args, OCCLUSION, bool(best_suffix(args, OCCLUSION)))))
    missing = [str(p) for p in paths.values() if not p.exists()]
    if missing:
        raise FileNotFoundError(f"no completer weights: expected {missing}; train stage 4 "
                                f"first (links_tpu_torch.cli.train_occlusion_models)")
    return torch.nn.ModuleDict({name: load_completer_pt(p, device) for name, p in paths.items()})


def maybe_quantize(models, args):
    """Apply the --quant flag to a loaded model, or to a dict of them (the
    four lifters): int8 weights with dynamic activation scales
    (ops/quant.py), or the model unchanged. ``int8-static`` needs a
    calibration forward of the model family (``quantize_lr``,
    ``quantize_leg_torso``); models routed here under it serve dynamic
    scales, as in the JAX package."""
    if getattr(args, "quant", None) not in ("int8", "int8-static"):
        return models
    from links_tpu_torch.ops.quant import quantize_params

    if isinstance(models, dict):
        return {k: quantize_params(m) for k, m in models.items()}
    return quantize_params(models)


def _calib_poses(args) -> torch.Tensor:
    """The calibration rows of --quant int8-static: the first --calib-rows
    normalized 2D poses of the TRAIN split (activation ranges are not fit on
    the evaluation data), on the CPU."""
    rows = int(getattr(args, "calib_rows", 1024) or 1024)
    return load_train(args).poses_2d[:rows].cpu()


def _report_static(n_static: int, n_dynamic: int, rows: int):
    print(f"[links_tpu_torch] int8-static: {n_static} linears calibrated on {rows} train "
          f"rows, {n_dynamic} dynamic fallback", file=sys.stderr)


def static_quant_lr(args, stacked):
    """--quant int8-static for the (left, right) serving pair: each side
    calibrated on its half of the calibration poses (f32, on the CPU)."""
    from links_tpu_torch.core.skeleton import split_data_left_right
    from links_tpu_torch.ops.quant import quantize_stacked_static

    calib = _calib_poses(args)
    sides = split_data_left_right(calib)
    q, ns, nd = quantize_stacked_static(stacked, lambda host, i: host(sides[i]))
    _report_static(ns, nd, calib.shape[0])
    return q


def static_quant_leg_torso(args, legs, torso):
    """--quant int8-static for the (legs, torso) serving pair."""
    from links_tpu_torch.core.skeleton import split_data_legs_torso
    from links_tpu_torch.ops.quant import quantize_params_static

    calib = _calib_poses(args)
    parts = split_data_legs_torso(calib)
    legs_q, s1, d1 = quantize_params_static(legs, lambda host: host(parts[0]))
    torso_q, s2, d2 = quantize_params_static(torso, lambda host: host(parts[1]))
    _report_static(s1 + s2, d1 + d2, calib.shape[0])
    return legs_q, torso_q


def quantize_lr(args, stacked):
    """The --quant flag on the (left, right) serving pair: calibrated static
    scales under ``int8-static``, dynamic ones under ``int8``."""
    if getattr(args, "quant", None) == "int8-static":
        return static_quant_lr(args, stacked)
    return maybe_quantize(stacked, args)


def quantize_leg_torso(args, legs, torso):
    """The --quant flag on the (legs, torso) serving pair, as ``quantize_lr``."""
    if getattr(args, "quant", None) == "int8-static":
        return static_quant_leg_torso(args, legs, torso)
    return maybe_quantize(legs, args), maybe_quantize(torso, args)


def resolve_device(name: str) -> torch.device:
    """The device the CLI computes on; on a CUDA device f32 matmuls stay f32."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device is available "
                             f"(pass --device cpu)")
        full_f32_matmuls()
    return device


def bone_means_from_data(train_data) -> torch.Tensor:
    """The mean relative bone lengths (16,) of the training set's 3D ground
    truth, as the reference derived its prior constants from its datasets
    (``--bone-means data``)."""
    bl = get_bone_lengths_all(train_data.poses_3d)
    return (bl / bl.mean(dim=1, keepdim=True)).mean(dim=0)


def resolve_bone_means(args, train_data) -> torch.Tensor:
    """The bone-relation prior means that ``--bone-means`` names (16,);
    ``train_data`` is None when an existing --packed-data pack stands in
    for the train split."""
    if args.bone_means == "data":
        if train_data is None:
            raise SystemExit("--bone-means data needs the train split's 3D GT, which an "
                             "existing --packed-data pack does not carry (it holds only 2D "
                             "poses); pass explicit means or drop --packed-data")
        return bone_means_from_data(train_data)
    means = {"h36m": BONE_RELATIONS_MEAN_H36M,
             "mpi_vnect_interesting": BONE_RELATIONS_MEAN_MPI_VNECT_INTERESTING}
    return torch.as_tensor(means[args.bone_means], dtype=torch.float32)


@torch.no_grad()
def validate_unsup(loss_fn, test_2d: torch.Tensor) -> dict[str, float]:
    """A stage-3 objective on the test split (no 3D ground truth), on a fixed
    rotation draw of seed ``VAL_SEED``; ``loss_fn(poses, u_azim, eps_elev)
    -> (loss, aux)``. ``val_nll`` is its flow-likelihood term,
    ``val_unsup_loss`` the whole weighted sum."""
    n2 = test_2d.shape[0] // 2 * 2  # the pairwise term needs an even batch
    g = torch.Generator(device=test_2d.device).manual_seed(VAL_SEED)
    u_azim = torch.rand(n2, 1, generator=g, device=test_2d.device)
    eps_elev = torch.randn(n2, 1, generator=g, device=test_2d.device)
    loss, aux = loss_fn(test_2d[:n2], u_azim, eps_elev)
    return dict(zip(("val_nll", "val_unsup_loss"), torch.stack([aux["likeli"], loss]).tolist()))


def _write_text(path: Path, text: str):
    """Write ``text`` to ``path`` atomically (a temporary name, then a rename)."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


class BestTracker:
    """Keep ``_best`` weights of the best validation epoch (counterpart of
    links_tpu's ``BestTracker``): the unsupervised lifting objective can walk
    into the depth-flipped mode late in training while its loss still falls,
    so the best epoch's weights are kept beside the final ones. ``metric``
    is the record key to minimise; with ``gate_metric`` (the depth-tilt
    alarm, ``val_tilt``) only epochs where it is negative are eligible.

    Each artifact's weights are written first and its
    ``<name>_best.meta.json`` sidecar (``{"epoch": ..., metric: ...}``)
    after them, so that a sidecar never describes weights that were not
    written. In deferred mode an improvement is held as a copy in memory
    (``Adam.step`` updates the live parameters in place) and reaches the
    disk at ``flush``, which the trainers call at each --save-every epoch
    and at the end."""

    def __init__(self, metric: str, gate_metric: str | None = None, deferred: bool = False):
        self.metric = metric
        self.gate_metric = gate_metric
        self.best = float("inf")
        self.epoch = -1
        self.gated_out = 0
        self.deferred = deferred
        self._pending = None  # (epoch, value, {name: module copy})

    def maybe_restore(self, args, name: str):
        """Seed the bar from an existing ``<name>_best.meta.json``, so that a
        --resume'd run cannot overwrite a better best of the run before it."""
        sidecar = artifact(args, f"{name}_best.meta.json")
        if sidecar.exists():
            extra = json.loads(sidecar.read_text())
            if self.metric in extra:
                self.best = float(extra[self.metric])
                self.epoch = int(extra.get("epoch", -1))
        return self

    def update(self, args, epoch: int, rec: dict, artifacts: dict) -> bool:
        """``artifacts`` maps an artifact name to its live module. Keep them
        as ``_best`` when ``rec[self.metric]`` improves on the best so far.
        -> True on an improvement."""
        value = rec.get(self.metric)
        if value is None or not value < self.best:
            return False
        if self.gate_metric is not None:
            gate = rec.get(self.gate_metric)
            if gate is None or not gate < 0.0:  # a depth-flipped epoch
                self.gated_out += 1
                return False
        self.best, self.epoch = float(value), epoch
        if self.deferred:
            # deepcopy clones every parameter (detached from the live ones)
            with torch.no_grad():
                self._pending = (epoch, float(value),
                                 {name: copy.deepcopy(m) for name, m in artifacts.items()})
            return True
        self._write(args, epoch, float(value), artifacts)
        return True

    def flush(self, args):
        """Write the pending deferred best (no-op when there is none)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._write(args, *pending)

    def _write(self, args, epoch: int, value: float, artifacts: dict):
        record = json.dumps({"epoch": epoch, self.metric: value})
        for name, module in artifacts.items():
            sidecar = artifact(args, f"{name}_best.meta.json")
            sidecar.unlink(missing_ok=True)
            save_artifact(args, name, module, best=True)
            _write_text(sidecar, record)


class EpochTimer:
    """Wall-clock attribution of a trainer's loop (counterpart of
    links_tpu's ``EpochTimer``): sections 'step' (the epoch's steps, ending
    in a device read), 'validate', 'checkpoint' (run checkpoints and
    weights, ``_best`` included), and 'host' (the rest). ``report`` returns
    ``time_<section>_s``, ``time_wall_s``, ``poses_per_sec_step``,
    ``poses_per_sec_delivered`` and, after more than one epoch, the steady
    step rate without the first epoch (``poses_per_sec_step_steady``,
    ``time_step_first_s``) and each other section's first time."""

    def __init__(self):
        self.tot, self.first, self.count = {}, {}, {}
        self._wall0 = None

    def start(self):
        self._wall0 = time.perf_counter()
        return self

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.tot[name] = self.tot.get(name, 0.0) + dt
            self.count[name] = self.count.get(name, 0) + 1
            self.first.setdefault(name, dt)

    def report(self, n_poses: int) -> dict:
        """The breakdown of the time since ``start`` (also printed to stderr)."""
        wall = (time.perf_counter() - self._wall0 if self._wall0 is not None
                else sum(self.tot.values()))
        rows = dict(self.tot, host=max(0.0, wall - sum(self.tot.values())))
        out = {f"time_{k}_s": round(v, 3) for k, v in rows.items()}
        out["time_wall_s"] = round(wall, 3)
        step_s = self.tot.get("step", 0.0)
        if step_s > 0:
            out["poses_per_sec_step"] = round(n_poses / step_s, 1)
        if wall > 0:
            out["poses_per_sec_delivered"] = round(n_poses / wall, 1)
        n_steps = self.count.get("step", 0)
        if n_steps > 1 and step_s > self.first.get("step", 0.0):
            steady = n_poses / n_steps * (n_steps - 1) / (step_s - self.first["step"])
            out["poses_per_sec_step_steady"] = round(steady, 1)
            out["time_step_first_s"] = round(self.first["step"], 3)
        for name, cnt in self.count.items():
            if name != "step" and cnt > 1:
                out[f"time_{name}_first_s"] = round(self.first[name], 3)
        parts = " ".join(f"{k}={v:.1f}s ({100 * v / wall:.0f}%)" for k, v in rows.items()
                         if wall > 0)
        print(f"[links_tpu_torch] wall {wall:.1f}s: {parts}; delivered "
              f"{out.get('poses_per_sec_delivered', 0):.0f} poses/s (step-only "
              f"{out.get('poses_per_sec_step', 0):.0f})", file=sys.stderr)
        return out


def add_select_by_flag(parser: argparse.ArgumentParser):
    """The lifter trainers' criterion of the best epoch."""
    parser.add_argument(
        "--select-by", choices=["pa", "nll", "loss", "nll-tilt"], default="pa",
        help="validation metric the _best weights are selected on: 'pa' = PA-MPJPE "
             "against the test split's 3D ground truth (used for selection only); 'nll' "
             "= the part flows' NLL of the validation reprojections; 'loss' = the whole "
             "unsupervised validation objective; 'nll-tilt' = the NLL, with only epochs "
             "the depth-flip alarm passes (val_tilt < 0) eligible. All are logged every "
             "validation epoch regardless")


def select_metric(args, pa_name: str) -> str:
    return {"pa": pa_name, "nll": "val_nll", "loss": "val_unsup_loss",
            "nll-tilt": "val_nll"}[getattr(args, "select_by", "pa")]


def select_gate(args) -> str | None:
    """The gate metric of the ``BestTracker``, or None (only nll-tilt gates)."""
    return "val_tilt" if getattr(args, "select_by", "pa") == "nll-tilt" else None


def add_flip_guard_flag(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--flip-guard", type=int, default=None, metavar="K",
        help="stop training after K consecutive depth-flipped validation epochs "
             "(val_tilt >= 0), once an un-flipped one has armed the guard; the best "
             "weights are kept. Off by default; val_tilt is logged regardless")


class FlipGuard:
    """Early stop on a sustained depth flip (counterpart of links_tpu's
    ``FlipGuard``): armed by the first validation epoch with ``val_tilt <
    0``, it fires after ``patience`` consecutive epochs with ``val_tilt >=
    0``."""

    def __init__(self, patience: int | None):
        self.patience = patience
        self.armed = False
        self.streak = 0
        self.fired_epoch = -1

    def update(self, epoch: int, rec: dict) -> bool:
        """Feed one epoch's record; -> True to stop training now."""
        tilt = rec.get("val_tilt")
        if self.patience is None or tilt is None:
            return False
        if tilt < 0.0:
            self.armed, self.streak = True, 0
            return False
        if not self.armed:
            return False
        self.streak += 1
        if self.streak < self.patience:
            return False
        self.fired_epoch = epoch
        print(f"[links_tpu_torch] --flip-guard: stopping at epoch {epoch}: {self.streak} "
              f"consecutive depth-flipped validation epochs (val_tilt >= 0); the best "
              f"weights are unaffected", file=sys.stderr)
        return True


def add_use_best_flag(parser: argparse.ArgumentParser):
    g = parser.add_mutually_exclusive_group()
    g.add_argument("--use-best", action="store_true",
                   help="require the lifters' and completers' best-epoch weights (*_best.pt, "
                        "occlusion_model_weights_best/; an error if absent). Without either "
                        "flag they are preferred when present")
    g.add_argument("--use-final", action="store_true",
                   help="read the last epoch's weights even when best-epoch ones exist")
    return parser


def best_suffix(args, name: str | None = None) -> str:
    """'_best' when artifact ``name``'s best-epoch weights are to be read,
    else '': ``--use-final`` -> ''; ``--use-best`` -> '_best', and they must
    exist; neither -> '_best' when they exist (announced on stderr), else
    ''. With no ``name`` only the flags decide."""
    if getattr(args, "use_final", False):
        return ""
    explicit = getattr(args, "use_best", False)
    if name is None:
        return "_best" if explicit else ""
    missing = [str(p) for p in artifact_paths(args, name, best=True) if not p.exists()]
    if not missing:
        if not explicit:
            _announce_best(args, name)
        return "_best"
    if explicit:
        raise FileNotFoundError(f"--use-best: {', '.join(missing)} missing (the trainer writes "
                                f"them on validation improvements); drop the flag or pass "
                                f"--use-final")
    return ""


def _announce_best(args, name: str):
    """Say on stderr that ``name``'s best-epoch weights are read, with the
    selection record of its sidecar."""
    sidecar = artifact(args, f"{name}_best.meta.json")
    try:
        extra = json.loads(sidecar.read_text())
    except (OSError, ValueError):
        extra = {}
    detail = ", ".join(f"{k}={v}" for k, v in sorted(extra.items()))
    print(f"[links_tpu_torch] using best-validation weights for {name}"
          + (f" ({detail})" if detail else "") + "; pass --use-final for the last epoch's",
          file=sys.stderr)


def log_record(fh, record: dict, **extra):
    """One JSON record per line (the JAX package's MetricLogger format)."""
    fh.write(json.dumps(dict(record, _time=time.time(), **extra)) + "\n")
    fh.flush()


def open_wandb(args, run_name: str, config: dict):
    """--wandb, as the JAX package's ``MetricLogger``: the ``wandb`` module
    with a run of project LInKs started (its name prefixed by ``run_name``),
    which then receives every record; or None, with one warning on stderr,
    when the package does not import or the run does not start. The JSONL
    log is written either way."""
    if not getattr(args, "wandb", False):
        return None
    try:
        import wandb

        wandb.init(project="LInKs", config=config)
        wandb.run.name = f"{run_name} {wandb.run.name}"
    except Exception as e:  # noqa: BLE001 - any failure falls back to the JSONL log
        print(f"[links_tpu_torch] --wandb: {type(e).__name__}: {e}; the records go to the "
              f"JSONL log only", file=sys.stderr)
        return None
    return wandb


class TrainResult(NamedTuple):
    seconds: float  # in the epochs' steps
    steps: int      # taken by this run (a resumed run counts from its start)
    rec: dict       # the last epoch's record
    report: dict    # EpochTimer.report


def run_training(args, cfg, step, state, data, generator: torch.Generator,
                 log_name: str, config: dict, on_epoch, draw=None, *, stage: str,
                 save: Callable[[bool], None], tracker: BestTracker | None = None,
                 best: dict | None = None, guard: FlipGuard | None = None,
                 group: parallel.Group | None = None) -> TrainResult:
    """The trainers' epoch loop (the JAX trainers' loop, one copy for all):
    with --resume, the run checkpoint ``<model-dir>/<stage>_run.pt`` first
    restores ``state`` and ``generator`` and the epoch to start from. Then
    epochs to ``cfg.n_epochs`` of ``step`` over ``data``, a tensor on the
    device or the packed feed (``train_batches``; ``train.loop.run_epoch``,
    with ``draw`` as there). After each epoch
    ``on_epoch(epoch, rec)`` may validate into the record and returns the
    text of the epoch's line after ``epoch N: ``; ``tracker`` keeps the
    ``best`` artifacts (name -> live module) of the best validated epoch;
    ``guard`` may stop the run. At each --save-every epoch (and at a stop):
    the tracker's pending best, ``save(final)`` (``final`` at the last epoch
    or a stop: the stage's consumer-facing weights), then the run
    checkpoint. The records go to the JSONL log (``--log``, default
    ``<model-dir>/<log_name>.jsonl``, after one ``_config`` record) and the
    lines to stdout; the timer's report to ``print_summary``.

    With a data-parallel ``group`` every rank steps (``step`` and ``draw``
    as ``run_epoch`` takes them with a group) and resumes from the same
    file; rank 0 alone validates (``on_epoch`` reduces nothing), keeps the
    best, decides a --flip-guard stop and writes, and its record reaches
    every rank, so all stop in the same epoch. Every rank waits for the
    others before returning, so rank 0's files exist by then."""
    from links_tpu_torch.ckpt.run_io import maybe_resume, save_run
    from links_tpu_torch.train.loop import run_epoch
    from links_tpu_torch.train.steps import draw_step

    writes = parallel.writes(group)
    start = maybe_resume(args, stage, state, generator)
    if not writes:
        tracker = guard = None
    if tracker is not None and getattr(args, "resume", False):
        # also when no run checkpoint exists yet: a best written before the
        # first --save-every epoch still sets the bar
        tracker.maybe_restore(args, next(iter(best)))
    log_path = Path(args.log) if args.log else Path(args.model_dir) / f"{log_name}.jsonl"
    if writes:
        log_path.parent.mkdir(parents=True, exist_ok=True)
    wandb = open_wandb(args, log_name, config) if writes else None
    timer, step0, rec = EpochTimer().start(), state.step, {}
    with log_path.open("a") if writes else contextlib.nullcontext() as log:
        if writes:
            log_record(log, {"_config": config})
        for epoch in range(start, cfg.n_epochs):
            with timer.section("step"):  # run_epoch ends with a device read
                rec = run_epoch(step, state, data, cfg.batch_size, generator,
                                draw or draw_step, group)
            stop = False
            if writes:
                with timer.section("validate"):
                    msg = on_epoch(epoch, rec)
                if tracker is not None:
                    with timer.section("checkpoint"):
                        if tracker.update(args, epoch, rec, best):
                            msg += " [best]"
                stop = guard is not None and guard.update(epoch, rec)
                if stop:
                    rec["flip_guard_stop"] = 1.0
                rec["epoch"] = epoch
                log_record(log, rec, _step=epoch)
                if wandb is not None:
                    wandb.log(rec)
                print(f"epoch {epoch}: {msg}", flush=True)
            if group is not None:
                with timer.section("validate"):  # the others wait for rank 0's record
                    rec = parallel.broadcast_object(rec, group)
                stop = "flip_guard_stop" in rec
            if writes and (stop or due(args, epoch, cfg.n_epochs, "save_every")):
                with timer.section("checkpoint"):
                    if tracker is not None:
                        tracker.flush(args)
                    save(stop or epoch + 1 == cfg.n_epochs)
                    save_run(args, stage, state, generator, epoch + 1)
            if stop:
                break
        if tracker is not None:
            with timer.section("checkpoint"):
                tracker.flush(args)
        if group is not None:
            parallel.barrier(group)
        steps = state.step - step0
        report = timer.report(steps * cfg.batch_size) if writes else {}
    if wandb is not None:
        wandb.finish()
    if tracker is not None and tracker.gate_metric and tracker.gated_out:
        print(f"[links_tpu_torch] --select-by {args.select_by}: the flip alarm vetoed "
              f"{tracker.gated_out} improving epoch(s) (val_tilt >= 0)"
              + ("; no _best saved: the run looks depth-flipped throughout"
                 if tracker.epoch < 0 else ""), file=sys.stderr)
    return TrainResult(timer.tot.get("step", 0.0), steps, rec, report)


def print_summary(cfg, state, device, result: TrainResult,
                  group: parallel.Group | None = None):
    """The trainers' one-line JSON summary (rank 0's, under data
    parallelism, with the number of ranks): epochs, steps, device, the
    seconds spent in this run's steps, poses/s over the global batches, the
    timer's report and the last epoch's record."""
    if not parallel.writes(group):
        return
    poses = result.steps * cfg.batch_size
    ranks = {} if group is None else {"ranks": group.world}
    print(json.dumps({
        "epochs": cfg.n_epochs, "steps": state.step, "batch": cfg.batch_size,
        "device": str(device), **ranks, "seconds": round(result.seconds, 4),
        "poses_per_sec": round(poses / result.seconds, 1) if result.seconds > 0 else None,
        **result.report,
        "last": {k: v for k, v in result.rec.items() if k != "epoch"},
    }))
