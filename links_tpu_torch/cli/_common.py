"""Shared CLI plumbing of the port: the data, checkpoint and training flags
the serving lift and the stage-3a trainer need (the subset of
links_tpu/cli/_common.py they use)."""

from __future__ import annotations

import argparse
import dataclasses
import functools
from pathlib import Path

import torch

from links_tpu_torch.core import geometry
from links_tpu_torch.core.nn import full_f32_matmuls
from links_tpu_torch.data.datasets import (
    MPI_SUBJECTS,
    TEST_SUBJECTS,
    TRAIN_SUBJECTS,
    load_h36m,
    load_mpi_inf_3dhp,
)
from links_tpu_torch.data.synthetic import write_synthetic_pickle

# Artifact names of the frozen flows (the names the JAX trainers' --save-pt writes)
FULL_FLOW = "full_flow"
FLOW_LEFT = "flow_left"
FLOW_RIGHT = "flow_right"


def _test_scale(value: str):
    """--test-scale: a float, or 'auto' (refused: not yet ported)."""
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
                        help="override the fixed test-normalization scale "
                             "('auto' is not yet ported)")
    parser.add_argument("--model-dir", default="models", help="artifact directory")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the synthetic data and of the trainers' "
                             "torch.Generator")
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
    return parser


# Flags of the JAX trainers that later slices port: accepted, then refused.
UNPORTED_TRAIN_FLAGS = ("resume", "packed_data", "distributed", "num_devices", "wandb",
                        "save_every")


def add_train_flags(parser: argparse.ArgumentParser):
    """The training flags of the JAX package's trainers that the port runs,
    with the stage-3a trainer's defaults (bf16 Adam moments, NLL cap 500)."""
    parser.add_argument("--train-subjects", default=None,
                        help="comma-separated train subject list override")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override the stage's default epoch count")
    parser.add_argument("--f32", action="store_true", help="disable bf16 matmuls (full f32)")
    parser.add_argument("--clip-grad", type=float, default=None,
                        help="clip the global gradient norm before Adam (default off)")
    parser.add_argument("--nll-cap", type=float, default=500.0,
                        help="soft-cap the per-sample flow NLL (identity below the cap, "
                             "cap + log1p above); 0 disables")
    parser.add_argument("--bf16-opt-state", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="store Adam moments in bfloat16 at rest (f32 update math)")
    parser.add_argument("--validate-every", type=int, default=1,
                        help="validate every N epochs (always on the final epoch)")
    parser.add_argument("--log", default=None,
                        help="JSONL metrics path (default <model-dir>/<stage>.jsonl)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to compute on (cuda, cuda:1, cpu)")
    parser.add_argument("--resume", action="store_true", help="(not yet ported)")
    parser.add_argument("--packed-data", default=None, help="(not yet ported)")
    parser.add_argument("--distributed", action="store_true", help="(not yet ported)")
    parser.add_argument("--num-devices", type=int, default=None, help="(not yet ported)")
    parser.add_argument("--wandb", action="store_true", help="(not yet ported)")
    parser.add_argument("--save-every", type=int, default=None, help="(not yet ported)")
    return parser


def refuse_unported(args, names=UNPORTED_TRAIN_FLAGS):
    """Exit with a clear message when a flag that a later slice ports is set."""
    given = [n for n in names if getattr(args, n, None) not in (None, False)]
    if given:
        flags = ", ".join("--" + n.replace("_", "-") for n in given)
        raise SystemExit(f"{flags}: not yet ported to links_tpu_torch; "
                         f"run them with the links_tpu trainers")


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
    if args.nll_cap is not None:
        kw["nll_cap"] = args.nll_cap
    opt_kw = {"bf16_moments": bool(args.bf16_opt_state)}
    if args.clip_grad is not None:
        opt_kw["clip_grad_norm"] = args.clip_grad
    kw["optim"] = dataclasses.replace(cfg.optim, **opt_kw)
    return dataclasses.replace(cfg, **kw)


def due(args, epoch: int, n_epochs: int, attr: str) -> bool:
    """True when the periodic action named by ``attr`` ('validate_every') is
    due this epoch. The final epoch is always due."""
    every = max(1, getattr(args, attr, 1) or 1)
    return (epoch + 1) % every == 0 or epoch + 1 == n_epochs


_TEST_NORMS = {
    "h36m": geometry.normalize_head_test,
    "mpi_chest": geometry.normalize_head_test_mpi_chest,
    "mpi_vnect": geometry.normalize_head_test_mpi_vnect,
    "temporal": geometry.normalize_head_test_temporal,
}


def _split_spec(args):
    """(path, loader, train subjects, test subjects, test normalizer)."""
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
    if args.test_scale == "auto":
        raise SystemExit("--test-scale auto is not yet ported to links_tpu_torch; "
                         "pass the scale as a number")
    if args.test_scale:
        norm = functools.partial(geometry.normalize_head_test, scale=args.test_scale)
    return path, loader, train_s, test_s, norm


def load_test(args):
    """The normalized test split (S9/S11 for h36m, S7/S8 for mpi)."""
    path, loader, _, test_s, norm = _split_spec(args)
    return loader(path, test_s, normalize_func=norm)


def load_train_test(args):
    """(train split normalized with ``normalize_head``, test split)."""
    path, loader, train_s, test_s, norm = _split_spec(args)
    return (loader(path, train_s, normalize_func=geometry.normalize_head),
            loader(path, test_s, normalize_func=norm))


def load_flow(args, name: str, device):
    """The frozen flow ``<model-dir>/<name>.pt`` (FrEIA layout) on ``device``."""
    from links_tpu_torch.ckpt.torch_io import load_flow_pt

    path = Path(args.model_dir) / f"{name}.pt"
    if not path.exists():
        raise FileNotFoundError(
            f"no flow weights at {path}: the port reads the FrEIA-layout .pt flows "
            f"that the JAX flow trainers write with --save-pt "
            f"({FULL_FLOW}.pt, {FLOW_LEFT}.pt, {FLOW_RIGHT}.pt)")
    return load_flow_pt(path, device)


def load_stacked_lr(args, device):
    """The (left, right) lifter pair as a ``StackedLifter`` on ``device``:
    from ``--left-pt``/``--right-pt``, else ``{left,right}_lifter.pt`` in
    ``--model-dir``."""
    from links_tpu_torch.ckpt.torch_io import load_lifter_pt
    from links_tpu_torch.models.lifters import StackedLifter

    left_pt, right_pt = args.left_pt, args.right_pt
    if bool(left_pt) != bool(right_pt):
        raise ValueError("--left-pt and --right-pt must be given together")
    if not left_pt:
        left_pt = Path(args.model_dir) / "left_lifter.pt"
        right_pt = Path(args.model_dir) / "right_lifter.pt"
        if not (left_pt.exists() and right_pt.exists()):
            raise FileNotFoundError(
                f"no left/right lifter weights: expected {left_pt} + {right_pt} "
                f"(reference .pt pair; the JAX trainers write them with "
                f"--save-pt) or pass --left-pt/--right-pt")
    return StackedLifter(load_lifter_pt(left_pt, device),
                         load_lifter_pt(right_pt, device))


def load_leg_torso(args, device):
    """(legs, torso) ``Lifter``s on ``device`` from the ``leg_lifter.pt`` and
    ``torso_lifter.pt`` that the JAX stage-3b trainer writes with --save-pt."""
    from links_tpu_torch.ckpt.torch_io import load_lifter_pt

    paths = [Path(args.model_dir) / f for f in ("leg_lifter.pt", "torso_lifter.pt")]
    missing = [str(p) for p in paths if not p.exists()]
    if missing:
        raise FileNotFoundError(f"no leg/torso lifter weights: expected {missing}")
    return tuple(load_lifter_pt(p, device) for p in paths)


def resolve_device(name: str) -> torch.device:
    """The device the CLI computes on; on a CUDA device f32 matmuls stay f32."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device is available "
                             f"(pass --device cpu)")
        full_f32_matmuls()
    return device
