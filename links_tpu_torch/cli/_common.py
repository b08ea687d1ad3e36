"""Shared CLI plumbing of the port: the data and checkpoint flags the
serving lift needs (the subset of links_tpu/cli/_common.py it uses)."""

from __future__ import annotations

import argparse
import functools
from pathlib import Path

import torch

from links_tpu_torch.core import geometry
from links_tpu_torch.core.nn import full_f32_matmuls
from links_tpu_torch.data.datasets import MPI_SUBJECTS, TEST_SUBJECTS, load_h36m, load_mpi_inf_3dhp
from links_tpu_torch.data.synthetic import write_synthetic_pickle


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
    parser.add_argument("--test-scale", type=float, default=None,
                        help="override the fixed test-normalization scale")
    parser.add_argument("--model-dir", default="models", help="artifact directory")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the synthetic data")
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


_TEST_NORMS = {
    "h36m": geometry.normalize_head_test,
    "mpi_chest": geometry.normalize_head_test_mpi_chest,
    "mpi_vnect": geometry.normalize_head_test_mpi_vnect,
    "temporal": geometry.normalize_head_test_temporal,
}


def load_test(args):
    """The normalized test split (S9/S11 for h36m, S7/S8 for mpi)."""
    path = ensure_data(args)
    if args.dataset == "mpi":
        loader, subjects = load_mpi_inf_3dhp, MPI_SUBJECTS[-2:]
        norm = _TEST_NORMS[args.test_norm or "mpi_vnect"]
    else:
        loader, subjects = load_h36m, TEST_SUBJECTS
        norm = _TEST_NORMS[args.test_norm or "h36m"]
    if args.test_subjects:
        subjects = tuple(args.test_subjects.split(","))
    if args.test_scale:
        norm = functools.partial(geometry.normalize_head_test, scale=args.test_scale)
    return loader(path, subjects, normalize_func=norm)


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
