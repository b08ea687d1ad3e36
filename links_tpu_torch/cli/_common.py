"""Shared CLI plumbing of the port: the data, checkpoint and training flags
the serving lift and the trainers of stages 1, 2, 3a, 3b and 4 need (the
subset of links_tpu/cli/_common.py they use)."""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from pathlib import Path

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
)
from links_tpu_torch.data.synthetic import write_synthetic_pickle

# Artifact names of the flows (<name>.pt), as the JAX trainers' --save-pt names them
FULL_FLOW = "full_flow"
FLOW_LEFT = "flow_left"
FLOW_RIGHT = "flow_right"
FLOW_LEGS = "flow_legs"
FLOW_TORSO = "flow_torso"
# Lifter artifacts: the (left, right) pair the 3a trainer writes (the
# reference's names), the reference-layout pair, and the (legs, torso) pair
LR_LIFTERS = ("left_side_lifter_final.pt", "right_side_lifter_final.pt")
LR_LIFTERS_REFERENCE = ("left_lifter.pt", "right_lifter.pt")
LEG_TORSO_LIFTERS = ("leg_lifter.pt", "torso_lifter.pt")
# Stage 4's completers: <model-dir>/occlusion_model_weights/<name>_estimator.pt
# (the reference's names), one per completer of models.completers.COMPLETER_SPECS
COMPLETERS_DIR = "occlusion_model_weights"
# seed of the lifter trainers' unsupervised validation draws: fixed and
# independent of --seed, so the criterion compares across epochs and seeds
VAL_SEED = 20_000


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
    parser.add_argument("--bone-means", choices=["h36m", "mpi_vnect_interesting", "data"],
                        default="h36m",
                        help="bone-relation prior means: H36M's, those of MPI-INF-3DHP's "
                             "'vnect interesting' cameras, or the train split's 3D ground "
                             "truth's")
    return parser


# Flags of the JAX trainers that later slices port: accepted, then refused.
# The lifter and completer trainers also refuse --save-every, which in the
# JAX package paces only their run checkpoints, and --select-by, which picks
# their best checkpoint (neither ported yet).
UNPORTED_TRAIN_FLAGS = ("resume", "packed_data", "distributed", "num_devices", "wandb")
UNPORTED_LIFTER_FLAGS = UNPORTED_TRAIN_FLAGS + ("save_every", "select_by")


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
    parser.add_argument("--log", default=None,
                        help="JSONL metrics path (default <model-dir>/<stage>.jsonl)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to compute on (cuda, cuda:1, cpu)")
    parser.add_argument("--resume", action="store_true", help="(not yet ported)")
    parser.add_argument("--packed-data", default=None, help="(not yet ported)")
    parser.add_argument("--distributed", action="store_true", help="(not yet ported)")
    parser.add_argument("--num-devices", type=int, default=None, help="(not yet ported)")
    parser.add_argument("--wandb", action="store_true", help="(not yet ported)")
    parser.add_argument("--save-every", type=int, default=None,
                        help="flow trainers: write the flows every N epochs (default 1; "
                             "always the final epoch); lifter and completer trainers: not "
                             "yet ported")
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
    if args.nll_cap is not None and any(f.name == "nll_cap" for f in dataclasses.fields(cfg)):
        kw["nll_cap"] = args.nll_cap  # ignored by a stage with no flow term (stage 4)
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


def load_train(args):
    """The train split, normalized with ``normalize_head``."""
    path, loader, train_s, _, _ = _split_spec(args)
    return loader(path, train_s, normalize_func=geometry.normalize_head)


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
            f"no flow weights at {path}: train them first with "
            f"links_tpu_torch.cli.train_full_pose_norm_flow ({FULL_FLOW}.pt) and "
            f"links_tpu_torch.cli.train_part_norm_flows ({FLOW_LEFT}.pt, {FLOW_RIGHT}.pt, "
            f"{FLOW_LEGS}.pt, {FLOW_TORSO}.pt), or pass the FrEIA-layout .pt flows the JAX "
            f"flow trainers write with --save-pt")
    return load_flow_pt(path, device)


def load_stacked_lr(args, device):
    """The (left, right) lifter pair as a ``StackedLifter`` on ``device``, in
    the JAX package's order: ``--left-pt``/``--right-pt``; else the pair
    the stage-3a trainers write in ``--model-dir``
    (``{left,right}_side_lifter_final.pt``); else the reference-layout pair
    there (``{left,right}_lifter.pt``)."""
    from links_tpu_torch.ckpt.torch_io import load_lifter_pt
    from links_tpu_torch.models.lifters import StackedLifter

    left_pt, right_pt = args.left_pt, args.right_pt
    if bool(left_pt) != bool(right_pt):
        raise ValueError("--left-pt and --right-pt must be given together")
    if not left_pt:
        pairs = [[Path(args.model_dir) / f for f in names]
                 for names in (LR_LIFTERS, LR_LIFTERS_REFERENCE)]
        found = [p for p in pairs if all(f.exists() for f in p)]
        if not found:
            raise FileNotFoundError(
                f"no left/right lifter weights: expected {' + '.join(map(str, pairs[0]))} "
                f"(the stage-3a trainers write them) or {' + '.join(map(str, pairs[1]))} "
                f"(a reference .pt pair); train stage 3a first or pass --left-pt/--right-pt")
        left_pt, right_pt = found[0]
    return StackedLifter(load_lifter_pt(left_pt, device),
                         load_lifter_pt(right_pt, device))


def load_leg_torso(args, device):
    """(legs, torso) ``Lifter``s on ``device`` from the ``leg_lifter.pt`` and
    ``torso_lifter.pt`` that the stage-3b trainers write (the JAX one with
    --save-pt)."""
    from links_tpu_torch.ckpt.torch_io import load_lifter_pt

    paths = [Path(args.model_dir) / f for f in LEG_TORSO_LIFTERS]
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
    stage-4 trainers write them, the JAX one with --save-pt) as a
    ``ModuleDict`` keyed by name, in ``COMPLETER_SPECS`` order, on ``device``;
    each completer's width is its file's."""
    from links_tpu_torch.ckpt.torch_io import load_completer_pt
    from links_tpu_torch.models.completers import COMPLETER_SPECS

    paths = {name: completer_path(args, name) for name in COMPLETER_SPECS}
    missing = [str(p) for p in paths.values() if not p.exists()]
    if missing:
        raise FileNotFoundError(f"no completer weights: expected {missing}; train stage 4 "
                                f"first (links_tpu_torch.cli.train_occlusion_models)")
    return torch.nn.ModuleDict({name: load_completer_pt(p, device) for name, p in paths.items()})


def completer_path(args, name: str) -> Path:
    """Where the completer ``name`` lives: ``<model-dir>/occlusion_model_weights/
    <name>_estimator.pt``."""
    return Path(args.model_dir) / COMPLETERS_DIR / f"{name}_estimator.pt"


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
    """The bone-relation prior means that ``--bone-means`` names (16,)."""
    if args.bone_means == "data":
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


def log_record(fh, record: dict, **extra):
    """One JSON record per line (the JAX package's MetricLogger format)."""
    fh.write(json.dumps(dict(record, _time=time.time(), **extra)) + "\n")
    fh.flush()


def run_training(args, cfg, step, state, data: torch.Tensor, generator: torch.Generator,
                 log_name: str, config: dict, on_epoch, draw=None):
    """The trainers' epoch loop: ``cfg.n_epochs`` epochs of ``step`` over
    ``data`` (``train.loop.run_epoch``, with ``draw`` as there). After each
    epoch ``on_epoch(epoch, rec)`` may add to the record and write artifacts,
    and returns the text of the epoch's line after ``epoch N: ``; the record
    goes to the JSONL log (``--log``, default ``<model-dir>/<log_name>.jsonl``,
    after one ``_config`` record) and the line to stdout. -> (seconds spent
    in the epochs' steps, the last epoch's record)."""
    from links_tpu_torch.train.loop import run_epoch
    from links_tpu_torch.train.steps import draw_step

    log_path = Path(args.log) if args.log else Path(args.model_dir) / f"{log_name}.jsonl"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    step_seconds, rec = 0.0, {}
    with log_path.open("a") as log:
        log_record(log, {"_config": config})
        for epoch in range(cfg.n_epochs):
            t0 = time.perf_counter()
            rec = run_epoch(step, state, data, cfg.batch_size, generator, draw or draw_step)
            step_seconds += time.perf_counter() - t0  # run_epoch ends with a device read
            msg = on_epoch(epoch, rec)
            rec["epoch"] = epoch
            log_record(log, rec, _step=epoch)
            print(f"epoch {epoch}: {msg}", flush=True)
    return step_seconds, rec


def print_summary(cfg, state, device, step_seconds: float, rec: dict):
    """The trainers' one-line JSON summary: epochs, steps, device, the
    seconds spent in the epoch loops, poses/s and the last epoch's record."""
    poses = state.step * cfg.batch_size
    print(json.dumps({
        "epochs": cfg.n_epochs, "steps": state.step, "batch": cfg.batch_size,
        "device": str(device), "seconds": round(step_seconds, 4),
        "poses_per_sec": round(poses / step_seconds, 1) if step_seconds > 0 else None,
        "last": {k: v for k, v in rec.items() if k != "epoch"},
    }))
