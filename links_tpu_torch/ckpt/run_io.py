"""Run checkpoints of the port's trainers (counterpart of ``save_run`` and
``maybe_resume`` in links_tpu/cli/_common.py): everything a stopped run
needs to go on as if it had not stopped.

``<model-dir>/<stage>_run.pt`` (stages ``full_flow``, ``part_flows``,
``left_right``, ``leg_torso``, ``occlusion``, the JAX package's names)
holds the trained model's ``state_dict`` (a flow's fixed mixing matrices
included), the ``Adam`` state (its moments at their stored dtype and its
update count, which the staircase learning rate reads), ``TrainState.step``,
the epoch to start from, and the state of the run's ``torch.Generator``, so
a resumed run draws the same permutations and noise as one that never
stopped. The file is written atomically: a crash mid-write leaves the
previous checkpoint. Under data parallelism rank 0 alone writes it and every
rank resumes from it (``cli/_common.py:run_training``).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from links_tpu_torch.ckpt.torch_io import atomic_save


def run_path(args, stage: str) -> Path:
    return Path(args.model_dir) / f"{stage}_run.pt"


def save_run(args, stage: str, state, generator: torch.Generator, next_epoch: int) -> None:
    """Write ``state`` (a ``TrainState``), ``generator``'s state and the epoch
    a resumed run starts from."""
    path = run_path(args, stage)
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_save({"model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                 "opt": state.opt.state_dict(), "step": state.step,
                 "next_epoch": next_epoch, "generator": generator.get_state()}, path)


def maybe_resume(args, stage: str, state, generator: torch.Generator) -> int:
    """Restore the run checkpoint into ``state`` and ``generator`` when
    --resume is set and one exists. -> the epoch to start from (0 otherwise).
    The weights are loaded in place (``load_state_dict`` bumps each
    parameter's version, so no cached bf16 weight plane outlives them)."""
    path = run_path(args, stage)
    if not getattr(args, "resume", False) or not path.exists():
        return 0
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.opt.load_state_dict(payload["opt"])
    state.step = int(payload["step"])
    generator.set_state(payload["generator"])
    start = int(payload["next_epoch"])
    print(f"[links_tpu_torch] resuming {stage} from epoch {start}", file=sys.stderr)
    return start
