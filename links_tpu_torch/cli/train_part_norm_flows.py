"""Stage 2: train the four part flows, left and right sides (22-d), legs
(14-d) and torso (20-d), on the splits of the train split's poses and of
samples from the frozen full-pose flow (counterpart of
links_tpu/cli/train_part_norm_flows.py).

Inputs: the dataset pickle (``--data``; the train split only, or an LNKS
pack of it with ``--packed-data``) and
``<model-dir>/full_flow.pt`` (stage 1). Outputs:
``<model-dir>/flow_{left,right,legs,torso}.pt`` in FrEIA's layout and the
run checkpoint ``<model-dir>/part_flows_run.pt``, written every due epoch
(``--save-every``, default 1; always the final one), a JSONL log, one line
per epoch on stdout and a one-line JSON summary. ``--resume`` goes on from
the run checkpoint; without it a run first removes these files.

``--num-devices N`` trains on N local data-parallel ranks (each on its rows
of every batch; ``--device cpu`` for gloo ranks on the CPU) and
``--distributed`` on the ranks of a launcher (``python -m
torch.distributed.run``); rank 0 writes every output (train/parallel.py).

Usage:
    python -m links_tpu_torch.cli.train_part_norm_flows --data data/h36m_data.pkl \\
        --model-dir models
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from links_tpu_torch.ckpt.torch_io import save_flow_pt
from links_tpu_torch.cli import _common as C
from links_tpu_torch.config import PartFlowTrainConfig
from links_tpu_torch.flows import Flow
from links_tpu_torch.objectives.flow_nll import PARTS, PartFlows
from links_tpu_torch.train import parallel
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import TrainState, build_part_flows_step, draw_noise

ARTIFACTS = dict(zip(PARTS, (C.FLOW_LEFT, C.FLOW_RIGHT, C.FLOW_LEGS, C.FLOW_TORSO)))


def main(argv=None, group=None):
    parser = argparse.ArgumentParser(
        description="Stage 2: train the four part flows (PyTorch port)")
    # the reference's flag (train_leg_torso_left_right_norm_flow.py:28-29)
    parser.add_argument("-l", "--left_right_side_keypoints", type=int, default=22,
                        help="number of key-points in each split")
    C.add_common_flags(parser)
    C.add_train_flags(parser)
    args = parser.parse_args(argv)
    cfg = C.resolve_cfg(args, PartFlowTrainConfig(side_keypoints=args.left_right_side_keypoints))
    group, device = C.start_ranks(args, cfg, main, argv, group)
    if group is C.SPAWNED:
        return None  # the ranks have trained the stage
    train_data, _, n_train, packed = C.load_train_test_or_packed(args, test=False, group=group)
    full_flow = C.load_flow(args, C.FULL_FLOW, device).requires_grad_(False)
    # 8 blocks at hidden 1024 each, in PARTS order from one generator
    init = torch.Generator().manual_seed(args.seed)
    dims = (cfg.side_keypoints, cfg.side_keypoints, cfg.leg_keypoints, cfg.torso_keypoints)
    parts = parallel.replicate(PartFlows(*(Flow(d, generator=init) for d in dims)).to(device),
                               group)
    steps_per_epoch = parallel.trimmed(n_train, group) // cfg.batch_size
    state = TrainState(parts, Adam(parts.parameters(), cfg.optim, steps_per_epoch))
    step = build_part_flows_step(full_flow, cfg, group)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = C.train_batches(train_data, packed, device, group)
    model_dir = Path(args.model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    C.clear_stage_artifacts(args, "part_flows", list(ARTIFACTS.values()), group)

    def save(final):
        for name, artifact in ARTIFACTS.items():
            save_flow_pt(getattr(parts, name), model_dir / f"{artifact}.pt")

    result = C.run_training(
        args, cfg, step, state, data, gen, "part_norm_flows",
        {"learning_rate": cfg.optim.learning_rate, "BATCH_SIZE": cfg.batch_size,
         "N_epochs": cfg.n_epochs}, lambda epoch, rec: f"loss={rec['loss']:.4f}", draw_noise,
        stage="part_flows", save=save, group=group)
    C.print_summary(cfg, state, device, result, group)
    return state


if __name__ == "__main__":
    main()
