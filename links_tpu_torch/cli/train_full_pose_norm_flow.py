"""Stage 1: train the full-pose 2D normalizing flow that the later stages
sample from (counterpart of links_tpu/cli/train_full_pose_norm_flow.py):
its NLL on the train split's poses plus its NLL on its own samples around
them.

Inputs: the dataset pickle (``--data``; the train split only), or an LNKS
pack of the train split (``--packed-data``, train/feed.py). Outputs:
``<model-dir>/full_flow.pt`` in FrEIA's layout (its fixed mixing matrices
included) and the run checkpoint ``<model-dir>/full_flow_run.pt``, written
every due epoch (``--save-every``, default 1; always the final one), a JSONL
log, one line per epoch on stdout and a one-line JSON summary. ``--resume``
goes on from the run checkpoint; without it a run first removes both
files.

Usage:
    python -m links_tpu_torch.cli.train_full_pose_norm_flow --data data/h36m_data.pkl \\
        --model-dir models
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from links_tpu_torch.ckpt.torch_io import save_flow_pt
from links_tpu_torch.cli import _common as C
from links_tpu_torch.config import FlowTrainConfig
from links_tpu_torch.flows import Flow
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import TrainState, build_full_flow_step, draw_noise


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Stage 1: train the full-pose 2D flow (PyTorch port)")
    # the reference's flag (train_full_pose_norm_flow.py:22-23)
    parser.add_argument("-n", "--num_keypoints", type=int, default=34,
                        help="number of keypoints")
    C.add_common_flags(parser)
    C.add_train_flags(parser)
    args = parser.parse_args(argv)
    C.refuse_unported(args)
    device = C.resolve_device(args.device)

    cfg = C.resolve_cfg(args, FlowTrainConfig(num_keypoints=args.num_keypoints))
    train_data, _, n_train, packed = C.load_train_test_or_packed(args, test=False)
    # 8 blocks at hidden 1024, as the JAX package's init_flow
    flow = Flow(cfg.num_keypoints, generator=torch.Generator().manual_seed(args.seed))
    flow = flow.to(device)
    steps_per_epoch = n_train // cfg.batch_size
    state = TrainState(flow, Adam(flow.parameters(), cfg.optim, steps_per_epoch))
    step = build_full_flow_step(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = C.train_batches(train_data, packed, device)
    model_dir = Path(args.model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    C.clear_stage_artifacts(args, "full_flow", [C.FULL_FLOW])

    result = C.run_training(
        args, cfg, step, state, data, gen, "full_pose_norm_flow",
        {"learning_rate": cfg.optim.learning_rate, "BATCH_SIZE": cfg.batch_size,
         "N_epochs": cfg.n_epochs, "num_keypoints": cfg.num_keypoints},
        lambda epoch, rec: " ".join(f"{k}={v:.4f}" for k, v in rec.items()), draw_noise,
        stage="full_flow", save=lambda final: save_flow_pt(flow, model_dir / f"{C.FULL_FLOW}.pt"))
    C.print_summary(cfg, state, device, result)
    return state


if __name__ == "__main__":
    main()
