"""Export a serving forward as a ``torch.export`` artifact (counterpart of
links_tpu/cli/export_model.py, ``links-export``), and ``--inspect`` an
existing one.

The exported programs are ``lift``'s serving forwards (``build_serving_fn``):

* ``--mode left_right`` (default): the left/right side lifters;
* ``--mode leg_torso``: the legs and torso lifters;
* ``--scenario <limb>``: zero the limb's 2D keypoints, lift the visible part
  with the four lifters and infill the missing 3D joints with the stage-4
  completer;

each under ``--policy`` or ``--quant int8|int8-static``. The residual
blocks stay K1, as the registered op ``links_tpu_torch::res_block_forward``
(ckpt/export_io.py says what that costs a loading process); ``--fused`` is
refused, as the JAX package refuses it.

Contract: input (B, 34) normalized 2D poses, output (B, 51) camera-frame
3D; B is symbolic unless ``--batch`` pins it. ``--platforms`` (default
``cuda,cpu``) names the device types the file may be loaded on; a load on
any other is refused. ``--verify``
(default on) loads the artifact on ``--device`` and holds it against the
live forward on a seeded probe (rtol = atol = 1e-5). One JSON line on stdout.

Usage:
    python -m links_tpu_torch.cli.export_model --model-dir models --out lr.pt2
    python -m links_tpu_torch.cli.export_model --inspect lr.pt2
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from links_tpu_torch import ckpt
from links_tpu_torch.cli import _common as C
from links_tpu_torch.cli.lift import add_serving_flags, build_serving_fn
from links_tpu_torch.ckpt.export_io import ServingProgram, program_specs

VERIFY_TOL = 1e-5  # rtol = atol, as the JAX package verifies


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Export a serving forward as a torch.export artifact (PyTorch port)")
    add_serving_flags(parser)
    parser.add_argument("--out", default=None, help="artifact path (required unless --inspect)")
    parser.add_argument("--batch", type=int, default=None,
                        help="pin the batch dimension (default: symbolic)")
    parser.add_argument("--platforms", default="cuda,cpu",
                        help="comma-separated device types the artifact may be loaded on "
                             "(a load on any other is refused)")
    parser.add_argument("--mlir-out", default=None,
                        help="also write the exported program as text")
    parser.add_argument("--no-verify", action="store_true",
                        help="skip the load-and-compare round trip")
    parser.add_argument("--inspect", metavar="ARTIFACT", default=None,
                        help="print an existing artifact's metadata and exit")
    C.add_device_flag(parser)
    C.add_common_flags(parser)
    C.add_lr_pt_flags(parser)
    C.add_use_best_flag(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.inspect:
        info = ckpt.exported_info(args.inspect)
        print(json.dumps(info))
        return info
    if not args.out:
        raise SystemExit("--out is required (or use --inspect)")
    if args.fused:
        raise SystemExit("--fused is a live-serving option (lift, serve); the fused kernel "
                         "is not exported: export the residual-block path")
    if args.quant == "int8-static" and args.scenario:
        raise SystemExit("--quant int8-static calibrates the plain left_right/leg_torso "
                         "forwards only; export the --scenario program with --quant int8")
    device = C.resolve_device(args.device)
    platforms = [p.strip() for p in args.platforms.split(",") if p.strip()]
    if not args.no_verify and device.type not in platforms:
        raise SystemExit(f"--platforms {args.platforms} does not name {device.type}, where "
                         f"the artifact is verified: add it, or pass --no-verify")

    # weights as plain tensors (not inference tensors, which torch.export
    # refuses), traced without autograd
    with torch.no_grad():
        fwd, _, models = build_serving_fn(args, args.batch or 256, device)
        program = ServingProgram(fwd, models)
        exp, nbytes = ckpt.export_serving(program, args.out, batch=args.batch,
                                          platforms=platforms, device=device,
                                          mlir_out=args.mlir_out)
        verified = None
        if not args.no_verify:
            served = ckpt.load_exported(args.out, device)
            probe = np.random.default_rng(0).normal(size=(args.batch or 4, 34)).astype(np.float32)
            probe[:, 0] = 0.0
            probe = torch.from_numpy(probe).to(device)
            np.testing.assert_allclose(served(probe).cpu().numpy(), fwd(probe).cpu().numpy(),
                                       rtol=VERIFY_TOL, atol=VERIFY_TOL)
            verified = True

    summary = {
        "out": args.out, "bytes": nbytes, "platforms": platforms,
        "batch": args.batch if args.batch else "symbolic",
        "mode": args.mode, "scenario": args.scenario, "quant": args.quant,
        "policy": args.policy, "outputs": program_specs(exp)[1], "verified": verified,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
