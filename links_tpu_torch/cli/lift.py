"""Batch 2D->3D lifting inference, the serving surface (counterpart of
links_tpu/cli/lift.py).

Inputs:
  * ``--data``: a dataset pickle; the test split is normalized as eval does, or
  * ``--raw-2d``: a .npy/.npz of already-normalized (N, 34) poses.

``--fused`` runs both side lifters as one launch of the hand-written CUDA
kernel (ops/fused_infer.py; bf16 multiplies, chunks of at most 512 poses).
``--quant int8`` serves int8 weights with dynamic per-row activation scales,
``--quant int8-static`` with per-tensor scales calibrated on the first
``--calib-rows`` train poses (ops/quant.py); a quantized forward runs no
residual-block kernel.

``--scenario`` serves the occlusion story end to end: the scenario's 2D
keypoints are zeroed, the pose is lifted by the four lifters (left, right,
legs, torso) and the missing 3D part is infilled by the scenario's stage-4
completer (``<model-dir>/occlusion_model_weights/``). The lifters may be
attention lifters (3a ``--attention``), except under ``--fused``.

From ``--model-dir`` the trainers' best-epoch weights (``*_best.pt``,
``occlusion_model_weights_best/``) are read when they exist, unless
``--use-final``; ``--use-best`` requires them.

Output: ``--out`` .npz with ``poses_3d`` (N, 3, 17) and the ``poses_2d``
echo, plus one JSON summary line on stdout (count, wall time, poses/sec).

Example:
    python -m links_tpu_torch.cli.lift --data data/h36m_data.pkl \\
        --left-pt models/left_lifter.pt --right-pt models/right_lifter.pt \\
        --fused --out pred.npz
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from links_tpu_torch.cli import _common as C
from links_tpu_torch.core.nn import BF16, F32
from links_tpu_torch.objectives.occlusion import DROPOUT_SCENARIO_JOINTS
from links_tpu_torch.train.profiling import span


def _load_raw_2d(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        with np.load(path) as z:
            key = "poses_2d" if "poses_2d" in z else list(z.keys())[0]
            arr = z[key]
    else:
        arr = np.load(path)
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 3 and arr.shape[1:] == (2, 17):
        arr = arr.reshape(-1, 34)
    if arr.ndim != 2 or arr.shape[1] != 34:
        raise SystemExit(
            f"--raw-2d must be (N, 34) or (N, 2, 17) normalized 2D poses, "
            f"got {arr.shape}")
    return arr


def _chunks(fn, poses_2d: np.ndarray, batch: int, device, args: str | None = None) -> list:
    """Run ``fn`` over chunks of at most ``batch`` poses -> each chunk's
    output on the host. Per chunk, three spans with ``args``: ``lift.h2d``
    (the copy to ``device``), ``lift.forward`` (``fn``) and ``lift.d2h`` (the
    copy back, which waits for the device)."""
    outs = []
    for i in range(0, poses_2d.shape[0], batch):
        # one name for input and output: the device input is freed when the forward returns
        with span("lift.h2d", args):
            x = torch.from_numpy(poses_2d[i:i + batch]).to(device)
        with span("lift.forward", args):
            x = fn(x)
        with span("lift.d2h", args):
            outs.append(x.cpu())
    return outs


def _chunked(fn, poses_2d: np.ndarray, batch: int, device) -> np.ndarray:
    """``_chunks``' outputs, concatenated."""
    return torch.cat(_chunks(fn, poses_2d, batch, device)).numpy()


def add_serving_flags(parser):
    parser.add_argument("--mode", choices=["left_right", "leg_torso"],
                        default="left_right")
    parser.add_argument("--choice", choices=["left", "right"], default="right")
    parser.add_argument("--depth", type=float, default=10.0)
    parser.add_argument("--scenario", default=None, choices=sorted(DROPOUT_SCENARIO_JOINTS),
                        help="occluded-limb scenario: zero its 2D keypoints, lift the visible "
                             "part and infill the missing 3D joints with the stage-4 "
                             "completers")
    parser.add_argument("--fused", action="store_true",
                        help="left_right mode: run both side lifters as one "
                             "launch of the fused CUDA kernel (bf16 multiplies, "
                             "chunked at <=512 poses)")
    parser.add_argument("--quant", choices=["int8", "int8-static"], default=None,
                        help="post-training int8 quantization of the serving weights "
                             "(w8a8, int32 accumulation): int8 quantizes activations "
                             "with dynamic per-row scales; int8-static with per-tensor "
                             "scales calibrated offline on --calib-rows train poses")
    parser.add_argument("--calib-rows", type=int, default=1024,
                        help="train rows used to calibrate int8-static activation scales")
    parser.add_argument("--policy", choices=["f32", "bf16"], default="f32",
                        help="serving matmul dtype: bf16 multiplies with f32 "
                             "accumulation, or the eval-parity f32 default")


def build_serving_fn(args, batch: int, device):
    """The serving forward the flags describe, its per-call batch cap and the
    modules it reads its weights from, by name (lift, serve and
    export_model): the plain lifts, --scenario infill, --quant weights or the
    fused kernel."""
    from links_tpu_torch.objectives import occlusion as occ
    from links_tpu_torch.objectives.lifter import lift_left_right_eval, lift_leg_torso_eval

    if args.fused and (args.scenario or args.mode != "left_right"):
        raise SystemExit("--fused covers the plain left_right forward only; "
                         "it cannot serve --scenario infill or --mode leg_torso")
    if args.fused and args.quant:
        raise SystemExit("--fused and --quant are mutually exclusive "
                         "(the fused kernel multiplies in bf16)")
    if args.quant == "int8-static" and args.scenario:
        raise SystemExit("--quant int8-static calibrates the plain left_right/leg_torso "
                         "forwards only; the --scenario completer-infill program serves "
                         "--quant int8 (dynamic scales)")
    policy = BF16 if args.policy == "bf16" else F32
    if args.scenario:
        lifters = C.maybe_quantize(C.load_all_lifters(args, device), args)
        completers = C.maybe_quantize(C.load_completers(args, device), args)
        joints = DROPOUT_SCENARIO_JOINTS[args.scenario]
        return (lambda p2d: occ.occlusion_validation_poses(
            completers, lifters, occ.drop_keypoints(p2d, joints), args.depth, policy,
            scenarios=(args.scenario,))[args.scenario], batch,
            # the one completer the scenario runs
            {"lifters": torch.nn.ModuleDict(lifters),
             "completer": completers[occ.SCENARIO_COMPLETER[args.scenario]]})
    if args.mode == "leg_torso":
        legs, torso = C.load_leg_torso(args, device)
        legs, torso = C.quantize_leg_torso(args, legs, torso)
        return (lambda p2d: lift_leg_torso_eval(legs, torso, p2d, args.depth, policy),
                batch, {"legs": legs, "torso": torso})
    stacked = C.load_stacked_lr(args, device)
    stacked = C.quantize_lr(args, stacked)
    if args.fused:
        from links_tpu_torch.ops.fused_infer import (
            MAX_BATCH,
            lift_left_right_eval_fused,
            prepare_fused_weights,
        )

        prep = prepare_fused_weights(stacked)
        return (lambda p2d: lift_left_right_eval_fused(prep, p2d, args.depth, args.choice),
                min(batch, MAX_BATCH), {"stacked": stacked})
    return (lambda p2d: lift_left_right_eval(stacked, p2d, args.depth, args.choice, policy),
            batch, {"stacked": stacked})


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Batch 2D->3D pose lifting (serving path, PyTorch port)")
    add_serving_flags(parser)
    parser.add_argument("--raw-2d", default=None,
                        help=".npy/.npz of normalized (N,34) 2D poses; "
                             "bypasses the dataset loader")
    parser.add_argument("--out", required=True, help="output .npz path")
    parser.add_argument("--limit", type=int, default=None,
                        help="lift only the first N poses")
    C.add_device_flag(parser)
    C.add_common_flags(parser)
    C.add_lr_pt_flags(parser)
    C.add_use_best_flag(parser)
    args = parser.parse_args(argv)
    device = C.resolve_device(args.device)

    if args.raw_2d:
        poses_2d = _load_raw_2d(args.raw_2d)
    else:
        poses_2d = C.load_test(args).poses_2d.numpy()
    if args.limit:
        poses_2d = poses_2d[: args.limit]
    n = poses_2d.shape[0]
    if n == 0:
        raise SystemExit("no poses to lift: the input is empty")
    batch = min(args.batch_size or 256, n)

    with torch.inference_mode():
        fn, batch, _ = build_serving_fn(args, batch, device)
        _chunked(fn, poses_2d[:batch], batch, device)  # warm up (kernel build, allocator)
        t0 = time.perf_counter()
        pred = _chunked(fn, poses_2d, batch, device)
        dt = time.perf_counter() - t0

    pred_3d = pred.reshape(n, 3, 17)
    np.savez_compressed(args.out, poses_3d=pred_3d, poses_2d=poses_2d)
    print(json.dumps({
        "poses": n, "batch": batch, "mode": args.mode, "quant": args.quant,
        "scenario": args.scenario, "seconds": round(dt, 4),
        "poses_per_sec": round(n / dt, 1) if dt > 0 else None,
        "out": args.out,
    }))
    return pred_3d


if __name__ == "__main__":
    main()
