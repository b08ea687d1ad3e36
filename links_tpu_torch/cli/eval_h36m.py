"""Stage 5: evaluate the lifters on the test split (counterpart of
links_tpu/cli/eval_h36m.py): PA-MPJPE (reflection='best'), N-MPJPE, the
unscaled MPJPE, PCK, AUC and the reference's CPS pair over the whole split.

``--mode leg_torso`` evaluates the legs/torso lifters instead of the
left/right pair. ``--occlusion`` adds the eight occlusion scenarios (partial
poses from mixed lifters, infilled by the stage-4 completers);
``--dropout`` lifting under simulated keypoint dropout, per scenario with
the completer's recovery and the plain lift of the same corrupted 2D;
``--from-detections`` (with ``--no-gt-2d``) the recovery of the test
split's genuinely missing detector keypoints: a lost root is imputed at the
hip midpoint when both hips were detected, each incomplete frame goes to
the smallest scenario covering its missing joints, or else to the smallest
pair of scenarios whose union does (two completers composed), and the
``det_*`` keys report the counts and errors.

The device math runs on ``--device`` (default ``cuda``) under
``torch.no_grad()``: the lifts and completers through the residual-block
kernel there (f32 by default, ``--policy bf16``), each metric group read
back to the host once. ``--quant int8`` evaluates int8 serving weights
(dynamic activation scales), ``--quant int8-static`` the lifters with
scales calibrated on ``--calib-rows`` train poses; the occlusion paths have
no calibration forward and serve dynamic scales under it, which the results
record as ``quant_fallback_dynamic``. The lifters and completers are read from
``--model-dir`` as the trainers wrote them, their best epoch's by default
(``--use-final``/``--use-best``), or the pair ``--left-pt/--right-pt``.

Usage:
    python -m links_tpu_torch.cli.eval_h36m --data data/h36m_data.pkl \\
        --model-dir models [--mode left_right] [--occlusion] [--json]
"""

from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from links_tpu_torch import metrics
from links_tpu_torch.cli import _common as C
from links_tpu_torch.core.nn import BF16, F32
from links_tpu_torch.data.datasets import read_pickle
from links_tpu_torch.models.lifters import StackedLifter
from links_tpu_torch.objectives import occlusion as occ
from links_tpu_torch.objectives.lifter import lift_left_right_eval, lift_leg_torso_eval

MPJPE_UNITS = ("reconstruction-space (unscaled protocol-1; predictions are normalized-2D x "
               "depth, GT units differ — use pa_mpjpe/n_mpjpe for scale-corrected errors)")


def _read(values: dict) -> dict[str, float]:
    """A dict of scalar tensors as floats, in one read from the device, its
    keys sorted (the order in which the JAX package's jitted groups print)."""
    keys = sorted(values)
    return dict(zip(keys, torch.stack([values[k].float() for k in keys]).tolist()))


def base_metrics(gt: torch.Tensor, pred: torch.Tensor) -> dict[str, float]:
    """The headline metrics of (N, 51) lifts against the 3D ground truth."""
    ga = metrics.get_all(gt, pred)
    return _read({
        "pa_mpjpe": metrics.pa_mpjpe(gt, pred).mean(),
        "cps": ga["CPS"],
        "cps_correct": ga["CPS_correct"],
        "mpjpe": metrics.n_mpjpe(gt, pred, use_scaling=False).mean(),
        "n_mpjpe": metrics.n_mpjpe(gt, pred).mean(),
        "pck": metrics.pck(gt, pred),
        "auc": metrics.auc(gt, pred),
    })


def occlusion_metrics(completers, lifters: dict, gt: torch.Tensor, test_2d: torch.Tensor,
                      depth: float, policy) -> dict[str, float]:
    """PA-MPJPE and N-MPJPE of the eight occlusion scenarios' poses."""
    out = {}
    for name, pred in occ.occlusion_validation_poses(completers, lifters, test_2d, depth,
                                                     policy).items():
        out[f"pa_{name}"] = metrics.pa_mpjpe(gt, pred).mean()
        out[f"n_mpjpe_{name}"] = metrics.n_mpjpe(gt, pred).mean()
    return _read(out)


def dropout_metrics(completers, lifters: dict, gt: torch.Tensor, test_2d: torch.Tensor,
                    depth: float, choice: str, policy) -> dict[str, float]:
    """PA-MPJPE of each dropout scenario's recovered pose and of the plain
    lift of the same corrupted 2D."""
    out = {}
    for name, (rec, naive) in occ.dropout_eval_poses(completers, lifters, test_2d, depth,
                                                     policy, choice).items():
        out[f"dropout_pa_{name}"] = metrics.pa_mpjpe(gt, rec).mean()
        out[f"dropout_naive_pa_{name}"] = metrics.pa_mpjpe(gt, naive).mean()
    return _read(out)


def detection_plan(missing: np.ndarray):
    """Which completers serve each frame of a (N, 17) missing-joint mask:
    an incomplete frame goes to the smallest scenario whose joints cover its
    missing ones; one that none covers, to the pair of smallest summed size
    whose union does (the first scenario's recovery, with the joints it left
    missing from the second's); a frame whose root is missing, to none. ->
    (scenario names by size, their joint sets, the (N,) assigned scenario
    ('' for none), [(row, first, second)] of the composed frames)."""
    joints = occ.DROPOUT_SCENARIO_JOINTS
    names = sorted(joints, key=lambda n: len(joints[n]))
    jsets = {n: frozenset(joints[n]) for n in names}
    incomplete = missing.any(axis=1)
    assigned = np.full(missing.shape[0], "", dtype=object)
    for n in names:
        mask = np.isin(np.arange(missing.shape[1]), joints[n])
        covers = incomplete & ~np.any(missing & ~mask[None], axis=1) & (assigned == "")
        assigned[covers] = n
    pairs = sorted(itertools.combinations(names, 2),
                   key=lambda p: len(jsets[p[0]]) + len(jsets[p[1]]))
    composed = []
    for i in np.where(incomplete & (assigned == ""))[0]:
        lost = frozenset(np.where(missing[i])[0])
        pick = next((p for p in pairs if lost <= (jsets[p[0]] | jsets[p[1]])), None)
        if pick is not None:
            composed.append((int(i), *pick))
    return names, jsets, assigned, composed


def detection_inputs(args):
    """The test split's detector 2D as eval reads it for --from-detections:
    -> ((N, 34) normalized 2D with the missing joints zeroed, (N, 17)
    missing mask after the root imputation, (N,) root-imputed rows, (N, 51)
    3D ground truth), over every frame, complete or not."""
    path, loader, _, test_s, test_norm, _ = C._split_spec(args)
    data = read_pickle(path)
    if not all("poses_2d_pred" in data[s] for s in test_s):
        raise SystemExit(f"{path} has no poses_2d_pred detector arrays")
    raw2d = np.concatenate([np.asarray(data[s]["poses_2d_pred"]) for s in test_s])
    missing = np.all(raw2d == 0.0, axis=2)
    # a lost root at the hip midpoint (pixel space, before normalizing) when
    # both hips were detected
    root_fix = missing[:, 0] & ~missing[:, 1] & ~missing[:, 4]
    raw2d = raw2d.copy()
    raw2d[root_fix, 0] = 0.5 * (raw2d[root_fix, 1] + raw2d[root_fix, 4])
    missing = missing.copy()
    missing[root_fix, 0] = False
    # normalize every frame as the loader does, then zero the missing joints
    # again: the normalization must not leak a position for an undetected one
    flat = raw2d.transpose(0, 2, 1).reshape(-1, 34).astype(np.float32)
    p2d = test_norm(torch.from_numpy(flat)).numpy().reshape(-1, 2, 17)
    p2d = (p2d * ~missing[:, None, :]).reshape(-1, 34).astype(np.float32)
    gt = loader(path, test_s, normalize_func=test_norm, use_gt=False,
                complete_only=False).poses_3d
    return p2d, missing, root_fix, gt


def _eval_from_detections(args, completers, lifters: dict, device, policy) -> dict:
    """The ``det_*`` results of --from-detections (see the module's text)."""
    p2d_np, missing, root_fix, gt = detection_inputs(args)
    names, jsets, assigned, composed = detection_plan(missing)
    p2d, gt = torch.from_numpy(p2d_np).to(device), gt.to(device)
    recs, rows = {}, []
    for name, (rec, naive) in occ.dropout_eval_poses(completers, lifters, p2d, args.depth,
                                                     policy, args.choice).items():
        recs[name] = rec
        rows += [metrics.pa_mpjpe(gt, rec), metrics.pa_mpjpe(gt, naive)]
    per_row = torch.stack(rows).cpu().numpy().reshape(len(recs), 2, -1)
    pa = dict(zip(recs, per_row))  # scenario -> (recovered, naive) per-row PA

    incomplete = missing.any(axis=1)
    uncovered = incomplete & (assigned == "")
    out = {"det_frames": int(missing.shape[0]),
           "det_complete_frac": float(1.0 - incomplete.mean()),
           "det_uncovered": int(uncovered.sum()),
           "det_root_imputed": int(root_fix.sum())}
    for n in names:
        sel = assigned == n
        out[f"det_n_{n}"] = int(sel.sum())
        if sel.any():
            out[f"det_pa_{n}"] = float(pa[n][0][sel].mean())
            out[f"det_naive_pa_{n}"] = float(pa[n][1][sel].mean())
    covered = np.where(incomplete & (assigned != ""))[0]
    singles = [pa[assigned[i]][:, i] for i in covered]  # (recovered, naive) per frame
    if singles:
        out["det_pa_recovered_mean"] = float(np.mean([s[0] for s in singles]))
        out["det_pa_naive_mean"] = float(np.mean([s[1] for s in singles]))
    out["det_n_composed"] = len(composed)
    out["det_unserved"] = int(uncovered.sum()) - len(composed)
    if composed:
        order = list(recs)
        idx, first, second = zip(*composed)
        sel = torch.as_tensor(idx, device=device)
        stack = torch.stack([recs[n] for n in order])  # (8, N, 51)
        # the second scenario's joints where the first left them missing
        cols = np.zeros((len(composed), 3, 17), dtype=bool)
        for k, (i, s1, _) in enumerate(composed):
            cols[k, :, sorted(frozenset(np.where(missing[i])[0]) - jsets[s1])] = True
        merged = torch.where(
            torch.from_numpy(cols.reshape(-1, 51)).to(device),
            stack[torch.as_tensor([order.index(s) for s in second], device=device), sel],
            stack[torch.as_tensor([order.index(s) for s in first], device=device), sel])
        naive = lift_left_right_eval(StackedLifter(lifters["left"], lifters["right"]),
                                     p2d[sel], args.depth, args.choice, policy)
        pa_c, pa_nv = torch.stack([metrics.pa_mpjpe(gt[sel], merged),
                                   metrics.pa_mpjpe(gt[sel], naive)]).cpu().numpy()
        out["det_pa_composed"] = float(pa_c.mean())
        out["det_naive_pa_composed"] = float(pa_nv.mean())
        pair_of = np.array([f"{s1}+{s2}" for _, s1, s2 in composed])
        for p in sorted(set(pair_of)):
            psel = pair_of == p
            out[f"det_n_pair_{p}"] = int(psel.sum())
            out[f"det_pa_pair_{p}"] = float(pa_c[psel].mean())
        # pooled over every served incomplete frame (singles and composed)
        out["det_pa_all_served_mean"] = float(
            np.mean(np.concatenate([[s[0] for s in singles], pa_c])))
        out["det_naive_pa_all_served_mean"] = float(
            np.mean(np.concatenate([[s[1] for s in singles], pa_nv])))
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate on Human3.6M (PyTorch port)")
    parser.add_argument("--mode", choices=["left_right", "leg_torso"], default="left_right")
    parser.add_argument("--choice", choices=["left", "right"], default="right",
                        help="which side supplies the shared joints")
    parser.add_argument("--depth", type=float, default=10.0)
    parser.add_argument("--occlusion", action="store_true",
                        help="also evaluate the 8 occlusion scenarios")
    parser.add_argument("--dropout", action="store_true",
                        help="evaluate lifting under simulated 2D keypoint dropout: per "
                             "scenario, zero the limb's keypoints, recover with the "
                             "completers, and compare with the plain lift")
    parser.add_argument("--from-detections", action="store_true",
                        help="evaluate occlusion recovery on the test split's genuinely "
                             "missing detector keypoints (needs --no-gt-2d and a pickle with "
                             "poses_2d_pred)")
    parser.add_argument("--json", action="store_true", help="emit one JSON line")
    parser.add_argument("--quant", choices=["int8", "int8-static"], default=None,
                        help="evaluate with int8-quantized serving weights: the accuracy "
                             "cost of lift/serve --quant int8 or int8-static (static "
                             "per-tensor activation scales calibrated on --calib-rows "
                             "train rows)")
    parser.add_argument("--calib-rows", type=int, default=1024,
                        help="train rows for int8-static calibration")
    parser.add_argument("--policy", choices=["f32", "bf16"], default="f32",
                        help="lifting matmul dtype")
    C.add_common_flags(parser)
    C.add_lr_pt_flags(parser)
    C.add_use_best_flag(parser)
    C.add_device_flag(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.from_detections and args.gt_2d:
        raise SystemExit("--from-detections needs --no-gt-2d: it evaluates the detector "
                         "corpus's genuinely missing keypoints")
    device = C.resolve_device(args.device)
    policy = BF16 if args.policy == "bf16" else F32

    test = C.load_test(args)
    test2d, test3d = test.poses_2d.to(device), test.poses_3d.to(device)
    with torch.no_grad():
        if args.mode == "left_right":
            stacked = C.load_stacked_lr(args, device)
            stacked = C.quantize_lr(args, stacked)
            pred = lift_left_right_eval(stacked, test2d, args.depth, args.choice, policy)
        else:
            legs, torso = C.load_leg_torso(args, device)
            legs, torso = C.quantize_leg_torso(args, legs, torso)
            pred = lift_leg_torso_eval(legs, torso, test2d, args.depth, policy)
        results = base_metrics(test3d, pred)
        results["mpjpe_units"] = MPJPE_UNITS
        if args.occlusion or args.dropout or args.from_detections:
            lifters = C.maybe_quantize(C.load_all_lifters(args, device), args)
            completers = C.maybe_quantize(C.load_completers(args, device), args)
            if args.quant == "int8-static":
                # no calibration forward exists for the occlusion paths: they
                # served dynamic scales, and the results say so
                results["quant_fallback_dynamic"] = ["lifters", "completers"]
        if args.from_detections:
            results.update(_eval_from_detections(args, completers, lifters, device, policy))
        if args.dropout:
            results.update(dropout_metrics(completers, lifters, test3d, test2d, args.depth,
                                           args.choice, policy))
        if args.occlusion:
            results.update(occlusion_metrics(completers, lifters, test3d, test2d, args.depth,
                                             policy))

    if args.json:
        print(json.dumps(results))
    else:
        print("The PA-MPJPE error was " + str(results["pa_mpjpe"]))
        print("The N-MPJPE error was " + str(results["n_mpjpe"]))
        for k, v in results.items():
            if k in ("pa_mpjpe", "n_mpjpe", "mpjpe_units"):
                continue
            note = " [unscaled reconstruction units, not mm]" if k == "mpjpe" else ""
            v = f"{v:.4f}" if isinstance(v, float) else v
            print(f"{k}: {v}{note}")
    return results


if __name__ == "__main__":
    main()
