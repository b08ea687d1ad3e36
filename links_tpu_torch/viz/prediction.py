"""Prediction visualiser (counterpart of links_tpu/viz/prediction.py): lift
test frames with the trained lifters, optionally infill an occluded part
with a completer, Procrustes-align (reflection='best') to the ground truth
and render the comparison.

Each view is a data function (tensors in, numpy out, no matplotlib) and a
render function that calls it. The data functions run on the device of the
models they are given; the test poses may lie on the CPU (the frames asked
for are moved).
"""

from __future__ import annotations

import numpy as np
import torch

from links_tpu_torch import metrics
from links_tpu_torch.core.nn import F32
from links_tpu_torch.objectives.lifter import lift_left_right_eval
from links_tpu_torch.objectives.occlusion import dropout_eval_poses, occlusion_validation_poses
from links_tpu_torch.viz.skeletons import compare_poses_3d


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _frame_data(gt: torch.Tensor, pred: torch.Tensor):
    """(1, 51) ground truth and prediction -> (gt (51,), aligned prediction
    (51,), the frame's PA-MPJPE)."""
    aligned = metrics.procrustes_align(gt, pred).reshape(51)
    return _numpy(gt[0]), _numpy(aligned), float(metrics.pa_mpjpe(gt, pred)[0])


@torch.no_grad()
def prediction_data(stacked, test_2d: torch.Tensor, test_3d: torch.Tensor, frame: int,
                    depth: float = 10.0):
    """Lift frame ``frame`` with the left/right ``StackedLifter`` (f32, the
    right side's shared joints) -> (gt (51,), aligned prediction (51,),
    PA-MPJPE in mm)."""
    dev = _device(stacked)
    pred = lift_left_right_eval(stacked, test_2d[frame:frame + 1].to(dev), depth, "right", F32)
    return _frame_data(test_3d[frame:frame + 1].to(dev), pred)


@torch.no_grad()
def occlusion_data(completers, lifters: dict, test_2d: torch.Tensor, test_3d: torch.Tensor,
                   frame: int, scenario: str = "left", depth: float = 10.0):
    """The completed pose of frame ``frame`` under occlusion ``scenario``
    (la/ra/ll/rl/torso/legs/left/right; only its completer runs) -> (gt
    (51,), aligned completed pose (51,), PA-MPJPE in mm)."""
    dev = _device(completers)
    pred = occlusion_validation_poses(completers, lifters, test_2d[frame:frame + 1].to(dev),
                                      depth, F32, scenarios=(scenario,))[scenario]
    return _frame_data(test_3d[frame:frame + 1].to(dev), pred)


@torch.no_grad()
def sequence_data(stacked, poses_2d: torch.Tensor, poses_3d: torch.Tensor, depth: float = 10.0,
                  choice: str = "right"):
    """A clip of T frames lifted by the left/right pair -> (gt (T, 3, 17),
    aligned prediction (T, 3, 17))."""
    dev = _device(stacked)
    gt = poses_3d.to(dev)
    pred = lift_left_right_eval(stacked, poses_2d.to(dev), depth, choice, F32)
    return _numpy(gt.reshape(-1, 3, 17)), _numpy(metrics.procrustes_align(gt, pred))


@torch.no_grad()
def occlusion_sequence_data(completers, lifters: dict, poses_2d: torch.Tensor,
                            poses_3d: torch.Tensor, scenario: str, depth: float = 10.0,
                            choice: str = "right"):
    """A clip of T frames under the keypoint dropout of ``scenario``
    (``dropout_eval_poses``, that scenario only) -> (gt, aligned naive lift
    of the occluded 2D, aligned completer-recovered pose), each (T, 3, 17)."""
    dev = _device(completers)
    gt = poses_3d.to(dev)
    rec, naive = dropout_eval_poses(completers, lifters, poses_2d.to(dev), depth, F32, choice,
                                    scenarios=(scenario,))[scenario]
    return (_numpy(gt.reshape(-1, 3, 17)), _numpy(metrics.procrustes_align(gt, naive)),
            _numpy(metrics.procrustes_align(gt, rec)))


def visualise_prediction(stacked, test_2d, test_3d, frame: int, depth: float = 10.0,
                         out_path=None):
    """Render GT vs the aligned prediction of one frame. -> (figure,
    PA-MPJPE of the frame)."""
    gt, aligned, err = prediction_data(stacked, test_2d, test_3d, frame, depth)
    fig = compare_poses_3d([gt, aligned],
                           titles=["ground truth", f"prediction (PA-MPJPE {err:.1f}mm)"],
                           out_path=out_path)
    return fig, err


def visualise_occlusion(completers, lifters, test_2d, test_3d, frame: int,
                        scenario: str = "left", depth: float = 10.0, out_path=None):
    """Render GT vs the completed pose of one frame under one occlusion
    scenario. -> (figure, PA-MPJPE of the frame)."""
    gt, aligned, err = occlusion_data(completers, lifters, test_2d, test_3d, frame, scenario,
                                      depth)
    fig = compare_poses_3d([gt, aligned],
                           titles=["ground truth",
                                   f"occluded '{scenario}' completed (PA {err:.1f}mm)"],
                           out_path=out_path)
    return fig, err
