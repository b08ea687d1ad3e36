"""Eval forwards of the lifters (counterpart of the eval functions in
links_tpu/objectives/lifter.py): lift, pin the root's depth offset to 0, add
the depth offset (no clamp at eval) and reconstruct camera-frame 3D."""

from __future__ import annotations

import torch

from links_tpu_torch.core.nn import F32, Policy
from links_tpu_torch.core.skeleton import (
    combine_left_right_pred_1d,
    split_data_left_right,
    split_data_legs_torso,
)


def depth_to_camera_3d(poses_2d: torch.Tensor, pred: torch.Tensor,
                       depth_offset: float) -> torch.Tensor:
    """(N, 34) normalized 2D + (N, 17) depth offsets -> (N, 51) camera-frame
    3D: X = x z, Y = y z, Z = z with z = pred + depth_offset, root pinned."""
    n = poses_2d.shape[0]
    pred = pred.clone()
    pred[:, 0] = 0.0
    depth = pred + depth_offset
    p2 = poses_2d.reshape(n, 2, 17)
    return torch.cat([(p2 * depth[:, None, :]).reshape(n, 34), depth], dim=1)


def lift_left_right_eval(stacked, poses_2d: torch.Tensor, depth_offset: float = 10.0,
                         choice: str = "right", policy: Policy = F32) -> torch.Tensor:
    """Left/right lift of (N, 34) normalized 2D -> (N, 51); ``stacked`` is a
    ``StackedLifter``, ``choice`` the side that owns the shared joints."""
    n = poses_2d.shape[0]
    left_inp, right_inp = split_data_left_right(poses_2d)
    left_pred, right_pred, _, _ = stacked(left_inp, right_inp, policy)
    pred = combine_left_right_pred_1d(left_pred, right_pred, choice).reshape(n, 17)
    return depth_to_camera_3d(poses_2d, pred, depth_offset)


def lift_leg_torso_eval(legs, torso, poses_2d: torch.Tensor,
                        depth_offset: float = 10.0, policy: Policy = F32) -> torch.Tensor:
    """Leg/torso lift of (N, 34) normalized 2D -> (N, 51)."""
    inp_legs, inp_torso = split_data_legs_torso(poses_2d)
    legs_pred, _ = legs(inp_legs, policy)
    torso_pred, _ = torso(inp_torso, policy)
    pred = torch.cat([legs_pred, torso_pred], dim=1)
    return depth_to_camera_3d(poses_2d, pred, depth_offset)
