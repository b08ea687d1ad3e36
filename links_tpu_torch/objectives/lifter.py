"""Lifter objectives (counterpart of links_tpu/objectives/lifter.py).

Eval forwards: lift, pin the root's depth offset to 0, add the depth offset
(no clamp at eval) and reconstruct camera-frame 3D.

Stage-3 training losses (the reference's train_left_right_lifter.py:121-423
for 3a's left/right pair, train_leg_torso_lifter.py:123-272 for 3b's
legs/torso pair):
  1. the lifters emit per-joint depth offsets and an elevation angle;
  2. depth z = offset + cfg.depth (root offset pinned to 0), clamped >= 1;
  3. 3D reconstruction X = x z, Y = y z, Z = z, root-centered;
  4. a random camera: elevation compensation from the predicted angles,
     elevation ~ N(-mean(props), std(props)) (ddof=1), azimuth
     (u - 0.5) 1.99 pi; R = Rx (Ry Rcomp);
  5. rotate, translate by cfg.depth, project; the rotated views feed five
     losses: part-flow NLL, 3D consistency, 2D reprojection, pairwise
     deformation and the bone-length prior.
The random draws are tensors the caller gives: torch cannot reproduce
jax.random, and the tests hand both packages the same numbers. Under data
parallelism (a ``group``, train/parallel.py) the elevation's mean and std
are those of the global batch, as the JAX package's ``_batch_stats`` with an
axis name computes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from links_tpu_torch import flows
from links_tpu_torch.config import LifterTrainConfig
from links_tpu_torch.core.geometry import (
    PI,
    perspective_projection,
    rotation_about_x,
    rotation_about_y,
)
from links_tpu_torch.core.nn import F32, Policy
from links_tpu_torch.core.skeleton import (
    BONE_RELATIONS_MEAN_H36M,
    BONE_RELATIONS_MEAN_MPI_VNECT_INTERESTING,
    combine_left_right_pred_1d,
    get_bone_lengths_all,
    split_data_left_right,
    split_data_legs_torso,
)
from links_tpu_torch.train.parallel import all_reduce_sum


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


class LifterFrozen(NamedTuple):
    """The frozen flows of a stage-3 loss: the 34-d full-pose flow and the
    two part flows, left and right (22-d each) in 3a, legs (14-d) and torso
    (20-d) in 3b."""

    full_flow: flows.Flow
    part_a: flows.Flow  # left / legs
    part_b: flows.Flow  # right / torso


def reconstruct_3d(poses_2d: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(B, 34) 2D + (B, 17) depth -> (B, 3, 17) root-centered camera-space 3D."""
    p2 = poses_2d.reshape(-1, 2, 17)
    xyz = torch.cat([p2 * depth[:, None, :], depth[:, None, :]], dim=1)
    return xyz - xyz[:, :, 0:1]


def globalize(pose_51: torch.Tensor, depth_offset: float) -> torch.Tensor:
    """Root-centered (B, 51) -> camera frame by translating z by depth_offset."""
    return torch.cat([pose_51[:, :34], pose_51[:, 34:] + depth_offset], dim=1)


def _global_stats(props: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and ddof=1 std of ``props`` over every rank's rows, from one
    differentiable all-reduce of the sums of x and x^2."""
    n = props.numel() * group.world
    s1, s2 = all_reduce_sum(torch.stack([props.sum(), (props ** 2).sum()]), group) / n
    var = (s2 - s1 ** 2) * (n / (n - 1))
    return s1, torch.sqrt(torch.clamp(var, min=0.0))


def sample_rotation(props: torch.Tensor, u_azim: torch.Tensor,
                    eps_elev: torch.Tensor, group=None) -> torch.Tensor:
    """The augmentation rotation for (B, 1) predicted elevation angles, from
    the draws ``u_azim`` (B, 1) uniform on [0, 1) and ``eps_elev`` (B, 1)
    standard normal: azimuth (u - 0.5) 1.99 pi, elevation drawn from the
    batch's mean and ddof=1 std of ``props`` (with a ``group`` of more
    than one rank, the global batch's; one rank's batch is the global
    batch), composed with the per-sample compensation Rcomp: R = Rx (Ry
    Rcomp)."""
    ry = rotation_about_y((u_azim - 0.5) * 1.99 * PI)
    r_comp = rotation_about_x(props)
    if group is None or group.world == 1:
        x_ang = -props.mean() + props.std() * eps_elev
    else:
        mean, std = _global_stats(props, group)
        x_ang = -mean + std * eps_elev
    return rotation_about_x(x_ang) @ (ry @ r_comp)


def _pairwise_deformation(pred_3d: torch.Tensor, re_rot_3d: torch.Tensor) -> torch.Tensor:
    """Consecutive-pair difference consistency (even batch)."""
    n = pred_3d.shape[0]
    a = pred_3d.reshape(-1, 51)[: n // 2 * 2].reshape(-1, 2, 51)
    b = re_rot_3d[: n // 2 * 2].reshape(-1, 2, 51)
    diff = (a[:, 0] - a[:, 1]) - (b[:, 0] - b[:, 1])
    return torch.linalg.vector_norm(diff, dim=1).mean()


def _bl_prior(pred_3d: torch.Tensor, bone_relations_mean) -> torch.Tensor:
    """Relative bone-length prior against the (16,) mean bone relations."""
    bl = get_bone_lengths_all(pred_3d.reshape(-1, 51))
    rel = bl / bl.mean(dim=1, keepdim=True)
    mean = torch.as_tensor(bone_relations_mean, dtype=torch.float32, device=pred_3d.device)
    return ((mean - rel) ** 2).sum(dim=1).mean()


def augment_with_samples(full_flow: flows.Flow, poses_2d: torch.Tensor, eps: torch.Tensor,
                         noise_factor: float = 0.2, policy: Policy = F32) -> torch.Tensor:
    """The batch followed by as many samples of the frozen full flow around
    it (``eps``: the (B, 34) standard-normal latent noise): doubles the batch."""
    samples = flows.draw_samples(full_flow, poses_2d, eps, noise_factor, policy=policy)
    return torch.cat([poses_2d, samples], dim=0)


def pin_root(pred: torch.Tensor) -> torch.Tensor:
    """(N, 17) depth offsets with the root's set to 0."""
    return torch.cat([torch.zeros_like(pred[:, :1]), pred[:, 1:]], dim=1)


def _root_pinned(left_pred, right_pred, choice: str, n: int) -> torch.Tensor:
    return pin_root(combine_left_right_pred_1d(left_pred, right_pred, choice).reshape(n, 17))


def left_right_loss(stacked, frozen: LifterFrozen, inp_poses: torch.Tensor,
                    u_azim: torch.Tensor, eps_elev: torch.Tensor, cfg: LifterTrainConfig,
                    policy: Policy = F32, bone_relations_mean=None, group=None):
    """Stage-3a loss of a ``StackedLifter`` on (N, 34) poses already
    augmented with flow samples; ``u_azim`` and ``eps_elev`` (N, 1) are the
    rotation's draws (``sample_rotation``, with ``group``: only the
    data-parallel step passes one); ``bone_relations_mean`` (16,) defaults
    to H36M's. -> (loss, aux) with the JAX package's aux keys."""
    if bone_relations_mean is None:
        bone_relations_mean = BONE_RELATIONS_MEAN_H36M
    n = inp_poses.shape[0]
    left_inp, right_inp = split_data_left_right(inp_poses)
    left_pred, right_pred, left_ang, right_ang = stacked(left_inp, right_inp, policy)
    props = (left_ang + right_ang) / 2.0
    pred_left = _root_pinned(left_pred, right_pred, "left", n)
    pred_right = _root_pinned(left_pred, right_pred, "right", n)

    R = sample_rotation(props, u_azim, eps_elev, group)
    pred_3d_left = reconstruct_3d(inp_poses, torch.clamp(pred_left + cfg.depth, min=1.0))
    pred_3d_right = reconstruct_3d(inp_poses, torch.clamp(pred_right + cfg.depth, min=1.0))
    rot_poses_left = (R @ pred_3d_left).reshape(n, 51)
    rot_poses_right = (R @ pred_3d_right).reshape(n, 51)
    rot_2d_left = perspective_projection(globalize(rot_poses_left, cfg.depth))
    rot_2d_right = perspective_projection(globalize(rot_poses_right, cfg.depth))

    # each side's flow sees its own rotated view
    norm_left_side, _ = split_data_left_right(rot_2d_left)
    _, norm_right_side = split_data_left_right(rot_2d_right)
    likeli_left = flows.nll_mean(*flows.forward(frozen.part_a, norm_left_side, policy),
                                 cfg.nll_cap)
    likeli_right = flows.nll_mean(*flows.forward(frozen.part_b, norm_right_side, policy),
                                  cfg.nll_cap)
    likeli = likeli_left + likeli_right

    # re-lift the rotated views; no loss reads their angles, so the angle
    # branch (3 residual blocks per side) runs for nothing here
    pred_rot_left, pred_rot_right, _, _ = stacked(norm_left_side, norm_right_side, policy)
    rot_depth_left = torch.clamp(_root_pinned(pred_rot_left, pred_rot_right, "left", n)
                                 + cfg.depth, min=1.0)
    rot_depth_right = torch.clamp(_root_pinned(pred_rot_left, pred_rot_right, "right", n)
                                  + cfg.depth, min=1.0)
    pred_3d_rot_left = reconstruct_3d(rot_2d_left, rot_depth_left)
    pred_3d_rot_right = reconstruct_3d(rot_2d_right, rot_depth_right)

    # 3D consistency
    L3d = torch.linalg.vector_norm(rot_poses_right - pred_3d_rot_right.reshape(n, 51),
                                   dim=1).mean()
    L3d = L3d + torch.linalg.vector_norm(rot_poses_left - pred_3d_rot_left.reshape(n, 51),
                                         dim=1).mean()

    # rotate back and reproject
    Rt = R.transpose(1, 2)
    re_rot_3d_left = (Rt @ pred_3d_rot_left).reshape(n, 51)
    re_rot_3d_right = (Rt @ pred_3d_rot_right).reshape(n, 51)
    re_rot_2d_left = perspective_projection(globalize(re_rot_3d_left, cfg.depth))
    re_rot_2d_right = perspective_projection(globalize(re_rot_3d_right, cfg.depth))
    rep_rot = torch.abs(re_rot_2d_left - inp_poses).sum(dim=1).mean()
    rep_rot = rep_rot + torch.abs(re_rot_2d_right - inp_poses).sum(dim=1).mean()

    re_rot_3d = _pairwise_deformation(pred_3d_left, re_rot_3d_left)
    re_rot_3d = re_rot_3d + _pairwise_deformation(pred_3d_right, re_rot_3d_right)

    bl_prior = (_bl_prior(pred_3d_left, bone_relations_mean)
                + _bl_prior(pred_3d_right, bone_relations_mean))

    loss = (cfg.weight_likeli * likeli + cfg.weight_2d * rep_rot + cfg.weight_3d * L3d
            + cfg.weight_velocity * re_rot_3d + cfg.weight_bl * bl_prior)
    aux = {"likeli": likeli, "likeli_left": likeli_left, "likeli_right": likeli_right,
           "L3d": L3d, "rep_rot": rep_rot, "re_rot_3d": re_rot_3d, "bl_prior": bl_prior,
           "loss": loss}
    return loss, aux


def leg_torso_loss(legs, torso, frozen: LifterFrozen, inp_poses: torch.Tensor,
                   u_azim: torch.Tensor, eps_elev: torch.Tensor, cfg: LifterTrainConfig,
                   policy: Policy = F32, bone_relations_mean=None, group=None):
    """Stage-3b loss of the legs (joints 0-6) and torso (7-16) ``Lifter``s
    on (N, 34) poses already augmented with flow samples: one combined depth
    vector, one rotation and reprojection, and the five losses of 3a, with
    the legs and torso flows (``frozen.part_a``, ``part_b``) as the
    likelihood. ``bone_relations_mean`` defaults to the MPI "vnect
    interesting" means, as the reference's file does; ``group`` as
    ``left_right_loss``. -> (loss, aux) with the JAX package's aux keys."""
    if bone_relations_mean is None:
        bone_relations_mean = BONE_RELATIONS_MEAN_MPI_VNECT_INTERESTING
    n = inp_poses.shape[0]
    inp_legs, inp_torso = split_data_legs_torso(inp_poses)
    legs_pred, legs_ang = legs(inp_legs, policy)
    torso_pred, torso_ang = torso(inp_torso, policy)
    props = (legs_ang + torso_ang) / 2.0
    pred = pin_root(torch.cat([legs_pred, torso_pred], dim=1))

    R = sample_rotation(props, u_azim, eps_elev, group)
    pred_3d = reconstruct_3d(inp_poses, torch.clamp(pred + cfg.depth, min=1.0))
    rot_poses = (R @ pred_3d).reshape(n, 51)
    rot_2d = perspective_projection(globalize(rot_poses, cfg.depth))

    leg_rot, torso_rot = split_data_legs_torso(rot_2d)
    leg_likeli = flows.nll_mean(*flows.forward(frozen.part_a, leg_rot, policy), cfg.nll_cap)
    torso_likeli = flows.nll_mean(*flows.forward(frozen.part_b, torso_rot, policy), cfg.nll_cap)
    likeli = leg_likeli + torso_likeli

    # re-lift the rotated view; as in 3a, no loss reads its angles
    legs_pred_rot, _ = legs(leg_rot, policy)
    torso_pred_rot, _ = torso(torso_rot, policy)
    pred_rot = pin_root(torch.cat([legs_pred_rot, torso_pred_rot], dim=1))
    pred_3d_rot = reconstruct_3d(rot_2d, torch.clamp(pred_rot + cfg.depth, min=1.0))

    L3d = torch.linalg.vector_norm(rot_poses - pred_3d_rot.reshape(n, 51), dim=1).mean()

    re_rot_3d_pose = (R.transpose(1, 2) @ pred_3d_rot).reshape(n, 51)
    re_rot_2d = perspective_projection(globalize(re_rot_3d_pose, cfg.depth))
    rep_rot = torch.abs(re_rot_2d - inp_poses).sum(dim=1).mean()

    re_rot_3d = _pairwise_deformation(pred_3d, re_rot_3d_pose)
    bl_prior = _bl_prior(pred_3d, bone_relations_mean)

    loss = (cfg.weight_likeli * likeli + cfg.weight_2d * rep_rot + cfg.weight_3d * L3d
            + cfg.weight_velocity * re_rot_3d + cfg.weight_bl * bl_prior)
    aux = {"likeli": likeli, "leg_likeli": leg_likeli, "torso_likeli": torso_likeli,
           "L3d": L3d, "rep_rot": rep_rot, "re_rot_3d": re_rot_3d, "bl_prior": bl_prior,
           "loss": loss}
    return loss, aux
