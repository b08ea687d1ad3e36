"""Batched pose metrics (counterpart of links_tpu/metrics: the subset the
stage-3a and 3b validations use). PA-MPJPE is the MATLAB-style similarity
Procrustes with reflection='best', one batched f32 SVD over all poses.
N-MPJPE, PCK and AUC root-center both poses and scale the prediction to the
reference's norm first."""

from __future__ import annotations

import torch

# spine, thorax, neck/nose, head: the torso chain above the pelvis
UPPER_BODY_JOINTS = (7, 8, 9, 10)


def _joint_errors(p_ref: torch.Tensor, p: torch.Tensor, use_scaling: bool,
                  root_joint: int, num_joints: int) -> torch.Tensor:
    """(B, J) distances between root-centered (B, 3J) poses, the prediction
    scaled to the reference's norm when ``use_scaling``."""
    p = p.reshape(-1, 3, num_joints)
    p_ref = p_ref.reshape(-1, 3, num_joints)
    p = p - p[:, :, root_joint:root_joint + 1]
    p_ref = p_ref - p_ref[:, :, root_joint:root_joint + 1]
    if use_scaling:
        flat, flat_ref = p.reshape(p.shape[0], -1), p_ref.reshape(p.shape[0], -1)
        scale = (torch.linalg.vector_norm(flat_ref, dim=1, keepdim=True)
                 / torch.linalg.vector_norm(flat, dim=1, keepdim=True))
        p = (flat * scale).reshape(-1, 3, num_joints)
    return torch.linalg.vector_norm(p - p_ref, dim=1)


def n_mpjpe(p_ref: torch.Tensor, p: torch.Tensor, use_scaling: bool = True,
            root_joint: int = 0, num_joints: int = 17) -> torch.Tensor:
    """Norm-scaled MPJPE of (B, 3J) poses. Returns (B,)."""
    return _joint_errors(p_ref, p, use_scaling, root_joint, num_joints).mean(dim=1)


def pck(p_ref: torch.Tensor, p: torch.Tensor, use_scaling: bool = True, root_joint: int = 0,
        num_joints: int = 17, thresh: float = 150.0) -> torch.Tensor:
    """Percentage of joints within ``thresh`` mm. Returns a scalar."""
    dist = _joint_errors(p_ref, p, use_scaling, root_joint, num_joints)
    return (dist < thresh).sum() / dist.numel() * 100.0


def auc(p_ref: torch.Tensor, p: torch.Tensor, use_scaling: bool = True, root_joint: int = 0,
        num_joints: int = 17) -> torch.Tensor:
    """Area under the PCK curve over the thresholds linspace(0, 150, 150).
    Returns a scalar in [0, 1]."""
    dist = _joint_errors(p_ref, p, use_scaling, root_joint, num_joints)
    ts = torch.linspace(0.0, 150.0, 150, device=dist.device)
    return (dist[None] < ts[:, None, None]).sum() / (dist.numel() * 150)


def procrustes_align(p_ref: torch.Tensor, p: torch.Tensor, num_joints: int = 17) -> torch.Tensor:
    """Similarity-align predictions to references (reflection='best').
    Inputs (B, 3J) flat or (B, 3, J); returns the aligned predictions
    (B, 3, J)."""
    X = p_ref.reshape(-1, 3, num_joints).transpose(1, 2)  # (B, J, 3)
    Y = p.reshape(-1, 3, num_joints).transpose(1, 2)
    muX, muY = X.mean(1, keepdim=True), Y.mean(1, keepdim=True)
    X0, Y0 = X - muX, Y - muY
    normX = torch.sqrt((X0 ** 2).sum(dim=(1, 2), keepdim=True))
    normY = torch.sqrt((Y0 ** 2).sum(dim=(1, 2), keepdim=True))
    X0, Y0 = X0 / normX, Y0 / normY
    U, s, Vt = torch.linalg.svd(X0.transpose(1, 2) @ Y0)
    T = Vt.transpose(1, 2) @ U.transpose(1, 2)
    trace_ta = s.sum(-1)[:, None, None]
    return (normX * trace_ta * (Y0 @ T) + muX).transpose(1, 2)


def pa_mpjpe(p_ref: torch.Tensor, p: torch.Tensor, num_joints: int = 17) -> torch.Tensor:
    """PA-MPJPE of (B, 3J) poses in the (3, J) flat layout. Returns (B,)."""
    Z = procrustes_align(p_ref, p, num_joints)
    X = p_ref.reshape(-1, 3, num_joints)
    return torch.linalg.vector_norm(Z - X, dim=1).mean(dim=1)


def depth_tilt_score(pred_3d: torch.Tensor, num_joints: int = 17) -> torch.Tensor:
    """Mean camera-frame depth of the upper-body chain relative to the root:
    negative for lifts in the un-flipped mode under downward-looking
    cameras, positive for depth-flipped ones (an unsupervised flip alarm)."""
    z = pred_3d.reshape(-1, 3, num_joints)[:, 2]
    upper = torch.as_tensor(UPPER_BODY_JOINTS, device=z.device)
    return (z[:, upper].mean(dim=1) - z[:, 0]).mean()
