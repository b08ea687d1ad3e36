"""Batched pose metrics (counterpart of links_tpu/metrics). PA-MPJPE is the
MATLAB-style similarity Procrustes with reflection='best', one batched f32
SVD over all poses. N-MPJPE, PCK and AUC root-center both poses and scale
the prediction to the reference's norm first. ``get_all`` is the
reference's MPJPE/PCK/AUC/CPS bundle, with its bug-compatible CPS (an
unaligned sweep) and the corrected, Procrustes-aligned ``CPS_correct``;
``procrustes_batch``/``pmpjpe_batch`` are the reference's torch variant of
Procrustes, reflection disallowed by the det-sign trick.

The thresholded metrics count exactly (integer counts, then one f32
division), so they match the JAX package's wherever its f32 sums of 0/1
terms are exact (below 2**24 terms).

Each batched 3x3 SVD is one call over all rows. The JAX package runs it in
chunks of 8192 only to bound a TPU's on-chip memory; on the card one call
over 500,000 poses is sound and no slower than chunks (chip_smoke.py's
metrics phase times both)."""

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


def procrustes_batch(poses_inp: torch.Tensor, template_poses: torch.Tensor,
                     use_reflection: bool = False, use_scaling: bool = True) -> torch.Tensor:
    """The reference's batched torch Procrustes: align ``poses_inp`` (B, 3, J)
    to ``template_poses`` (B, 3, J); reflection disallowed (det-sign trick)
    unless ``use_reflection``. -> (B, 3, J)."""
    n = 3 * poses_inp.shape[-1]
    t_mu = template_poses.mean(dim=2, keepdim=True)
    t0 = template_poses - t_mu
    scale_t = torch.sqrt((t0 ** 2).sum(dim=(1, 2), keepdim=True) / n)
    t0 = t0 / scale_t
    p_mu = poses_inp.mean(dim=2, keepdim=True)
    p0 = poses_inp - p_mu
    scale_p = torch.sqrt((p0 ** 2).sum(dim=(1, 2), keepdim=True) / n)
    p0 = p0 / scale_p
    U, _, Vt = torch.linalg.svd(t0 @ p0.transpose(1, 2))
    R = U @ Vt
    if not use_reflection:
        Z = torch.eye(3, dtype=R.dtype, device=R.device).repeat(R.shape[0], 1, 1)
        Z[:, -1, -1] = Z[:, -1, -1] * torch.linalg.det(R)
        R = Z @ R
    pa = R @ p0
    if use_scaling:
        pa = pa * scale_t
    return pa + t_mu


def pmpjpe_batch(p_ref: torch.Tensor, p: torch.Tensor, use_reflection: bool = False,
                 num_joints: int = 17) -> torch.Tensor:
    """PMPJPE through ``procrustes_batch`` (the JAX package forwards
    ``use_reflection``, which the reference drops). Returns (B,)."""
    p = p.reshape(-1, 3, num_joints)
    p_ref = p_ref.reshape(-1, 3, num_joints)
    aligned = procrustes_batch(p, p_ref, use_reflection=use_reflection)
    return torch.linalg.vector_norm(p_ref - aligned, dim=1).mean(dim=1)


def mpjpe_single(p_ref: torch.Tensor, p: torch.Tensor, scale: bool = False,
                 mean_align: bool = False) -> torch.Tensor:
    """MPJPE of one (3, J) pose pair."""
    if mean_align:
        p = p - p.mean(dim=1, keepdim=True)
        p_ref = p_ref - p_ref.mean(dim=1, keepdim=True)
    if scale:
        p = p * (torch.linalg.vector_norm(p_ref.reshape(-1))
                 / torch.linalg.vector_norm(p.reshape(-1)))
    return torch.linalg.vector_norm(p - p_ref, dim=0).mean()


def _cps(dist: torch.Tensor) -> torch.Tensor:
    """The reference's CPS sweep of (B, J) joint errors: over the thresholds
    0..300 mm, the count of poses with no joint error above the threshold,
    summed and divided by B. A pose passes exactly the thresholds at or above
    its largest error (a NaN error exceeds none, as in the reference)."""
    ds = torch.linspace(0.0, 300.0, 301, device=dist.device)
    worst = dist.nan_to_num(nan=float("-inf")).amax(dim=1)
    return (worst[None] <= ds[:, None]).sum() / dist.shape[0]


def get_all(p_ref: torch.Tensor, p: torch.Tensor, use_scaling: bool = True, root_joint: int = 0,
            num_joints: int = 17) -> dict[str, torch.Tensor]:
    """The reference's MPJPE / PCK / AUC / CPS bundle of (B, 3J) poses: the
    errors root-centered and norm-scaled; AUC over linspace(0, 150, 31), in
    percent. ``CPS`` reproduces the reference's sweep over those unaligned
    errors (its own TODO says it should be Procrustes aligned);
    ``CPS_correct`` sweeps the errors after ``procrustes_batch``. Scalars."""
    dist = _joint_errors(p_ref, p, use_scaling, root_joint, num_joints)
    n = dist.numel()
    ts = torch.linspace(0.0, 150.0, 31, device=dist.device)
    out = {"MPJPE": dist.mean(),
           "PCK": (dist < 150.0).sum() / n * 100.0,
           "AUC": (dist[None] < ts[:, None, None]).sum().float() / (n * 31) * 100.0,
           "CPS": _cps(dist)}
    pr = p_ref.reshape(-1, 3, num_joints)
    aligned = procrustes_batch(p.reshape(-1, 3, num_joints), pr)
    out["CPS_correct"] = _cps(torch.linalg.vector_norm(aligned - pr, dim=1))
    return out


def depth_tilt_score(pred_3d: torch.Tensor, num_joints: int = 17) -> torch.Tensor:
    """Mean camera-frame depth of the upper-body chain relative to the root:
    negative for lifts in the un-flipped mode under downward-looking
    cameras, positive for depth-flipped ones (an unsupervised flip alarm)."""
    z = pred_3d.reshape(-1, 3, num_joints)[:, 2]
    upper = torch.as_tensor(UPPER_BODY_JOINTS, device=z.device)
    return (z[:, upper].mean(dim=1) - z[:, 0]).mean()
