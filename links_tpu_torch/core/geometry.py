"""Geometry primitives (counterpart of links_tpu/core/geometry.py): axis
and Euler rotations, perspective projection, the train and test 2D
normalizers, the latent perturbation and interpolation of generative
sampling, and simulated 2D keypoint occlusion."""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi

# Hard-coded test-time normalization scales (reference utils/helpers.py:222-259).
H36M_TEST_SCALE_INTERESTING = 145.40964
H36M_TEST_SCALE_ALL = 142.34154
H36M_TRAIN_GT_SCALE = 145.5329587164913
MPI_TEST_SCALE_CHEST = 318.79249520730474
MPI_TEST_SCALE_VNECT = 302.8530630720979
H36M_TEST_SCALE_TEMPORAL = 145.40419


def normalize_head_test(poses_2d: torch.Tensor,
                        scale: float = H36M_TEST_SCALE_INTERESTING) -> torch.Tensor:
    """Root-center (B, 34) poses and divide by a fixed scale, times 0.1."""
    p2d = poses_2d.reshape(-1, 2, 17)
    p2d = p2d - p2d[:, :, 0:1]
    return p2d.reshape(-1, 34) / scale * 0.1


def normalize_head_test_mpi_chest(poses_2d, scale: float = MPI_TEST_SCALE_CHEST):
    """MPI-INF-3DHP chest-camera variant."""
    return normalize_head_test(poses_2d, scale)


def normalize_head_test_mpi_vnect(poses_2d, scale: float = MPI_TEST_SCALE_VNECT):
    """MPI-INF-3DHP vnect-camera variant."""
    return normalize_head_test(poses_2d, scale)


def normalize_head_test_temporal(poses_2d, scale: float = H36M_TEST_SCALE_TEMPORAL):
    """Temporal variant."""
    return normalize_head_test(poses_2d, scale)


def normalize_maxabs(poses_2d: torch.Tensor) -> torch.Tensor:
    """Per-pose max-abs normalization, used when a loader gets no
    normalize_func: (B, 17, 2) raw keypoints -> (B, 34) in the (2, 17) layout."""
    kp = poses_2d - poses_2d[:, 0:1, :]
    pose_max = kp.abs().amax(dim=(1, 2), keepdim=True)
    return (kp / pose_max).transpose(1, 2).reshape(-1, 34)


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about one axis, (...,) -> (..., 3, 3) (PyTorch3D
    convention, as the reference's utils/rotation_conversions.py)."""
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis!r}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrices (..., 3, 3),
    R = R_c0 R_c1 R_c2 for the axes of ``convention``."""
    if euler_angles.shape[-1] != 3:
        raise ValueError("Invalid input euler angles.")
    if len(convention) != 3 or convention[1] in (convention[0], convention[2]):
        raise ValueError(f"Invalid convention {convention}.")
    mats = [_axis_rotation(axis, euler_angles[..., i]) for i, axis in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def rotation_about_x(angle: torch.Tensor) -> torch.Tensor:
    """(B, 1) elevation angles -> (B, 3, 3)."""
    return _axis_rotation("X", angle[..., 0])


def rotation_about_y(angle: torch.Tensor) -> torch.Tensor:
    """(B, 1) azimuth angles -> (B, 3, 3)."""
    return _axis_rotation("Y", angle[..., 0])


def _perspective(pose_3d: torch.Tensor, njoints: int) -> torch.Tensor:
    p = pose_3d.reshape(-1, 3 * njoints)
    xy = p[:, :2 * njoints].reshape(-1, 2, njoints)
    z = p[:, 2 * njoints:].reshape(-1, 1, njoints)
    return (xy / z).reshape(-1, 2 * njoints)


def perspective_projection(pose_3d: torch.Tensor) -> torch.Tensor:
    """(B, 51) camera-frame 3D -> (B, 34) 2D by x/z, y/z."""
    return _perspective(pose_3d, 17)


def perspective_projection_legs(pose_3d: torch.Tensor) -> torch.Tensor:
    """(B, 21) -> (B, 14)."""
    return _perspective(pose_3d, 7)


def perspective_projection_torso(pose_3d: torch.Tensor) -> torch.Tensor:
    """(B, 30) -> (B, 20)."""
    return _perspective(pose_3d, 10)


def perspective_projection_left_right(pose_3d: torch.Tensor) -> torch.Tensor:
    """(B, 33) -> (B, 22)."""
    return _perspective(pose_3d, 11)


def normalize_head(poses_2d: torch.Tensor, root_joint: int = 0) -> torch.Tensor:
    """Training 2D normalization: root-center (B, 34) poses, divide by the
    dataset-mean root-to-head distance, times 0.1."""
    p2d = poses_2d.reshape(-1, 2, 17)
    p2d = p2d - p2d[:, :, root_joint:root_joint + 1]
    scale = torch.linalg.vector_norm(p2d[:, :, 0] - p2d[:, :, 10], dim=1)
    return p2d.reshape(-1, 34) / scale.mean() * 0.1


def add_noise(latent: torch.Tensor, noise_factor: float, eps: torch.Tensor) -> torch.Tensor:
    """Latent perturbation of generative sampling, z + f (eps * z), with the
    standard-normal draw ``eps`` (latent's shape) given by the caller."""
    return latent + noise_factor * eps * latent


def interpolate_gaussian_batch(latent: torch.Tensor, t: float) -> torch.Tensor:
    """Pairwise linear interpolation of 34-d latents: rows 2i and 2i + 1 ->
    (1 - t) z_2i + t z_2i+1. The batch must be even."""
    if latent.shape[0] % 2 != 0:
        raise ValueError("Batch size must be even for interpolation.")
    pairs = latent.reshape(-1, 2, 34)
    return (1 - t) * pairs[:, 0] + t * pairs[:, 1]


# occlusion_create's keep-masks: for limb l and count c + 1 of its joints
# zeroed, _OCC_MASKS[l, c, j] is 0 where joint j is dropped
_LIMBS = ("left_leg", "right_leg", "left_arm", "right_arm")
_OCC_SETS = {
    "left_leg": ([6], [5, 6], [4, 5, 6]),
    "right_leg": ([3], [2, 3], [1, 2, 3]),
    "left_arm": ([11], [11, 12], [11, 12, 13]),
    "right_arm": ([14], [14, 15], [14, 15, 16]),
}
_OCC_MASKS = np.ones((4, 3, 17), dtype=np.float32)
for _l, _name in enumerate(_LIMBS):
    for _c, _joints in enumerate(_OCC_SETS[_name]):
        _OCC_MASKS[_l, _c, _joints] = 0.0


def occlusion_create(poses_2d: torch.Tensor, limbs=("left_leg",), limb: torch.Tensor | None = None,
                     count: torch.Tensor | None = None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Simulated 2D keypoint dropout of (B, 34) poses: each pose loses the
    last ``count + 1`` joints of one limb of ``limbs`` (any of 'left_leg',
    'right_leg', 'left_arm', 'right_arm'; the reference occludes only the
    left leg). ``limb`` (B,) indexes ``limbs`` and ``count`` (B,) lies in
    {0, 1, 2}; each that is None is drawn uniformly from ``generator``."""
    b = poses_2d.shape[0]
    if limb is None:
        limb = torch.randint(0, len(limbs), (b,), generator=generator)
    if count is None:
        count = torch.randint(0, 3, (b,), generator=generator)
    ids = torch.as_tensor([_LIMBS.index(name) for name in limbs])
    mask = torch.from_numpy(_OCC_MASKS)[ids[limb.cpu()], count.cpu()].to(poses_2d)  # (B, 17)
    return (poses_2d.reshape(-1, 2, 17) * mask[:, None, :]).reshape(-1, 34)
