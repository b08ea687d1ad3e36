"""Geometry primitives (counterpart of links_tpu/core/geometry.py): axis
rotations, perspective projection, the train and test 2D normalizers and
the latent perturbation of generative sampling."""

from __future__ import annotations

import math

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
    else:  # "Y"
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def rotation_about_x(angle: torch.Tensor) -> torch.Tensor:
    """(B, 1) elevation angles -> (B, 3, 3)."""
    return _axis_rotation("X", angle[..., 0])


def rotation_about_y(angle: torch.Tensor) -> torch.Tensor:
    """(B, 1) azimuth angles -> (B, 3, 3)."""
    return _axis_rotation("Y", angle[..., 0])


def perspective_projection(pose_3d: torch.Tensor) -> torch.Tensor:
    """(B, 51) camera-frame 3D -> (B, 34) 2D by x/z, y/z."""
    p = pose_3d.reshape(-1, 51)
    xy = p[:, :34].reshape(-1, 2, 17)
    z = p[:, 34:].reshape(-1, 1, 17)
    return (xy / z).reshape(-1, 34)


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
