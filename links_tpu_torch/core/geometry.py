"""Test-time 2D pose normalizers (counterpart of the normalizers in
links_tpu/core/geometry.py). Rotations and projections arrive with the
training slice."""

from __future__ import annotations

import torch

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
