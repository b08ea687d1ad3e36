"""Synthetic H36M-shaped 17-joint poses made on the device from a seed.

A torch rewrite of ``links_tpu_torch/data/synthetic.py:generate_poses`` (the
bone-preserving forward kinematics of a rest skeleton, a random azimuth, a
downward camera tilt of about 11 degrees, a camera 5.2 m away and a
perspective projection), drawn with one ``torch.Generator`` on the device
in a few large calls, so that set-up makes no data on the host. The same
seed on the same device gives the same poses.

2D poses are flattened ``(N, 34)`` in the ``(2, 17)`` layout (all x, then
all y), as the port's datasets hold them.
"""

from __future__ import annotations

import math

import torch

# Rest skeleton (mm, rooted at the pelvis), parents and per-joint articulation
# ranges (rad), as links_tpu_torch/data/synthetic.py has them.
REST = (
    (0, 0, 0), (-130, 0, 0), (-140, 450, 0), (-150, 900, 0), (130, 0, 0), (140, 450, 0),
    (150, 900, 0), (0, -230, 0), (0, -480, 0), (0, -590, 0), (0, -700, 0), (170, -450, 0),
    (420, -430, 0), (650, -420, 0), (-170, -450, 0), (-420, -430, 0), (-650, -420, 0))
PARENT = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15)
JOINT_SCALE = (0.0, 0.25, 0.45, 0.45, 0.25, 0.45, 0.45, 0.10, 0.10, 0.12, 0.12, 0.30, 0.50,
               0.50, 0.30, 0.50, 0.50)
FOCAL = 1150.0
CAMERA_DEPTH = 5200.0
# links_tpu_torch/core/geometry.py:H36M_TEST_SCALE_INTERESTING, the serving
# path's fixed test normalization
TEST_SCALE = 145.40964


def _rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(n, 3) unit axes and (n,) angles -> (n, 3, 3) rotations."""
    n = axis.shape[0]
    k = torch.zeros(n, 3, 3, device=axis.device)
    k[:, 0, 1], k[:, 0, 2] = -axis[:, 2], axis[:, 1]
    k[:, 1, 0], k[:, 1, 2] = axis[:, 2], -axis[:, 0]
    k[:, 2, 0], k[:, 2, 1] = -axis[:, 1], axis[:, 0]
    s, c = torch.sin(angle)[:, None, None], torch.cos(angle)[:, None, None]
    return torch.eye(3, device=axis.device) + s * k + (1 - c) * (k @ k)


def camera_poses(n: int, generator: torch.Generator) -> torch.Tensor:
    """(n, 3, 17) camera-frame 3D poses (mm) from ``generator``, on its device."""
    dev = generator.device
    z = torch.randn(17, n, 4, generator=generator, device=dev)  # axis (3) and angle per joint
    extra = torch.randn(n, 4, generator=generator, device=dev)  # tilt, depth, x, y
    azim = (torch.rand(n, generator=generator, device=dev) * 2 - 1) * math.pi
    rest = torch.tensor(REST, dtype=torch.float32, device=dev)
    pos = [torch.zeros(n, 3, device=dev)]
    rot = [torch.eye(3, device=dev).expand(n, 3, 3)]
    for j in range(1, 17):
        p = PARENT[j]
        axis = z[j, :, :3] / torch.linalg.vector_norm(z[j, :, :3], dim=1, keepdim=True)
        rot.append(rot[p] @ _rodrigues(axis, z[j, :, 3] * JOINT_SCALE[j]))
        pos.append(pos[p] + rot[j] @ (rest[j] - rest[p]))
    pose = torch.stack(pos, dim=2)  # (n, 3, 17)
    c, s = torch.cos(azim), torch.sin(azim)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    ry = torch.stack([c, zero, s, zero, one, zero, -s, zero, c], 1).reshape(n, 3, 3)
    phi = 0.2 + 0.08 * extra[:, 0]
    cp, sp = torch.cos(phi), torch.sin(phi)
    rx = torch.stack([one, zero, zero, zero, cp, -sp, zero, sp, cp], 1).reshape(n, 3, 3)
    cam = rx @ (ry @ pose)
    offset = torch.stack([200.0 * extra[:, 2], 150.0 * extra[:, 3],
                          CAMERA_DEPTH + 300.0 * extra[:, 1]], dim=1)
    return cam + offset[:, :, None]


def pixel_poses(n: int, generator: torch.Generator) -> torch.Tensor:
    """(n, 2, 17) pixel 2D poses: the perspective projection of ``camera_poses``."""
    cam = camera_poses(n, generator)
    return FOCAL * cam[:, :2] / cam[:, 2:3]


def train_poses(n: int, generator: torch.Generator) -> torch.Tensor:
    """(n, 34) 2D poses normalized as the trainers' train split is
    (``geometry.normalize_head``): root-centred, divided by the mean
    root-to-head distance, times 0.1."""
    p2d = pixel_poses(n, generator)
    p2d = p2d - p2d[:, :, :1]
    scale = torch.linalg.vector_norm(p2d[:, :, 0] - p2d[:, :, 10], dim=1).mean()
    return (p2d / scale * 0.1).reshape(n, 34)


def test_poses(n: int, generator: torch.Generator) -> torch.Tensor:
    """(n, 34) 2D poses normalized as ``lift`` and ``serve`` take them
    (``geometry.normalize_head_test``): root-centred, divided by the fixed
    test scale, times 0.1."""
    p2d = pixel_poses(n, generator)
    p2d = p2d - p2d[:, :, :1]
    return (p2d / TEST_SCALE * 0.1).reshape(n, 34)
