"""Skeleton index maps and part split/combine operations
(counterpart of links_tpu/core/skeleton.py).

The 17-joint H36M subset:

    0  pelvis/root        7  spine
    1  right hip          8  thorax
    2  right knee         9  neck/nose
    3  right ankle       10  head
    4  left hip          11  left shoulder
    5  left knee         12  left elbow
    6  left ankle        13  left wrist
                         14  right shoulder
                         15  right elbow
                         16  right wrist

2D poses are flattened ``(B, 34)`` laid out ``(2, 17)`` (all x, then all y);
3D poses ``(B, 51)`` laid out ``(3, 17)``. Each split/combine is one
constant-index gather on the trailing joint axis.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_JOINTS = 17

# Part index sets. The left/right splits share the root (0) and the torso
# column (7, 8, 9, 10).
RIGHT_IDX = np.array([0, 1, 2, 3, 7, 8, 9, 10, 14, 15, 16])
LEFT_IDX = np.array([0, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13])
# v2 swaps which side owns the arms.
RIGHT_IDX_V2 = np.array([0, 1, 2, 3, 7, 8, 9, 10, 11, 12, 13])
LEFT_IDX_V2 = np.array([0, 4, 5, 6, 7, 8, 9, 10, 14, 15, 16])
# Legs = joints [0, 7); torso = joints [7, 17).
LEG_IDX = np.arange(0, 7)
TORSO_IDX = np.arange(7, 17)

# Inverse gather for combine_left_right_pred_*: full joint j is drawn from
# column _COMBINE_LR_COL[j] of the left or the right 11-joint split; the mask
# says which side (shared root/torso columns come from the chosen side).
_COMBINE_LR_COL = np.array([0, 1, 2, 3, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 8, 9, 10])
_COMBINE_FROM_RIGHT_LEFT = np.array(
    [0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1], dtype=bool
)  # choice='left'
_COMBINE_FROM_RIGHT_RIGHT = np.array(
    [1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1], dtype=bool
)  # choice='right'

# combine_left_right_occluded_3d: permutation over
# concat([visible(11), occluded(6)]) on the joint axis.
_OCCLUDED_COMBINE_RIGHT = np.array(
    [0, 11, 12, 13, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 14, 15, 16]
)
_OCCLUDED_COMBINE_LEFT = np.array(
    [0, 1, 2, 3, 11, 12, 13, 4, 5, 6, 7, 14, 15, 16, 8, 9, 10]
)

# Bone edge maps.
BONE_MAP_ALL = np.array(
    [[0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6], [0, 7], [7, 8], [8, 9],
     [9, 10], [8, 11], [11, 12], [12, 13], [8, 14], [14, 15], [15, 16]]
)
BONE_MAP_LEGS = np.array([[0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6]])
# Torso bones computed after prepending a zero root column.
BONE_MAP_TORSO = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 4], [2, 5], [5, 6], [6, 7], [2, 8], [8, 9], [9, 10]]
)
BONE_MAP_LEFT_RIGHT = np.array(
    [[0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6], [6, 7], [5, 8], [8, 9], [9, 10]]
)

# H36M mean relative bone lengths.
BONE_RELATIONS_MEAN_H36M = np.array(
    [0.5180581, 1.73711136, 1.72285805, 0.5180552, 1.73710543,
     1.72285651, 0.92087518, 0.98792375, 0.44812302, 0.44502545,
     0.57462, 1.08121276, 0.9651687, 0.57461556, 1.08122523, 0.9651657]
)
# MPI-INF-3DHP "vnect cameras interesting" mean.
BONE_RELATIONS_MEAN_MPI_VNECT_INTERESTING = np.array(
    [0.48069107, 1.84637771, 1.49564841, 0.48069107, 1.84301997,
     1.4956484, 0.90757932, 0.99706493, 0.34679742, 0.69380255,
     0.57843534, 1.20698327, 0.92306225, 0.5741528, 1.20698326, 0.92306223]
)


def _on(idx: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(idx, device=like.device)


def _split(data, ncoords, idx_a, idx_b):
    x = data.reshape(-1, ncoords, NUM_JOINTS)
    a = x[:, :, _on(idx_a, x)].reshape(-1, ncoords * len(idx_a))
    b = x[:, :, _on(idx_b, x)].reshape(-1, ncoords * len(idx_b))
    return a, b


def split_data_left_right(data):
    """(B, 34) -> (left (B, 22), right (B, 22))."""
    return _split(data, 2, LEFT_IDX, RIGHT_IDX)


def split_data_legs_torso(data):
    """(B, 34) -> (legs (B, 14), torso (B, 20))."""
    return _split(data, 2, LEG_IDX, TORSO_IDX)


def _combine_lr(left_split, right_split, choice, ncoords):
    col = _on(_COMBINE_LR_COL, left_split)
    l = left_split.reshape(-1, ncoords, 11)[:, :, col]
    r = right_split.reshape(-1, ncoords, 11)[:, :, col]
    mask = _COMBINE_FROM_RIGHT_RIGHT if choice == "right" else _COMBINE_FROM_RIGHT_LEFT
    return torch.where(_on(mask, l), r, l)


def combine_left_right_pred_1d(left_split, right_split, choice):
    """Merge (B, 11) + (B, 11) per-joint depths -> (B, 1, 17)."""
    return _combine_lr(left_split, right_split, choice, 1)
