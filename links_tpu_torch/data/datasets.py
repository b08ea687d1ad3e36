"""Keypoint datasets from reference-schema pickles (counterpart of
links_tpu/data/datasets.py).

Pickle schema: ``{subject: {'poses_3d': (N, 17, 3), 'poses_2d': (N, 17, 2),
'poses_3d_univ': (N, 17, 3)[, 'poses_2d_pred': (N, 17, 2)]}}``. A dataset is a
pair of CPU tensors, normalized once at load time:

    poses_2d: (N, 34)  normalized, (2, 17) flat layout
    poses_3d: (N, 51)  mm, (3, 17) flat layout
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from links_tpu_torch.core.geometry import normalize_maxabs
from links_tpu_torch.core.skeleton import split_data_left_right

TRAIN_SUBJECTS = ("S1", "S5", "S6", "S7", "S8")
TEST_SUBJECTS = ("S9", "S11")
MPI_SUBJECTS = ("S1", "S2", "S3", "S4", "S5", "S6", "S7", "S8")


@dataclass
class PoseDataset:
    """poses_2d (N, 34) normalized + poses_3d (N, 51). ``use_gt`` False means
    the 2D keypoints are detector predictions."""

    poses_2d: torch.Tensor
    poses_3d: torch.Tensor
    use_gt: bool = True

    def __len__(self) -> int:
        return int(self.poses_3d.shape[0])


def read_pickle(file_name) -> dict:
    """The whole reference-schema pickle, ``{subject: {key: array}}``."""
    with open(file_name, "rb") as f:
        return pickle.load(f)


def _load_pickle_subjects(file_name, subjects: Sequence[str], pose_3d_key: str,
                          use_gt: bool = True, complete_only: bool = False):
    data = read_pickle(file_name)
    # detector keypoints: a 'poses_2d_pred' array when every subject has one,
    # else plain 'poses_2d'
    key_2d = "poses_2d"
    if not use_gt and all("poses_2d_pred" in data[s] for s in subjects):
        key_2d = "poses_2d_pred"
    two_d = np.concatenate([np.asarray(data[s][key_2d]) for s in subjects])
    three_d = np.concatenate([np.asarray(data[s][pose_3d_key]) for s in subjects])
    if complete_only and not use_gt:
        # drop frames with an undetected (zeroed) keypoint
        keep = ~np.all(two_d == 0.0, axis=2).any(axis=1)
        two_d, three_d = two_d[keep], three_d[keep]
    return two_d, three_d


def _build(two_d, three_d, joints: int, normalize_func: Callable | None,
           use_gt: bool = True) -> PoseDataset:
    poses_3d = three_d.transpose(0, 2, 1).reshape(-1, 3 * joints)
    if normalize_func is not None:
        flat2d = two_d.transpose(0, 2, 1).reshape(-1, 2 * joints)
        poses_2d = normalize_func(torch.as_tensor(flat2d, dtype=torch.float32))
    else:
        poses_2d = normalize_maxabs(torch.as_tensor(two_d, dtype=torch.float32))
    return PoseDataset(poses_2d=poses_2d.float(),
                       poses_3d=torch.as_tensor(poses_3d, dtype=torch.float32),
                       use_gt=use_gt)


def load_h36m(file_name, subjects: Sequence[str] = TRAIN_SUBJECTS, joints: int = 17,
              normalize_func: Callable | None = None,
              use_gt: bool = True, complete_only: bool = False) -> PoseDataset:
    """H36M loader; 3D ground truth from ``poses_3d``."""
    two_d, three_d = _load_pickle_subjects(file_name, subjects, "poses_3d",
                                           use_gt, complete_only)
    return _build(two_d, three_d, joints, normalize_func, use_gt)


def load_mpi_inf_3dhp(file_name, subjects: Sequence[str] = MPI_SUBJECTS,
                      joints: int = 17, normalize_func: Callable | None = None,
                      use_gt: bool = True, complete_only: bool = False) -> PoseDataset:
    """MPI-INF-3DHP loader; 3D ground truth from ``poses_3d_univ``."""
    two_d, three_d = _load_pickle_subjects(file_name, subjects, "poses_3d_univ",
                                           use_gt, complete_only)
    return _build(two_d, three_d, joints, normalize_func, use_gt)


def _numpy(poses) -> np.ndarray:
    return poses.detach().cpu().numpy() if isinstance(poses, torch.Tensor) else np.asarray(poses)


def fit_part_pca(poses_2d):
    """The reference dataset's left/right PCA fit (no loss reads it): (N, 34)
    2D poses -> (left PCA, right PCA) fitted sklearn objects, or None
    without sklearn."""
    try:
        from sklearn.decomposition import PCA
    except ImportError:
        return None
    left, right = split_data_left_right(torch.as_tensor(_numpy(poses_2d)))
    lp, rp = PCA(), PCA()
    lp.fit(left.numpy())
    rp.fit(right.numpy())
    return lp, rp


def fit_full_pose_pca(poses_2d):
    """The reference's full-pose PCA fit (no entry point reads it): (N, 34)
    2D poses -> a fitted sklearn PCA, or None without sklearn."""
    try:
        from sklearn.decomposition import PCA
    except ImportError:
        return None
    pca = PCA()
    pca.fit(_numpy(poses_2d))
    return pca


def save_pickle(path, processed: dict):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(processed, f)
