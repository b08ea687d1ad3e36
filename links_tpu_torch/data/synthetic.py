"""Synthetic H36M-like pose data for tests, smoke runs, and benchmarks.

Generates kinematically plausible 17-joint skeletons (H36M-ish bone
proportions), poses them with random joint jitter + global rotation, places
them in a camera at ~5m depth and perspective-projects to pixel-scale 2D.
The pickle writer emits the exact reference schema
(pre_process_h36m_fetch.py:32) so the full pipeline can be smoke-tested
end-to-end without the real dataset.

A copy of links_tpu/data/synthetic.py (numpy only): the same seed gives the
same poses in both packages.
"""

from __future__ import annotations

import numpy as np

from links_tpu_torch.data.datasets import save_pickle

# Canonical rest skeleton, mm, rooted at the pelvis. Columns: (x, y, z);
# y is up-ish in camera coords (H36M convention has y growing downward in
# pixels; only relative geometry matters here).
_REST = np.array([
    [0, 0, 0],        # 0 pelvis
    [-130, 0, 0],     # 1 right hip
    [-140, 450, 0],   # 2 right knee
    [-150, 900, 0],   # 3 right ankle
    [130, 0, 0],      # 4 left hip
    [140, 450, 0],    # 5 left knee
    [150, 900, 0],    # 6 left ankle
    [0, -230, 0],     # 7 spine
    [0, -480, 0],     # 8 thorax
    [0, -590, 0],     # 9 neck/nose
    [0, -700, 0],     # 10 head
    [170, -450, 0],   # 11 left shoulder
    [420, -430, 0],   # 12 left elbow
    [650, -420, 0],   # 13 left wrist
    [-170, -450, 0],  # 14 right shoulder
    [-420, -430, 0],  # 15 right elbow
    [-650, -420, 0],  # 16 right wrist
], dtype=np.float64)

FOCAL = 1150.0
CAMERA_DEPTH = 5200.0

# Kinematic tree over the 17 joints (parent of joint j; root = -1). Matches
# BONE_MAP_ALL (core/skeleton.py).
_PARENT = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15])
# Per-joint articulation range (rad): limbs swing widely, the torso chain
# bends a little — keeps poses human-plausible while covering the azimuth/
# elevation space the lifters must disambiguate.
_JOINT_SCALE = np.array([0.0, 0.25, 0.45, 0.45, 0.25, 0.45, 0.45,
                         0.10, 0.10, 0.12, 0.12, 0.30, 0.50, 0.50,
                         0.30, 0.50, 0.50])


def _random_rotmats(rng, n, scale):
    """n random small rotations: random axis, N(0, scale) angle (Rodrigues)."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    ang = rng.normal(scale=scale, size=(n, 1, 1))
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -v[:, 2], v[:, 1]
    K[:, 1, 0], K[:, 1, 2] = v[:, 2], -v[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -v[:, 1], v[:, 0]
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)


def _articulate(rng, n):
    """Bone-length-preserving articulation: forward kinematics from the rest
    skeleton with a random per-joint rotation composed along each chain.
    Every generated pose has EXACTLY the rest skeleton's bone lengths, so
    the dataset's relative bone-length means are constant (the regime the
    reference's bone prior assumes — its hard-coded means are dataset
    statistics, train_left_right_lifter.py:76-79)."""
    pos = np.zeros((n, 17, 3))
    rot = np.zeros((n, 17, 3, 3))
    rot[:, 0] = np.eye(3)
    for j in range(1, 17):
        p = _PARENT[j]
        dr = _random_rotmats(rng, n, _JOINT_SCALE[j])
        rot[:, j] = rot[:, p] @ dr
        bone = _REST[j] - _REST[p]
        pos[:, j] = pos[:, p] + np.einsum("nij,j->ni", rot[:, j], bone)
    return pos


def generate_poses(n: int, seed: int = 0):
    """→ dict {'poses_2d': (n,17,2) px, 'poses_3d': (n,17,3) mm camera-frame,
    'poses_3d_univ': same}. Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    base = _articulate(rng, n)
    # random azimuth rotation about the vertical (y) axis
    th = rng.uniform(-np.pi, np.pi, size=n)
    c, s = np.cos(th), np.sin(th)
    ry = np.zeros((n, 3, 3))
    ry[:, 0, 0], ry[:, 0, 2] = c, s
    ry[:, 1, 1] = 1.0
    ry[:, 2, 0], ry[:, 2, 2] = -s, c
    pose = np.einsum("nij,nkj->nki", ry, base)
    # consistent downward camera tilt (~11° ± 5°), as in real captures
    # (H36M cameras look down at the subject). A zero-mean tilt would make
    # the front/back depth-sign ambiguity of single-frame unsupervised
    # lifting unbreakable — ElePose/LInKs break it precisely through the
    # asymmetric elevation distribution the lifter's angle head models
    # (train_left_right_lifter.py:166-183).
    phi = rng.normal(loc=0.2, scale=0.08, size=n)
    cp, sp = np.cos(phi), np.sin(phi)
    rx = np.zeros((n, 3, 3))
    rx[:, 0, 0] = 1.0
    rx[:, 1, 1], rx[:, 1, 2] = cp, -sp
    rx[:, 2, 1], rx[:, 2, 2] = sp, cp
    pose = np.einsum("nij,nkj->nki", rx, pose)

    # camera frame: translate in z, keep roots near the optical axis
    cam = pose.copy()
    cam[:, :, 2] += CAMERA_DEPTH + rng.normal(scale=300.0, size=(n, 1))
    cam[:, :, 0] += rng.normal(scale=200.0, size=(n, 1))
    cam[:, :, 1] += rng.normal(scale=150.0, size=(n, 1))

    p2d = FOCAL * cam[:, :, :2] / cam[:, :, 2:3]
    # simulated detector output (stands in for the reference's OpenPose-
    # detection pickles; consumed by the get_2dgt=False / --no-gt-2d path);
    # drawn from a child generator so the GT streams above stay
    # bit-identical across detector-model revisions for a given seed
    p2d_pred, conf = _simulate_detector(
        np.random.default_rng(int(rng.integers(2**31))), p2d)
    return {
        "poses_2d": p2d.astype(np.float32),
        "poses_2d_pred": p2d_pred.astype(np.float32),
        "conf_2d_pred": conf.astype(np.float32),
        "poses_3d": cam.astype(np.float32),
        "poses_3d_univ": cam.astype(np.float32),
    }


# Per-joint detector noise σ (px): torso chain is easy, limb extremities
# hard — mirroring real 2D-detector error profiles (OpenPose on H36M,
# Supplementary_WACV_Submission_2024-3.pdf §1 motivates exactly this: only
# 45.1% of frames yield a complete detection, failures concentrated on
# limbs).
_DET_SIGMA = np.array([2.0, 2.5, 4.0, 6.0, 2.5, 4.0, 6.0,
                       2.0, 2.0, 2.5, 3.0, 3.0, 4.5, 6.5,
                       3.0, 4.5, 6.5])
# Per-joint dropout probability (fraction of detections below the
# confidence cut): wrists/ankles drop most. Joint probability of a
# complete 17-joint frame ≈ 55% — the same regime as the paper's 45.1%.
_DET_P_DROP = np.array([0.005, 0.01, 0.04, 0.08, 0.01, 0.04, 0.08,
                        0.005, 0.005, 0.01, 0.01, 0.01, 0.04, 0.08,
                        0.01, 0.04, 0.08])


def _simulate_detector(rng, p2d):
    """Noise + confidence-correlated dropout model.

    * per-joint Gaussian pixel noise with σ = ``_DET_SIGMA``;
    * 1.5% of joints are outliers (error ×8 — a mis-localization);
    * confidence: with e = ‖err‖²/σ² (χ², 2 dof), conf = exp(−e/2) is
      exactly U(0, 1) under the noise model, and is *monotonically
      decreasing in the actual error* — so cutting at ``_DET_P_DROP``
      drops precisely the worst detections at exactly the target rate
      (the confidence-correlated dropout a real detector's threshold
      applies). Outliers keep their genuine (tiny) confidence, so the
      detector almost always knows it failed;
    * 0.3% of joints are *confident misses*: error ×6 but confidence
      redrawn uniform — the left/right-confusion failure mode where the
      detector is confidently wrong and the error survives the cut.

    Dropped joints are zeroed — the reference's missing-keypoint
    convention (helpers.py:313-340 zeroes occluded keypoints). Returns
    ``(p2d_pred (n,17,2), conf (n,17))``.
    """
    n = p2d.shape[0]
    err = rng.normal(size=p2d.shape) * _DET_SIGMA[None, :, None]
    outlier = rng.random((n, 17)) < 0.015
    err = np.where(outlier[:, :, None], err * 8.0, err)
    e2 = (err ** 2).sum(-1) / _DET_SIGMA[None, :] ** 2
    conf = np.exp(-e2 / 2.0)
    confident_miss = rng.random((n, 17)) < 0.003
    err = np.where(confident_miss[:, :, None], err * 6.0, err)
    conf = np.where(confident_miss, rng.random((n, 17)), conf)
    dropped = conf < _DET_P_DROP[None, :]
    p2d_pred = np.where(dropped[:, :, None], 0.0, p2d + err)
    return p2d_pred, np.where(dropped, 0.0, conf)


def write_synthetic_pickle(path, n_per_subject: int = 128, seed: int = 0,
                           subjects=("S1", "S2", "S3", "S4", "S5", "S6", "S7",
                                     "S8", "S9", "S11"),
                           n_test_per_subject: int | None = None,
                           test_subjects=("S9", "S11")):
    """Reference-schema pickle with synthetic data for every subject.

    ``n_test_per_subject`` (default: ``n_per_subject``) sizes the
    ``test_subjects`` independently, so large training sets don't force an
    equally large per-epoch validation sweep. H36M evaluates on S9/S11;
    for ``--dataset mpi`` the caller passes S7/S8 (MPI_SUBJECTS[-2:]) too."""
    n_test = n_per_subject if n_test_per_subject is None else n_test_per_subject
    processed = {
        s: generate_poses(n_test if s in test_subjects else n_per_subject,
                          seed=seed + i)
        for i, s in enumerate(subjects)
    }
    save_pickle(path, processed)
    return processed
