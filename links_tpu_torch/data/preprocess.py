"""H36M preprocessing (counterpart of links_tpu/data/preprocess.py):
h36m-fetch ``processed/<subject>/<action>/annot.h5`` -> one pickle with the
reference schema.

Selects the 17-joint subset in the canonical order and concatenates each
subject's actions in sorted order. Output: ``{subject: {'poses_3d': (N, 17,
3), 'poses_2d': (N, 17, 2), 'poses_3d_univ': (N, 17, 3)}}``. Needs h5py,
imported when a tree is read.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

# the 17-joint selection from the 32-joint H36M buffer, in the subset's order
H36M_17_JOINTS = [0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27]


def preprocess_h36m_fetch(file_location: str = "processed/",
                          out_path: str = "h36m_data.pkl") -> dict:
    """Walk the h36m-fetch layout under ``file_location``, pickle the
    per-subject keypoint dict to ``out_path`` and return it."""
    import h5py

    processed = {}
    for subject in sorted(os.listdir(file_location)):
        subj_dir = os.path.join(file_location, subject)
        if not os.path.isdir(subj_dir):
            continue
        p2d, p3d, p3du = [], [], []
        for action in sorted(os.listdir(subj_dir)):
            with h5py.File(os.path.join(subj_dir, action, "annot.h5"), "r") as anno:
                pose = anno["pose"]
                p2d.append(np.array(pose["2d"])[:, H36M_17_JOINTS, :])
                p3d.append(np.array(pose["3d"])[:, H36M_17_JOINTS, :])
                p3du.append(np.array(pose["3d-univ"])[:, H36M_17_JOINTS, :])
        processed[subject] = {
            "poses_3d": np.concatenate(p3d),
            "poses_2d": np.concatenate(p2d),
            "poses_3d_univ": np.concatenate(p3du),
        }
    with open(out_path, "wb") as f:
        pickle.dump(processed, f)
    return processed
