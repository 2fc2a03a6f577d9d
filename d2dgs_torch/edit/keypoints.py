"""Keypoint bookkeeping for editing (counterpart of
d2dgs_tpu/edit/keypoints.py, the reference's train_gui_utils.py
DeformKeypoints): the selected control nodes, their handle positions
and the active drag group, in numpy.
"""
from __future__ import annotations

import numpy as np


class DeformKeypoints:
    def __init__(self):
        self.keypoints_idx: list[int] = []
        self.keypoints_3d: list[np.ndarray] = []
        self.idx_set: set[int] = set()
        self.selective_keypoints_idx: list[int] = []  # active drag group

    def __len__(self):
        return len(self.keypoints_idx)

    def add_kpts(self, pcl, idx, expand: bool = False):
        """Register keypoints at indices `idx` with positions from `pcl`
        (skips duplicates).  expand=True adds them to the active group."""
        idx = np.atleast_1d(np.asarray(idx, np.int64))
        fresh = [int(i) for i in idx if int(i) not in self.idx_set]
        pcl = np.asarray(pcl)
        for i in fresh:
            self.keypoints_idx.append(i)
            self.keypoints_3d.append(pcl[i].copy())
            self.idx_set.add(i)
        if expand:
            self.selective_keypoints_idx.extend(
                self.keypoints_idx.index(i) for i in fresh)

    def select_kpts(self, idx):
        """Set the active drag group to the registered keypoints in idx."""
        wanted = set(int(i) for i in np.atleast_1d(idx))
        self.selective_keypoints_idx = [
            k for k, i in enumerate(self.keypoints_idx) if i in wanted]

    def delete_kpts(self, idx):
        wanted = set(int(i) for i in np.atleast_1d(idx))
        keep = [k for k, i in enumerate(self.keypoints_idx)
                if i not in wanted]
        self.keypoints_idx = [self.keypoints_idx[k] for k in keep]
        self.keypoints_3d = [self.keypoints_3d[k] for k in keep]
        self.idx_set = set(self.keypoints_idx)
        self.selective_keypoints_idx = []

    def update_kpts(self, delta):
        """Translate the active group by `delta` [3]."""
        delta = np.asarray(delta, np.float64)
        for k in self.selective_keypoints_idx:
            self.keypoints_3d[k] = self.keypoints_3d[k] + delta

    def get_kpts(self):
        return (np.asarray(self.keypoints_idx, np.int64),
                np.asarray(self.keypoints_3d, np.float32).reshape(-1, 3))
