"""Viewer-facing snapshot publishers (a copy of
``openvslam_tpu/publish/publishers.py``; ref ``publish/frame_publisher`` and
``publish/map_publisher``): thread-safe copies of the current frame state,
camera pose, keyframe poses, and landmark positions for external viewers."""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np


class FramePublisher:
    """Current-frame snapshot: keypoints + their tracking states."""

    def __init__(self):
        self._lock = threading.Lock()
        self._snap: Optional[Dict] = None

    def publish(self, frame, state_name: str, image=None):
        with self._lock:
            self._snap = {
                "frame_id": frame.frame_id,
                "timestamp": frame.timestamp,
                "state": state_name,
                "keypoints": frame.xy[frame.valid].copy(),
                "tracked": (frame.lm_idx >= 0)[frame.valid].copy(),
                "pose_cw": None if frame.pose_cw is None else frame.pose_cw.copy(),
                # grayscale uint8 view for viewers (ref frame_publisher draws
                # keypoints on the image); None when the caller skips it
                "image": None if image is None else np.asarray(image),
            }

    def get_current_frame(self) -> Optional[Dict]:
        with self._lock:
            return None if self._snap is None else dict(self._snap)


class MapPublisher:
    """Map snapshot: all keyframe poses + landmark positions + current pose."""

    def __init__(self, map_db):
        self.db = map_db
        self._lock = threading.Lock()
        self._current_pose = np.eye(4, dtype=np.float32)

    def set_current_pose(self, pose_cw: np.ndarray):
        with self._lock:
            self._current_pose = pose_cw.copy()

    def get_current_pose(self) -> np.ndarray:
        with self._lock:
            return self._current_pose.copy()

    def get_keyframes(self):
        ids = self.db.valid_kf_ids()
        return ids.copy(), self.db.kf_pose_cw[ids].copy()

    def get_landmarks(self):
        ids = self.db.valid_lm_ids()
        return ids.copy(), self.db.lm_pos[ids].copy()

    def get_covisibility_edges(self):
        edges = []
        for kf in self.db.valid_kf_ids():
            kf = int(kf)
            for nb in (self.db.covis[kf] or {}):
                if nb > kf:
                    edges.append((kf, nb))
        return edges

    def get_spanning_tree_edges(self):
        edges = []
        for kf in self.db.valid_kf_ids():
            p = int(self.db.parent[int(kf)])
            if p >= 0:
                edges.append((p, int(kf)))
        return edges
