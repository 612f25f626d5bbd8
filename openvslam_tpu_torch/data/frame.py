"""Per-frame container (a copy of ``openvslam_tpu/data/frame.py``; ref
``data/frame``): fixed-capacity keypoint SoA + bearings + landmark
associations + pose, as numpy on the host.

``from_keypoints`` takes the port's ``Keypoints``, which carry only the
packed descriptor words: the (K,256) bits are unpacked on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..models.track_step import unpack_bits_host


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    # keypoint SoA (capacity K)
    xy: np.ndarray           # (K,2) raw pixel coords (level-0 scale)
    xy_undist: np.ndarray    # (K,2) undistorted pixel coords
    bearing: np.ndarray      # (K,3) unit bearings
    level: np.ndarray        # (K,) int
    angle: np.ndarray        # (K,) f32
    response: np.ndarray     # (K,)
    desc_u32: np.ndarray     # (K,8) packed descriptors (uint32)
    desc_i8: np.ndarray      # (K,256) unpacked bits
    valid: np.ndarray        # (K,) bool
    # stereo / RGBD (x_right < 0 means monocular observation)
    x_right: np.ndarray      # (K,)
    depth: np.ndarray        # (K,)
    # landmark association (-1 = none) and outlier flags
    lm_idx: np.ndarray       # (K,) i32
    outlier: np.ndarray      # (K,) bool
    # pose cam<-world (None until tracked)
    pose_cw: Optional[np.ndarray] = None

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())

    @classmethod
    def from_keypoints(cls, frame_id, timestamp, kp, cam, x_right=None, depth=None):
        """kp: models.frontend.Keypoints (tensors on any device); x_right and
        depth (K,) host arrays of a stereo/RGB-D frame (-1: none)."""
        host = lambda t: t.cpu().numpy()  # noqa: E731
        xy = host(kp.xy)
        valid = host(kp.valid)
        desc_u32 = host(kp.desc_u32).view(np.uint32)
        K = xy.shape[0]
        return cls(
            frame_id=frame_id,
            timestamp=timestamp,
            xy=xy,
            xy_undist=host(cam.undistort_keypoints(kp.xy)),
            bearing=host(cam.keypoints_to_bearings(kp.xy)),
            level=host(kp.level),
            angle=host(kp.angle),
            response=host(kp.response),
            desc_u32=desc_u32,
            desc_i8=unpack_bits_host(desc_u32, valid),
            valid=valid,
            x_right=np.full(K, -1.0, np.float32) if x_right is None else np.asarray(x_right),
            depth=np.full(K, -1.0, np.float32) if depth is None else np.asarray(depth),
            lm_idx=np.full(K, -1, np.int32),
            outlier=np.zeros(K, bool),
        )
