"""Camera setup types and the perspective part of the config factory
(counterpart of ``openvslam_tpu/camera/base.py``)."""
from __future__ import annotations

import enum
from typing import Any, Mapping


class SetupType(enum.Enum):
    MONOCULAR = "monocular"
    STEREO = "stereo"
    RGBD = "rgbd"


def make_camera_from_config(cam_cfg: Mapping[str, Any]):
    """Build a camera from the reference's ``Camera:`` section.  Only the
    perspective model is ported so far; other models raise."""
    from .perspective import Perspective

    model = cam_cfg.get("model", "perspective")
    if model != "perspective":
        raise NotImplementedError(f"camera model {model!r} is not ported yet")
    return Perspective(
        fx=float(cam_cfg["fx"]),
        fy=float(cam_cfg["fy"]),
        cx=float(cam_cfg["cx"]),
        cy=float(cam_cfg["cy"]),
        k1=float(cam_cfg.get("k1", 0.0)),
        k2=float(cam_cfg.get("k2", 0.0)),
        p1=float(cam_cfg.get("p1", 0.0)),
        p2=float(cam_cfg.get("p2", 0.0)),
        k3=float(cam_cfg.get("k3", 0.0)),
        cols=int(cam_cfg["cols"]),
        rows=int(cam_cfg["rows"]),
        fps=float(cam_cfg.get("fps", 30.0)),
        setup=SetupType(str(cam_cfg.get("setup", "monocular")).lower()),
        focal_x_baseline=float(cam_cfg.get("focal_x_baseline", 0.0)),
        depth_threshold=float(cam_cfg.get("depth_threshold", 40.0)),
    )


def camera_to_config(cam) -> dict:
    """Inverse of make_camera_from_config: a serializable spec dict with the
    same keys as the JAX package's ``camera_to_config``."""
    spec = {
        "model": cam.model_name,
        "setup": cam.setup.value,
        "cols": int(cam.cols),
        "rows": int(cam.rows),
        "fps": float(cam.fps),
        "focal_x_baseline": float(cam.focal_x_baseline),
        "depth_threshold": float(cam.depth_threshold),
    }
    for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3"):
        spec[k] = float(getattr(cam, k))
    return spec
