"""Camera setup and model types and the config factory (counterpart of
``openvslam_tpu/camera/base.py``)."""
from __future__ import annotations

import enum
from typing import Any, Mapping


class SetupType(enum.Enum):
    MONOCULAR = "monocular"
    STEREO = "stereo"
    RGBD = "rgbd"


class ModelType(enum.Enum):
    PERSPECTIVE = "perspective"
    FISHEYE = "fisheye"
    EQUIRECTANGULAR = "equirectangular"


def make_camera_from_config(cam_cfg: Mapping[str, Any]):
    """Build a camera from the reference's ``Camera:`` section: name, setup,
    model, fx/fy/cx/cy, k1..k3/p1/p2 (perspective), k1..k4 (fisheye), fps,
    cols, rows, focal_x_baseline, depth_threshold.  An equirectangular
    camera is always monocular; an unknown model raises ValueError."""
    from .equirectangular import Equirectangular
    from .fisheye import Fisheye
    from .perspective import Perspective

    model = cam_cfg.get("model", "perspective")
    setup = SetupType(str(cam_cfg.get("setup", "monocular")).lower())
    common = dict(cols=int(cam_cfg["cols"]), rows=int(cam_cfg["rows"]),
                  fps=float(cam_cfg.get("fps", 30.0)))
    if model not in {m.value for m in ModelType}:
        raise ValueError(f"unknown camera model: {model}")
    if model == "equirectangular":
        return Equirectangular(**common)
    depth = dict(setup=setup, focal_x_baseline=float(cam_cfg.get("focal_x_baseline", 0.0)),
                 depth_threshold=float(cam_cfg.get("depth_threshold", 40.0)))
    k = {name: float(cam_cfg.get(name, 0.0)) for name in ("k1", "k2", "k3")}
    intr = {name: float(cam_cfg[name]) for name in ("fx", "fy", "cx", "cy")}
    if model == "perspective":
        return Perspective(**intr, **k, p1=float(cam_cfg.get("p1", 0.0)),
                           p2=float(cam_cfg.get("p2", 0.0)), **common, **depth)
    return Fisheye(**intr, **k, k4=float(cam_cfg.get("k4", 0.0)), **common, **depth)


def camera_to_config(cam) -> dict:
    """Inverse of make_camera_from_config: a serializable spec dict with the
    same keys as the JAX package's ``camera_to_config`` (the intrinsics and
    coefficients the model has: no fx for an equirectangular camera, k4 for
    a fisheye)."""
    spec = {
        "model": cam.model_name,
        "setup": cam.setup.value,
        "cols": int(cam.cols),
        "rows": int(cam.rows),
        "fps": float(cam.fps),
        "focal_x_baseline": float(cam.focal_x_baseline),
        "depth_threshold": float(cam.depth_threshold),
    }
    for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4"):
        if hasattr(cam, k):
            spec[k] = float(getattr(cam, k))
    return spec
