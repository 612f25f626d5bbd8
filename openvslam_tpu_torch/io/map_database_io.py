"""Whole-map snapshots in the native columnar schema (counterpart of
``openvslam_tpu/io/map_database_io.py``; ref ``io/map_database_io``):
cameras, ORB settings, keyframes with descriptors, landmarks, the
covisibility / spanning / loop graph.  The localization workflow loads one,
and autosave writes one as the checkpoint a crashed session resumes from.

The blob (``format: "openvslam_tpu/1"``) and its bytes are the JAX
package's: a map written by either package loads in the other.  Both write
through ``msgpack_codec``; descriptor bits are unpacked on the host by
``ops/orb.unpack_bits_i8``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops.orb import unpack_bits_i8
from . import msgpack_codec

FORMAT = "openvslam_tpu/1"


def _pack_nd(a: np.ndarray) -> Dict[str, Any]:
    return {"dtype": str(a.dtype), "shape": list(a.shape), "data": a.tobytes()}


def _unpack_nd(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=d["dtype"]).reshape(d["shape"]).copy()


def unpack_desc_i8(desc_u32: np.ndarray) -> np.ndarray:
    """(N,8) uint32 descriptor words -> (N,256) int8 bits on the host."""
    words = torch.from_numpy(np.ascontiguousarray(desc_u32, np.uint32).view(np.int32))
    return unpack_bits_i8(words).numpy()


def save_map(db, cfg, path: str):
    """Write ``db`` (and ``cfg``'s camera and ORB settings) to ``path``."""
    kfs = []
    for kf in db.valid_kf_ids():
        kf = int(kf)
        kfs.append({
            "id": kf,
            "ts": float(db.kf_timestamp[kf]),
            "src_frame": int(db.kf_src_frame[kf]),
            "pose_cw": _pack_nd(db.kf_pose_cw[kf]),
            "xy": _pack_nd(db.kf_xy[kf]),
            "xy_undist": _pack_nd(db.kf_xy_undist[kf]),
            "bearing": _pack_nd(db.kf_bearing[kf]),
            "level": _pack_nd(db.kf_level[kf]),
            "angle": _pack_nd(db.kf_angle[kf]),
            "desc_u32": _pack_nd(db.kf_desc_u32[kf]),
            "kpt_valid": _pack_nd(db.kf_kpt_valid[kf]),
            "x_right": _pack_nd(db.kf_x_right[kf]),
            "depth": _pack_nd(db.kf_depth[kf]),
            "lm_idx": _pack_nd(db.kf_lm_idx[kf]),
            "parent": int(db.parent[kf]),
            "loop_edges": sorted(int(x) for x in db.loop_edges[kf]),
            "camera": db.kf_camera[kf],
        })
    lms = []
    for lm in db.valid_lm_ids():
        lm = int(lm)
        lms.append({
            "id": lm,
            "pos": _pack_nd(db.lm_pos[lm]),
            "desc_u32": _pack_nd(db.lm_desc_u32[lm]),
            "normal": _pack_nd(db.lm_normal[lm]),
            "min_dist": float(db.lm_min_dist[lm]),
            "max_dist": float(db.lm_max_dist[lm]),
            "ref_kf": int(db.lm_ref_kf[lm]),
            "first_kf": int(db.lm_first_kf[lm]),
            "n_visible": int(db.lm_n_visible[lm]),
            "n_found": int(db.lm_n_found[lm]),
            "obs": {str(k): int(v) for k, v in (db.lm_obs[lm] or {}).items()},
        })
    cam = cfg.camera
    blob = {
        "format": FORMAT,
        "camera": {
            "model": getattr(cam, "model_name", "perspective"),
            "setup": cam.setup.value,
            "cols": cam.cols, "rows": cam.rows, "fps": cam.fps,
            "focal_x_baseline": float(getattr(cam, "focal_x_baseline", 0.0)),
            "params": {k: float(getattr(cam, k))
                       for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4")
                       if hasattr(cam, k)},
        },
        "orb": {
            "max_num_keypts": cfg.feature.max_num_keypts,
            "scale_factor": cfg.feature.scale_factor,
            "num_levels": cfg.feature.num_levels,
        },
        # the camera database: every camera a keyframe of this map was
        # captured with
        "cameras": dict(db.cameras),
        "default_camera": db.default_camera,
        "origin_kf": int(db.origin_kf),
        "keyframes": kfs,
        "landmarks": lms,
    }
    with open(path, "wb") as f:
        f.write(msgpack_codec.packb(blob))


def load_map(db, path: str, blob: Dict[str, Any] = None):
    """Rebuild an EMPTY database from a snapshot (``blob`` if the caller has
    decoded the file already).  Ids are compacted in save order; a camera
    whose name collides with a different pre-registered camera (the loading
    session's own) is registered under a suffixed name and the keyframes
    are remapped to it.  Returns the blob's ``camera`` and ``orb`` entries."""
    if blob is None:
        with open(path, "rb") as f:
            blob = msgpack_codec.unpackb(f.read())
    if not str(blob.get("format", "")).startswith("openvslam_tpu/"):
        raise ValueError(f"{path}: not a native map snapshot (format {blob.get('format')!r})")
    if db.n_kfs or db.n_lms:
        raise ValueError("load_map needs a fresh database")

    cam_name_map: Dict[str, str] = {}
    for name, spec in blob.get("cameras", {}).items():
        cam_name_map[name] = db.register_camera(name, spec)
    if blob.get("default_camera"):
        db.default_camera = cam_name_map.get(blob["default_camera"], blob["default_camera"])

    id_map_kf: Dict[int, int] = {}
    db._ensure_kf_capacity(len(blob["keyframes"]))
    for k in blob["keyframes"]:
        kf = db.n_kfs
        db.n_kfs += 1
        id_map_kf[k["id"]] = kf
        db.kf_valid[kf] = True
        db.kf_pose_cw[kf] = _unpack_nd(k["pose_cw"])
        db.kf_timestamp[kf] = k["ts"]
        db.kf_src_frame[kf] = k["src_frame"]
        db.kf_xy[kf] = _unpack_nd(k["xy"])
        db.kf_xy_undist[kf] = _unpack_nd(k["xy_undist"])
        db.kf_bearing[kf] = _unpack_nd(k["bearing"])
        db.kf_level[kf] = _unpack_nd(k["level"])
        db.kf_angle[kf] = _unpack_nd(k["angle"])
        du32 = _unpack_nd(k["desc_u32"])
        db.kf_desc_u32[kf] = du32
        db.kf_desc_i8[kf] = unpack_desc_i8(du32)
        db.kf_kpt_valid[kf] = _unpack_nd(k["kpt_valid"])
        db.kf_x_right[kf] = _unpack_nd(k["x_right"])
        db.kf_depth[kf] = _unpack_nd(k["depth"])
        db.kf_lm_idx[kf] = np.full(db.K, -1, np.int32)
        cn = k.get("camera")
        db.kf_camera[kf] = cam_name_map.get(cn, cn)
        db.covis[kf] = {}
        db.covis_ordered[kf] = np.zeros(0, np.int32)
        db.children[kf] = set()
        db.loop_edges[kf] = set()
    db.origin_kf = id_map_kf.get(blob["origin_kf"], 0)

    id_map_lm: Dict[int, int] = {}
    db._ensure_lm_capacity(len(blob["landmarks"]))
    for l in blob["landmarks"]:
        lm = db.n_lms
        db.n_lms += 1
        id_map_lm[l["id"]] = lm
        db.lm_valid[lm] = True
        db.lm_pos[lm] = _unpack_nd(l["pos"])
        du32 = _unpack_nd(l["desc_u32"])
        db.lm_desc_u32[lm] = du32
        db.lm_desc_i8[lm] = unpack_desc_i8(du32[None])[0]
        db.lm_normal[lm] = _unpack_nd(l["normal"])
        db.lm_min_dist[lm] = l["min_dist"]
        db.lm_max_dist[lm] = l["max_dist"]
        db.lm_ref_kf[lm] = id_map_kf.get(l["ref_kf"], -1)
        db.lm_first_kf[lm] = id_map_kf.get(l["first_kf"], -1)
        db.lm_n_visible[lm] = l["n_visible"]
        db.lm_n_found[lm] = l["n_found"]
        db.lm_obs[lm] = {}
    for l in blob["landmarks"]:
        lm = id_map_lm[l["id"]]
        for kf_str, idx in l["obs"].items():
            kf = id_map_kf.get(int(kf_str))
            if kf is not None:
                db.add_observation(lm, kf, idx)
    for k in blob["keyframes"]:
        kf = id_map_kf[k["id"]]
        p = id_map_kf.get(k["parent"], -1) if k["parent"] >= 0 else -1
        db.parent[kf] = p
        if p >= 0:
            db.children[p].add(kf)
        for le in k["loop_edges"]:
            if le in id_map_kf:
                db.loop_edges[kf].add(id_map_kf[le])
        db.update_connections(kf, set_parent=False)
    return blob["camera"], blob["orb"]
