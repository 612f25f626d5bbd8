"""The reference's own MessagePack map schema (counterpart of
``openvslam_tpu/io/msgpack_compat.py``; ref ``io/map_database_io``).

``save_map_openvslam`` writes the layout the reference's
``map_database_io::save`` produces (nlohmann::json -> msgpack): top-level
``{"cameras", "keyframes", "landmarks", "frame_next_id",
"keyframe_next_id", "landmark_next_id"}`` with per-keyframe
``rot_cw``/``trans_cw``/``keypts``/``undists``/``descs``/``lm_ids``/
``span_parent``/``span_children``/``loop_edges`` and per-landmark
``pos_w``/``ref_keyfrm``/``1st_keyfrm``/``n_vis``/``n_fnd`` entries.
``load_map_openvslam`` rebuilds an empty ``MapDatabase`` from such a file.
The bytes written are the JAX package's for the same map.

Conventions (the JAX package's, which reconstructs the schema from the
successor project):

* ``rot_cw`` is the camera<-world rotation as Eigen quaternion coefficients
  ``[x, y, z, w]``; ``trans_cw`` the translation.  Loading returns the
  rotation of the unit quaternion: for a stored matrix that has drifted off
  SO(3) that is its nearest rotation, not the matrix itself.
* keyframe and landmark ids are the keys of the ``keyframes`` and
  ``landmarks`` maps (decimal strings); the loader compacts them.
* ``descs`` are 32-byte strings in OpenCV's ORB bit order (bit k of byte j
  is test j*8+k), which is the little-endian memory of the (8,) uint32 row.
* ``keypts`` entries are ``{"pt": [x, y], "ang": degrees, "oct": level}``;
  only valid keypoints are stored, so keypoint indices are compacted too.

Landmark descriptors, normals and distance ranges are derived state: the
loader recomputes them from the observations, as the reference does.
Keypoint bearings are recomputed through the keyframe's camera from the
raw keypoints (``pt``), which is how a frame computes them; the JAX loader
passes the undistorted keypoints through the camera's undistortion again,
which differs for a distorted camera.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.log import get_logger
from . import msgpack_codec
from .map_database_io import unpack_desc_i8

log = get_logger("msgpack_compat")


# ---------------------------------------------------------------------------
# descriptors: (8,) uint32 rows <-> 32-byte ORB strings
# ---------------------------------------------------------------------------
def desc_u32_to_bytes(row: np.ndarray) -> bytes:
    return np.ascontiguousarray(row.astype("<u4")).tobytes()


def desc_bytes_to_u32(buf: bytes) -> np.ndarray:
    return np.frombuffer(buf, dtype="<u4").astype(np.uint32)


# ---------------------------------------------------------------------------
# rotation <-> quaternion (Eigen coefficient order x, y, z, w)
# ---------------------------------------------------------------------------
def rot_to_quat_xyzw(R: np.ndarray) -> list:
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0)) * 2
        q = np.zeros(3)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    return [float(x), float(y), float(z), float(w)]


def quat_xyzw_to_rot(q) -> np.ndarray:
    x, y, z, w = [float(v) for v in q]
    n = np.sqrt(x * x + y * y + z * z + w * w) or 1.0
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)


# ---------------------------------------------------------------------------
# camera spec (the YAML-schema dict of camera_to_config) <-> reference json
# ---------------------------------------------------------------------------
_MODEL_TO_REF = {"perspective": "Perspective", "fisheye": "Fisheye",
                 "equirectangular": "Equirectangular"}
_MODEL_FROM_REF = {v.lower(): k for k, v in _MODEL_TO_REF.items()}
_SETUP_TO_REF = {"monocular": "Monocular", "stereo": "Stereo", "rgbd": "RGBD"}

_PERSPECTIVE_KEYS = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")
_FISHEYE_KEYS = ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4")


def camera_spec_to_ref(spec: Dict[str, Any]) -> Dict[str, Any]:
    model = str(spec.get("model", "perspective")).lower()
    out: Dict[str, Any] = {
        "model_type": _MODEL_TO_REF.get(model, "Perspective"),
        "setup_type": _SETUP_TO_REF.get(str(spec.get("setup", "monocular")).lower(),
                                        "Monocular"),
        "color_order": spec.get("color_order", "Gray"),
        "cols": int(spec["cols"]),
        "rows": int(spec["rows"]),
        "fps": float(spec.get("fps", 30.0)),
        "focal_x_baseline": float(spec.get("focal_x_baseline", 0.0)),
        "num_grid_cols": int(spec.get("num_grid_cols", 64)),
        "num_grid_rows": int(spec.get("num_grid_rows", 48)),
    }
    keys = {"perspective": _PERSPECTIVE_KEYS, "fisheye": _FISHEYE_KEYS}.get(model, ())
    for k in keys:
        out[k] = float(spec.get(k, 0.0))
    return out


def camera_spec_from_ref(ref: Dict[str, Any]) -> Dict[str, Any]:
    model = _MODEL_FROM_REF.get(str(ref.get("model_type", "Perspective")).lower(), "perspective")
    spec: Dict[str, Any] = {
        "model": model,
        "setup": str(ref.get("setup_type", "Monocular")).lower(),
        "color_order": ref.get("color_order", "Gray"),
        "cols": int(ref["cols"]),
        "rows": int(ref["rows"]),
        "fps": float(ref.get("fps", 30.0)),
        "focal_x_baseline": float(ref.get("focal_x_baseline", 0.0)),
    }
    keys = {"perspective": _PERSPECTIVE_KEYS, "fisheye": _FISHEYE_KEYS}.get(model, ())
    for k in keys:
        if k in ref:
            spec[k] = float(ref[k])
    return spec


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------
def save_map_openvslam(db, cfg, path: str):
    """Write the map in the reference's msgpack schema."""
    cameras = {name: camera_spec_to_ref(spec) for name, spec in db.cameras.items()}
    n_levels = int(cfg.feature.num_levels)
    scale = float(cfg.feature.scale_factor)

    keyframes: Dict[str, Any] = {}
    for kf in db.valid_kf_ids():
        kf = int(kf)
        # the reference stores only real keypoints: compact the padded SoA
        sel = np.flatnonzero(db.kf_kpt_valid[kf].astype(bool))
        n = len(sel)
        xy = db.kf_xy[kf][sel]
        und = db.kf_xy_undist[kf][sel]
        lvl = db.kf_level[kf][sel]
        ang = db.kf_angle[kf][sel]
        du32 = db.kf_desc_u32[kf][sel]
        T = np.asarray(db.kf_pose_cw[kf], np.float64)
        keyframes[str(kf)] = {
            "ts": float(db.kf_timestamp[kf]),
            "cam": db.kf_camera[kf] or db.default_camera,
            "src_frm_id": int(db.kf_src_frame[kf]),
            "rot_cw": rot_to_quat_xyzw(T[:3, :3]),
            "trans_cw": [float(v) for v in T[:3, 3]],
            "n_keypts": n,
            "keypts": [{"pt": [float(xy[i, 0]), float(xy[i, 1])],
                        "ang": float(np.degrees(ang[i])), "oct": int(lvl[i])}
                       for i in range(n)],
            "undists": [[float(und[i, 0]), float(und[i, 1])] for i in range(n)],
            "x_rights": [float(v) for v in db.kf_x_right[kf][sel]],
            "depths": [float(v) for v in db.kf_depth[kf][sel]],
            "descs": [desc_u32_to_bytes(du32[i]) for i in range(n)],
            "lm_ids": [int(v) for v in db.kf_lm_idx[kf][sel]],
            "span_parent": int(db.parent[kf]),
            "span_children": sorted(int(c) for c in (db.children[kf] or ())),
            "loop_edges": sorted(int(e) for e in (db.loop_edges[kf] or ())),
            "n_scale_levels": n_levels,
            "scale_factor": scale,
            "depth_thr": float(getattr(cfg.camera, "depth_threshold", 40.0)),
        }

    landmarks: Dict[str, Any] = {}
    for lm in db.valid_lm_ids():
        lm = int(lm)
        landmarks[str(lm)] = {
            "1st_keyfrm": int(db.lm_first_kf[lm]),
            "pos_w": [float(v) for v in db.lm_pos[lm]],
            "ref_keyfrm": int(db.lm_ref_kf[lm]),
            "n_vis": int(db.lm_n_visible[lm]),
            "n_fnd": int(db.lm_n_found[lm]),
        }

    blob = {
        "cameras": cameras,
        "keyframes": keyframes,
        "landmarks": landmarks,
        "frame_next_id": int(max((int(db.kf_src_frame[k]) for k in db.valid_kf_ids()),
                                 default=-1)) + 1,
        "keyframe_next_id": int(db.n_kfs),
        "landmark_next_id": int(db.n_lms),
    }
    with open(path, "wb") as f:
        f.write(msgpack_codec.packb(blob))


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------
def sniff_blob(blob: Dict[str, Any]) -> bool:
    """True if a decoded map is in the reference's schema (no "format" key,
    an id-keyed "keyframes" map)."""
    return ("format" not in blob and "keyframes" in blob
            and isinstance(blob["keyframes"], dict))


def is_openvslam_format(path: str) -> bool:
    with open(path, "rb") as f:
        return sniff_blob(msgpack_codec.unpackb(f.read()))


def load_map_openvslam(db, path: str, kpt_capacity: Optional[int] = None,
                       blob: Optional[Dict[str, Any]] = None):
    """Rebuild an EMPTY MapDatabase from a reference-schema map (``blob`` if
    the caller has decoded the file already).  Keypoint arrays are padded to
    the database's capacity.  Returns ``(camera_json_by_name,
    orb_params)``."""
    if blob is None:
        with open(path, "rb") as f:
            blob = msgpack_codec.unpackb(f.read())
    if db.n_kfs or db.n_lms:
        raise ValueError("load_map_openvslam needs a fresh database")

    cam_name_map: Dict[str, str] = {}
    ref_cams = blob.get("cameras", {})
    for name, ref in ref_cams.items():
        cam_name_map[name] = db.register_camera(name, camera_spec_from_ref(ref))

    K = kpt_capacity or db.K
    kf_items = sorted(blob.get("keyframes", {}).items(), key=lambda kv: int(kv[0]))
    lm_items = sorted(blob.get("landmarks", {}).items(), key=lambda kv: int(kv[0]))

    id_map_kf: Dict[int, int] = {}
    cam_cache: Dict[str, Any] = {}
    scale_factor = 1.2
    n_scale_levels = 8
    db._ensure_kf_capacity(len(kf_items))
    for sid, k in kf_items:
        kf = db.n_kfs
        db.n_kfs += 1
        id_map_kf[int(sid)] = kf
        db.kf_valid[kf] = True
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = quat_xyzw_to_rot(k["rot_cw"]).astype(np.float32)
        T[:3, 3] = np.asarray(k["trans_cw"], np.float32)
        db.kf_pose_cw[kf] = T
        db.kf_timestamp[kf] = float(k.get("ts", 0.0))
        db.kf_src_frame[kf] = int(k.get("src_frm_id", -1))
        n = int(k.get("n_keypts", len(k.get("keypts", ()))))
        if n > K:
            log.warning("keyframe %s carries %d keypoints but the database capacity is %d; "
                        "truncating (raise Feature.max_num_keypts to keep them all)", sid, n, K)
        n = min(n, K)
        xy = np.zeros((K, 2), np.float32)
        und = np.zeros((K, 2), np.float32)
        lvl = np.zeros(K, np.int32)
        ang = np.zeros(K, np.float32)
        xr = np.full(K, -1.0, np.float32)
        dep = np.full(K, -1.0, np.float32)
        du32 = np.zeros((K, 8), np.uint32)
        vmask = np.zeros(K, bool)
        for i in range(n):
            kp = k["keypts"][i]
            xy[i] = kp["pt"]
            lvl[i] = int(kp.get("oct", 0))
            ang[i] = np.radians(float(kp.get("ang", 0.0)))
            und[i] = k["undists"][i]
            du32[i] = desc_bytes_to_u32(k["descs"][i])
            vmask[i] = True
        if k.get("x_rights"):
            xr[:n] = np.asarray(k["x_rights"][:n], np.float32)
        if k.get("depths"):
            dep[:n] = np.asarray(k["depths"][:n], np.float32)
        db.kf_xy[kf] = xy
        db.kf_xy_undist[kf] = und
        db.kf_level[kf] = lvl
        db.kf_angle[kf] = ang
        db.kf_x_right[kf] = xr
        db.kf_depth[kf] = dep
        db.kf_desc_u32[kf] = du32
        db.kf_desc_i8[kf] = unpack_desc_i8(du32)
        db.kf_kpt_valid[kf] = vmask
        db.kf_lm_idx[kf] = np.full(K, -1, np.int32)
        cname = cam_name_map.get(k.get("cam"), k.get("cam"))
        if cname is None:
            cname = db.default_camera
        db.kf_camera[kf] = cname
        if cname not in cam_cache:
            cam_cache[cname] = db.get_camera(cname)
        brg = np.zeros((K, 3), np.float32)
        if n:
            brg[:n] = cam_cache[cname].keypoints_to_bearings(torch.from_numpy(xy[:n])).numpy()
        db.kf_bearing[kf] = brg
        db.covis[kf] = {}
        db.covis_ordered[kf] = np.zeros(0, np.int32)
        db.children[kf] = set()
        db.loop_edges[kf] = set()
        scale_factor = float(k.get("scale_factor", scale_factor))
        n_scale_levels = int(k.get("n_scale_levels", n_scale_levels))
    if id_map_kf:
        db.origin_kf = id_map_kf[min(id_map_kf)]

    id_map_lm: Dict[int, int] = {}
    db._ensure_lm_capacity(len(lm_items))
    for sid, l in lm_items:
        lm = db.n_lms
        db.n_lms += 1
        id_map_lm[int(sid)] = lm
        db.lm_valid[lm] = True
        db.lm_pos[lm] = np.asarray(l["pos_w"], np.float32)
        db.lm_ref_kf[lm] = id_map_kf.get(int(l.get("ref_keyfrm", -1)), -1)
        db.lm_first_kf[lm] = id_map_kf.get(int(l.get("1st_keyfrm", -1)), -1)
        db.lm_n_visible[lm] = int(l.get("n_vis", 1))
        db.lm_n_found[lm] = int(l.get("n_fnd", 1))
        db.lm_obs[lm] = {}

    # observations from each keyframe's lm_ids column
    for sid, k in kf_items:
        kf = id_map_kf[int(sid)]
        for idx, lid in enumerate(k.get("lm_ids", ())):
            if lid >= 0 and idx < K and int(lid) in id_map_lm:
                db.add_observation(id_map_lm[int(lid)], kf, idx)

    # landmark descriptors, normals and distance ranges are derived state
    for sid, l in lm_items:
        lm = id_map_lm[int(sid)]
        obs = db.lm_obs[lm]
        if obs:
            if db.lm_ref_kf[lm] < 0 or db.lm_ref_kf[lm] not in obs:
                db.lm_ref_kf[lm] = next(iter(obs))
            db.update_landmark_descriptor(lm)
            db.update_landmark_geometry(lm, scale_factor, n_scale_levels)
        else:
            db.lm_valid[lm] = False

    # spanning tree, loop edges, covisibility
    for sid, k in kf_items:
        kf = id_map_kf[int(sid)]
        p = int(k.get("span_parent", -1))
        db.parent[kf] = id_map_kf.get(p, -1) if p >= 0 else -1
        if db.parent[kf] >= 0:
            db.children[db.parent[kf]].add(kf)
        for le in k.get("loop_edges", ()):
            if int(le) in id_map_kf:
                db.loop_edges[kf].add(id_map_kf[int(le)])
        db.update_connections(kf, set_parent=False)

    orb_params = {"max_num_keypts": K, "scale_factor": scale_factor,
                  "num_levels": n_scale_levels}
    cam_json = {cam_name_map.get(n, n): ref for n, ref in ref_cams.items()}
    return cam_json, orb_params
