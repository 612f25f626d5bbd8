"""Host map database: keyframes + landmarks + covisibility/spanning graph
(a copy of ``openvslam_tpu/data/map_database.py``; the camera registry
builds the port's cameras and the representative descriptor uses the
port's own native build).

Replaces the reference's ``data/map_database`` + ``data/keyframe`` +
``data/landmark`` + ``data/graph_node``.  Pointer webs
become integer ids over numpy SoA columns; the single big database mutex
becomes "one writer" by construction (the mapping step is the only mutator
between tracking calls).

Numeric columns are laid out so device uploads are plain slices:
  kf_desc_i8[kf]      (K,256) int8   — matching operand
  lm_pos[ids]         (n,3)   f32    — BA / projection operand
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

COVIS_WEIGHT_THR = 15   # reference threshold for covisibility edges


def _popcount_u32(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x)


def hamming_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distance between packed (…,8) u32 descriptor rows."""
    return _popcount_u32(a ^ b).sum(-1)


class MapDatabase:
    def __init__(self, kpt_capacity: int, max_kfs: int = 4096, max_lms: int = 1 << 18):
        self.K = kpt_capacity
        self.max_kfs = max_kfs
        self.max_lms = max_lms

        # --- keyframes (SoA, lists of per-KF arrays kept contiguous) ---
        self.kf_valid = np.zeros(max_kfs, bool)
        self.kf_pose_cw = np.zeros((max_kfs, 4, 4), np.float32)
        self.kf_timestamp = np.zeros(max_kfs, np.float64)
        self.kf_src_frame = np.full(max_kfs, -1, np.int64)
        self.kf_xy: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_xy_undist: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_bearing: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_level: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_angle: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_desc_u32: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_desc_i8: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_kpt_valid: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_x_right: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_depth: List[Optional[np.ndarray]] = [None] * max_kfs
        self.kf_lm_idx: List[Optional[np.ndarray]] = [None] * max_kfs   # (K,) -> lm id
        self.n_kfs = 0

        # --- landmarks ---
        self.lm_valid = np.zeros(max_lms, bool)
        self.lm_pos = np.zeros((max_lms, 3), np.float32)
        self.lm_desc_u32 = np.zeros((max_lms, 8), np.uint32)
        self.lm_desc_i8 = np.zeros((max_lms, 256), np.int8)
        self.lm_normal = np.zeros((max_lms, 3), np.float32)
        self.lm_min_dist = np.zeros(max_lms, np.float32)
        self.lm_max_dist = np.zeros(max_lms, np.float32)
        self.lm_ref_kf = np.full(max_lms, -1, np.int32)
        self.lm_first_kf = np.full(max_lms, -1, np.int32)
        self.lm_n_visible = np.zeros(max_lms, np.int32)
        self.lm_n_found = np.zeros(max_lms, np.int32)
        self.lm_num_obs = np.zeros(max_lms, np.int32)
        self.lm_obs: List[Optional[Dict[int, int]]] = [None] * max_lms  # kf -> kpt idx
        self.lm_replaced_by = np.full(max_lms, -1, np.int32)
        self.n_lms = 0

        # --- flat observation table: append-only mirror of lm_obs kept in
        # SoA columns so BA packing / covis counting / culling are numpy
        # gathers instead of Python dict loops.
        # u/v/x_right/level are copied at insert time (static per (kf,kpt)).
        self.obs_cap = 1 << 14
        self.obs_lm = np.full(self.obs_cap, -1, np.int32)
        self.obs_kf = np.full(self.obs_cap, -1, np.int32)
        self.obs_kpt = np.zeros(self.obs_cap, np.int32)
        self.obs_u = np.zeros(self.obs_cap, np.float32)
        self.obs_v = np.zeros(self.obs_cap, np.float32)
        self.obs_xr = np.full(self.obs_cap, -1.0, np.float32)
        self.obs_level = np.zeros(self.obs_cap, np.int16)
        self.obs_alive = np.zeros(self.obs_cap, bool)
        self.n_obs_rows = 0            # high-water mark (dead rows included)
        self.n_obs_live = 0
        self._obs_row: Dict[tuple, int] = {}   # (lm, kf) -> row

        # --- covisibility graph / spanning tree / loop edges ---
        self.covis: List[Optional[Dict[int, int]]] = [None] * max_kfs   # kf -> weight
        self.covis_ordered: List[Optional[np.ndarray]] = [None] * max_kfs
        self.parent = np.full(max_kfs, -1, np.int32)
        self.children: List[Optional[Set[int]]] = [None] * max_kfs
        self.loop_edges: List[Optional[Set[int]]] = [None] * max_kfs

        self.origin_kf = -1
        # cull-time pose of erased keyframes relative to their (then-live)
        # spanning-tree parent: kf -> (parent, T_kf_rel_parent).  Frame
        # trajectories are saved relative to their reference keyframe (ref
        # trajectory_io), and a culled reference composes through this
        # chain to a live ancestor (ref keyframe stores T_camera_to_parent
        # at erase time for exactly this purpose)
        self.culled_rel: Dict[int, tuple] = {}
        # monotonically increasing mutation counter: device-side caches
        # (e.g. the tracker's local-map mirror) key on this
        self.version = 0
        # geometry-rewrite counter: bumped ONLY when existing poses/landmark
        # positions move wholesale (global-BA writeback, pose-graph
        # correction, loop Sim3 propagation).  Mapping's unlocked
        # triangulate/fuse device calls snapshot this and DISCARD their
        # results if it moved — triangulations computed against pre-rewrite
        # poses must not be applied to a rewritten map (the r3
        # revalidation-only attempt corrupted async map quality)
        self.geom_version = 0

        # --- camera database (ref data/camera_database): name -> spec dict
        # (serializable; camera_from spec via camera.base factory) plus the
        # camera each keyframe was captured with
        self.cameras: Dict[str, dict] = {}
        self.kf_camera: List[Optional[str]] = [None] * max_kfs
        self.default_camera: Optional[str] = None

    # ------------------------------------------------------------------
    # camera database
    # ------------------------------------------------------------------
    def register_camera(self, name: str, spec: dict,
                        make_default: bool = False) -> str:
        """Register a camera spec; returns the stored name (suffixed on a
        spec-mismatching collision, the multi-session case)."""
        if name in self.cameras and self.cameras[name] != spec:
            base = name
            i = 2
            while name in self.cameras and self.cameras[name] != spec:
                name = f"{base}#{i}"
                i += 1
        self.cameras[name] = spec
        if make_default or self.default_camera is None:
            self.default_camera = name
        return name

    def get_camera(self, name: str):
        """Instantiate the camera object for a registered spec."""
        from ..camera.base import make_camera_from_config
        return make_camera_from_config(self.cameras[name])

    # ------------------------------------------------------------------
    # capacity growth (the map is unbounded: the host SoA doubles
    # amortized-O(1); device-side mirrors are rebuilt per query at their own
    # padding and key on `version`)
    # ------------------------------------------------------------------
    @staticmethod
    def _grown(a: np.ndarray, extra: int, fill=0) -> np.ndarray:
        ext = np.full((extra,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, ext])

    def _ensure_kf_capacity(self, need: int = 1):
        while self.n_kfs + need > self.max_kfs:
            old = self.max_kfs
            self.max_kfs *= 2
            self.kf_valid = self._grown(self.kf_valid, old)
            self.kf_pose_cw = self._grown(self.kf_pose_cw, old)
            self.kf_timestamp = self._grown(self.kf_timestamp, old)
            self.kf_src_frame = self._grown(self.kf_src_frame, old, -1)
            self.parent = self._grown(self.parent, old, -1)
            for name in ("kf_xy", "kf_xy_undist", "kf_bearing", "kf_level",
                         "kf_angle", "kf_desc_u32", "kf_desc_i8",
                         "kf_kpt_valid", "kf_x_right", "kf_depth",
                         "kf_lm_idx", "kf_camera", "covis", "covis_ordered",
                         "children", "loop_edges"):
                getattr(self, name).extend([None] * old)

    def _ensure_lm_capacity(self, need: int = 1):
        while self.n_lms + need > self.max_lms:
            old = self.max_lms
            self.max_lms *= 2
            self.lm_valid = self._grown(self.lm_valid, old)
            self.lm_pos = self._grown(self.lm_pos, old)
            self.lm_desc_u32 = self._grown(self.lm_desc_u32, old)
            self.lm_desc_i8 = self._grown(self.lm_desc_i8, old)
            self.lm_normal = self._grown(self.lm_normal, old)
            self.lm_min_dist = self._grown(self.lm_min_dist, old)
            self.lm_max_dist = self._grown(self.lm_max_dist, old)
            self.lm_ref_kf = self._grown(self.lm_ref_kf, old, -1)
            self.lm_first_kf = self._grown(self.lm_first_kf, old, -1)
            self.lm_n_visible = self._grown(self.lm_n_visible, old)
            self.lm_n_found = self._grown(self.lm_n_found, old)
            self.lm_num_obs = self._grown(self.lm_num_obs, old)
            self.lm_replaced_by = self._grown(self.lm_replaced_by, old, -1)
            self.lm_obs.extend([None] * old)

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------
    def add_keyframe(self, frame) -> int:
        self.version += 1
        self._ensure_kf_capacity()
        kf = self.n_kfs
        self.n_kfs += 1
        self.kf_valid[kf] = True
        self.kf_pose_cw[kf] = frame.pose_cw
        self.kf_timestamp[kf] = frame.timestamp
        self.kf_src_frame[kf] = frame.frame_id
        self.kf_xy[kf] = frame.xy.copy()
        self.kf_xy_undist[kf] = frame.xy_undist.copy()
        self.kf_bearing[kf] = frame.bearing.copy()
        self.kf_level[kf] = frame.level.copy()
        self.kf_angle[kf] = frame.angle.copy()
        self.kf_desc_u32[kf] = frame.desc_u32.copy()
        self.kf_desc_i8[kf] = frame.desc_i8.copy()
        self.kf_kpt_valid[kf] = frame.valid.copy()
        self.kf_x_right[kf] = frame.x_right.copy()
        self.kf_depth[kf] = frame.depth.copy()
        self.kf_lm_idx[kf] = np.full(self.K, -1, np.int32)
        self.kf_camera[kf] = self.default_camera
        self.covis[kf] = {}
        self.covis_ordered[kf] = np.zeros(0, np.int32)
        self.children[kf] = set()
        self.loop_edges[kf] = set()
        if self.origin_kf < 0:
            self.origin_kf = kf
        return kf

    def erase_keyframe(self, kf: int):
        self.version += 1
        """Remove a redundant keyframe, repairing the spanning tree
        (ref keyframe::erase: children reassigned to best candidate parents)."""
        if kf == self.origin_kf or not self.kf_valid[kf]:
            return
        # remove observations
        lm_arr = self.kf_lm_idx[kf]
        for idx in np.where(lm_arr >= 0)[0]:
            self.erase_observation(int(lm_arr[idx]), kf)
        # remove covisibility both ways
        for nb in list(self.covis[kf].keys()):
            self.covis[nb].pop(kf, None)
            self._reorder_covis(nb)
        # spanning-tree repair: candidates = parent + children's covisibles
        parent = int(self.parent[kf])
        children = set(self.children[kf])
        if parent >= 0:
            self.children[parent].discard(kf)
        candidates = {parent} if parent >= 0 else set()
        while children:
            best = None
            for ch in children:
                for cand in candidates:
                    w = self.covis[ch].get(cand, 0)
                    if w > 0 and (best is None or w > best[0]):
                        best = (w, ch, cand)
            if best is None:
                break
            _, ch, cand = best
            self.parent[ch] = cand
            self.children[cand].add(ch)
            candidates.add(ch)
            children.discard(ch)
        for ch in children:  # orphans -> attach to removed KF's parent
            self.parent[ch] = parent
            if parent >= 0:
                self.children[parent].add(ch)
        # record the cull-time pose relative to the parent so frame
        # trajectories referenced to this keyframe can compose through the
        # spanning tree at save time (see culled_rel above)
        if parent >= 0 and self.kf_valid[parent]:
            rel = self.kf_pose_cw[kf] @ np.linalg.inv(self.kf_pose_cw[parent])
            self.culled_rel[kf] = (parent, rel.astype(np.float32))
        self.kf_valid[kf] = False
        self.covis[kf] = {}
        self.covis_ordered[kf] = np.zeros(0, np.int32)

    def valid_kf_ids(self) -> np.ndarray:
        return np.where(self.kf_valid[: self.n_kfs])[0]

    # ------------------------------------------------------------------
    # landmarks
    # ------------------------------------------------------------------
    def add_landmark(self, pos, desc_u32, desc_i8, ref_kf: int) -> int:
        self.version += 1
        self._ensure_lm_capacity()
        lm = self.n_lms
        self.n_lms += 1
        self.lm_valid[lm] = True
        self.lm_pos[lm] = pos
        self.lm_desc_u32[lm] = desc_u32
        self.lm_desc_i8[lm] = desc_i8
        self.lm_ref_kf[lm] = ref_kf
        self.lm_first_kf[lm] = ref_kf
        self.lm_n_visible[lm] = 1
        self.lm_n_found[lm] = 1
        self.lm_obs[lm] = {}
        return lm

    # --- flat observation table maintenance ------------------------------
    def _obs_grow_or_compact(self):
        if self.n_obs_live < (self.obs_cap * 3) // 4:
            rows = np.where(self.obs_alive[: self.n_obs_rows])[0]
            n = len(rows)
            for nm in ("obs_lm", "obs_kf", "obs_kpt", "obs_u", "obs_v",
                       "obs_xr", "obs_level", "obs_alive"):
                a = getattr(self, nm)
                a[:n] = a[rows]
                a[n:] = False if a.dtype == bool else (
                    -1 if nm in ("obs_lm", "obs_kf") else 0)
            self.n_obs_rows = n
            self.n_obs_live = n
            self._obs_row = {
                (int(l), int(k)): i
                for i, (l, k) in enumerate(
                    zip(self.obs_lm[:n], self.obs_kf[:n]))
            }
        else:
            old = self.obs_cap
            self.obs_cap *= 2
            self.obs_lm = self._grown(self.obs_lm, old, -1)
            self.obs_kf = self._grown(self.obs_kf, old, -1)
            self.obs_kpt = self._grown(self.obs_kpt, old)
            self.obs_u = self._grown(self.obs_u, old)
            self.obs_v = self._grown(self.obs_v, old)
            self.obs_xr = self._grown(self.obs_xr, old, -1.0)
            self.obs_level = self._grown(self.obs_level, old)
            self.obs_alive = self._grown(self.obs_alive, old, False)

    def _obs_append(self, lm: int, kf: int, kpt: int):
        if self.n_obs_rows >= self.obs_cap:
            self._obs_grow_or_compact()
        r = self.n_obs_rows
        self.n_obs_rows += 1
        self.n_obs_live += 1
        self.obs_lm[r] = lm
        self.obs_kf[r] = kf
        self.obs_kpt[r] = kpt
        self.obs_u[r], self.obs_v[r] = self.kf_xy_undist[kf][kpt]
        xr = self.kf_x_right[kf]
        self.obs_xr[r] = xr[kpt] if xr is not None else -1.0
        self.obs_level[r] = self.kf_level[kf][kpt]
        self.obs_alive[r] = True
        self._obs_row[(lm, kf)] = r

    def _obs_drop(self, lm: int, kf: int):
        r = self._obs_row.pop((lm, kf), None)
        if r is not None:
            self.obs_alive[r] = False
            self.obs_lm[r] = -1
            self.obs_kf[r] = -1
            self.n_obs_live -= 1

    def observation_rows(self):
        """Live slice views (lm, kf, kpt, u, v, x_right, level) of the flat
        table up to the high-water mark; mask with ``obs_lm >= 0``."""
        n = self.n_obs_rows
        return (self.obs_lm[:n], self.obs_kf[:n], self.obs_kpt[:n],
                self.obs_u[:n], self.obs_v[:n], self.obs_xr[:n],
                self.obs_level[:n])

    def add_observation(self, lm: int, kf: int, kpt_idx: int):
        if not self.lm_valid[lm]:
            return
        obs = self.lm_obs[lm]
        if kf in obs:
            return
        obs[kf] = int(kpt_idx)
        self.kf_lm_idx[kf][kpt_idx] = lm
        self.lm_num_obs[lm] = len(obs)
        self._obs_append(int(lm), int(kf), int(kpt_idx))

    def erase_observation(self, lm: int, kf: int):
        obs = self.lm_obs[lm]
        if obs is None or kf not in obs:
            return
        idx = obs.pop(kf)
        self._obs_drop(int(lm), int(kf))
        if self.kf_lm_idx[kf] is not None and self.kf_lm_idx[kf][idx] == lm:
            self.kf_lm_idx[kf][idx] = -1
        self.lm_num_obs[lm] = len(obs)
        if self.lm_ref_kf[lm] == kf and obs:
            self.lm_ref_kf[lm] = next(iter(obs))
        if len(obs) <= 1 and self.lm_valid[lm]:
            self.erase_landmark(lm)

    def erase_landmark(self, lm: int):
        self.version += 1
        if not self.lm_valid[lm]:
            return
        self.lm_valid[lm] = False
        for kf, idx in list((self.lm_obs[lm] or {}).items()):
            self._obs_drop(int(lm), int(kf))
            if self.kf_lm_idx[kf] is not None and self.kf_lm_idx[kf][idx] == lm:
                self.kf_lm_idx[kf][idx] = -1
        self.lm_obs[lm] = {}
        self.lm_num_obs[lm] = 0

    def replace_landmark(self, old: int, new: int):
        self.version += 1
        """Merge `old` into `new` (ref landmark::replace)."""
        if old == new or not self.lm_valid[old]:
            return
        for kf, idx in list((self.lm_obs[old] or {}).items()):
            self._obs_drop(int(old), int(kf))
            self.kf_lm_idx[kf][idx] = -1
            if kf not in (self.lm_obs[new] or {}):
                self.add_observation(new, kf, idx)
            # else: duplicate observation — drop it
        self.lm_n_visible[new] += self.lm_n_visible[old]
        self.lm_n_found[new] += self.lm_n_found[old]
        self.lm_valid[old] = False
        self.lm_obs[old] = {}
        self.lm_num_obs[old] = 0
        self.lm_replaced_by[old] = new

    def resolve_replaced(self, lm: int) -> int:
        """Follow replacement chain (tracking uses this to refresh last-frame ptrs)."""
        seen = 0
        while lm >= 0 and not self.lm_valid[lm] and self.lm_replaced_by[lm] >= 0 and seen < 16:
            lm = int(self.lm_replaced_by[lm])
            seen += 1
        return lm if lm >= 0 and self.lm_valid[lm] else -1

    def update_landmark_descriptor(self, lm: int):
        """Representative descriptor = min median Hamming to the others
        (the port's native popcount kernel, csrc/map_core.cpp)."""
        obs = self.lm_obs[lm]
        if not obs:
            return
        descs = np.stack([self.kf_desc_u32[kf][idx] for kf, idx in obs.items()])
        if len(descs) == 1:
            best = 0
        else:
            from ..utils import native
            best = native.min_median_hamming(descs)
        kf, idx = list(obs.items())[best]
        self.lm_desc_u32[lm] = self.kf_desc_u32[kf][idx]
        self.lm_desc_i8[lm] = self.kf_desc_i8[kf][idx]

    def update_landmark_geometry(self, lm: int, scale_factor: float, num_levels: int):
        """Mean viewing direction + scale-invariance distance range
        (ref landmark::update_normal_and_depth)."""
        obs = self.lm_obs[lm]
        if not obs:
            return
        pos = self.lm_pos[lm]
        normals = []
        for kf in obs:
            T = self.kf_pose_cw[kf]
            c = -T[:3, :3].T @ T[:3, 3]
            v = pos - c
            n = np.linalg.norm(v)
            if n > 1e-9:
                normals.append(v / n)
        if normals:
            m = np.mean(normals, 0)
            nm = np.linalg.norm(m)
            self.lm_normal[lm] = m / max(nm, 1e-9)
        ref = int(self.lm_ref_kf[lm])
        if ref >= 0 and ref in obs:
            T = self.kf_pose_cw[ref]
            c = -T[:3, :3].T @ T[:3, 3]
            dist = float(np.linalg.norm(pos - c))
            level = int(self.kf_level[ref][obs[ref]])
            sf = scale_factor**level
            self.lm_max_dist[lm] = dist * sf
            self.lm_min_dist[lm] = dist * sf / (scale_factor ** (num_levels - 1))

    def update_landmark_geometry_batch(self, lms, scale_factor: float,
                                       num_levels: int):
        """Vectorized ``update_landmark_geometry`` over many landmarks: one
        pass over the flat observation table computes every mean viewing
        direction and scale-invariance range (was one Python call per
        landmark on the keyframe-insertion path)."""
        lms = np.unique(np.asarray(lms, np.int64))
        lms = lms[(lms >= 0) & self.lm_valid[lms]]
        if len(lms) == 0:
            return
        sel = np.zeros(self.n_lms, bool)
        sel[lms] = True
        n = self.n_obs_rows
        t_lm = self.obs_lm[:n]
        rows = np.where((t_lm >= 0) & sel[np.clip(t_lm, 0, self.n_lms - 1)])[0]
        if len(rows) == 0:
            return
        lmr = t_lm[rows].astype(np.int64)
        kfr = self.obs_kf[:n][rows]
        Tr = self.kf_pose_cw[kfr]
        c = -np.einsum("nji,nj->ni", Tr[:, :3, :3], Tr[:, :3, 3])
        v = self.lm_pos[lmr] - c
        nv = np.linalg.norm(v, axis=1)
        good = nv > 1e-9
        v_unit = np.where(good[:, None], v / np.maximum(nv, 1e-9)[:, None], 0)
        idx = np.searchsorted(lms, lmr)
        acc = np.zeros((len(lms), 3), np.float64)
        np.add.at(acc, idx[good], v_unit[good])
        an = np.linalg.norm(acc, axis=1)
        has = an > 1e-9
        self.lm_normal[lms[has]] = (
            acc[has] / an[has, None]).astype(np.float32)
        # scale range from the reference-KF observation
        is_ref = kfr == self.lm_ref_kf[lmr]
        if is_ref.any():
            rl = lmr[is_ref]
            dist = nv[is_ref]
            lvl = self.obs_level[:n][rows][is_ref].astype(np.float64)
            sf = scale_factor ** lvl
            self.lm_max_dist[rl] = (dist * sf).astype(np.float32)
            self.lm_min_dist[rl] = (
                dist * sf / scale_factor ** (num_levels - 1)
            ).astype(np.float32)

    def valid_lm_ids(self) -> np.ndarray:
        return np.where(self.lm_valid[: self.n_lms])[0]

    # ------------------------------------------------------------------
    # covisibility graph + spanning tree
    # ------------------------------------------------------------------
    def _reorder_covis(self, kf: int):
        items = [(w, nb) for nb, w in self.covis[kf].items()]
        items.sort(reverse=True)
        self.covis_ordered[kf] = np.array([nb for _, nb in items], np.int32)

    def update_connections(self, kf: int, set_parent: bool = True):
        """Recount shared landmarks with other KFs (ref graph_node::update_connections)."""
        counts: Dict[int, int] = {}
        lm_arr = self.kf_lm_idx[kf]
        for idx in np.where(lm_arr >= 0)[0]:
            lm = int(lm_arr[idx])
            if not self.lm_valid[lm]:
                continue
            for other in self.lm_obs[lm]:
                if other != kf:
                    counts[other] = counts.get(other, 0) + 1
        if not counts:
            self.covis[kf] = {}
            self.covis_ordered[kf] = np.zeros(0, np.int32)
            return
        best_nb = max(counts, key=counts.get)
        kept = {nb: w for nb, w in counts.items() if w >= COVIS_WEIGHT_THR}
        if not kept:
            kept = {best_nb: counts[best_nb]}
        # clear old reciprocal edges no longer kept
        for nb in list(self.covis[kf].keys()):
            if nb not in kept:
                self.covis[nb].pop(kf, None)
                self._reorder_covis(nb)
        self.covis[kf] = dict(kept)
        self._reorder_covis(kf)
        for nb, w in kept.items():
            self.covis[nb][kf] = w
            self._reorder_covis(nb)
        if set_parent and self.parent[kf] < 0 and kf != self.origin_kf:
            self.parent[kf] = best_nb
            self.children[best_nb].add(kf)

    def get_top_covisible(self, kf: int, n: int) -> List[int]:
        order = self.covis_ordered[kf]
        return [int(x) for x in order[:n] if self.kf_valid[x]]

    def add_loop_edge(self, a: int, b: int):
        self.loop_edges[a].add(b)
        self.loop_edges[b].add(a)

    # ------------------------------------------------------------------
    # multi-session merge
    # ------------------------------------------------------------------
    def absorb(self, other: "MapDatabase"):
        """Copy every valid keyframe/landmark of `other` into this database
        (observations, covisibility, spanning tree preserved; ids remapped).

        The absorbed sub-map keeps its own coordinate frame — loop-closure
        machinery (Sim3 validation + correction) is what aligns it.  Returns
        (kf_map, lm_map): old id -> new id.
        """
        assert other.K == self.K
        kf_map: Dict[int, int] = {}
        lm_map: Dict[int, int] = {}
        for kf in other.valid_kf_ids():
            kf = int(kf)
            self._ensure_kf_capacity()
            new = self.n_kfs
            self.n_kfs += 1
            self.kf_valid[new] = True
            self.kf_pose_cw[new] = other.kf_pose_cw[kf]
            self.kf_timestamp[new] = other.kf_timestamp[kf]
            self.kf_src_frame[new] = other.kf_src_frame[kf]
            for col in ("kf_xy", "kf_xy_undist", "kf_bearing", "kf_level",
                        "kf_angle", "kf_desc_u32", "kf_desc_i8",
                        "kf_kpt_valid", "kf_x_right", "kf_depth"):
                getattr(self, col)[new] = getattr(other, col)[kf].copy()
            self.kf_lm_idx[new] = np.full(self.K, -1, np.int32)
            self.covis[new] = {}
            self.covis_ordered[new] = np.zeros(0, np.int32)
            self.children[new] = set()
            self.loop_edges[new] = set()
            kf_map[kf] = new
        # merge camera registries; remap per-KF camera names
        cam_name_map: Dict[str, str] = {}
        for cname, spec in other.cameras.items():
            cam_name_map[cname] = self.register_camera(cname, spec)
        for old_kf, new_kf in kf_map.items():
            cn = other.kf_camera[old_kf]
            self.kf_camera[new_kf] = cam_name_map.get(cn, cn)
        for lm in other.valid_lm_ids():
            lm = int(lm)
            ref = other.lm_ref_kf[lm]
            new = self.add_landmark(
                other.lm_pos[lm], other.lm_desc_u32[lm], other.lm_desc_i8[lm],
                kf_map.get(int(ref), -1),
            )
            self.lm_normal[new] = other.lm_normal[lm]
            self.lm_min_dist[new] = other.lm_min_dist[lm]
            self.lm_max_dist[new] = other.lm_max_dist[lm]
            self.lm_n_visible[new] = other.lm_n_visible[lm]
            self.lm_n_found[new] = other.lm_n_found[lm]
            lm_map[lm] = new
            for kf, idx in (other.lm_obs[lm] or {}).items():
                if kf in kf_map:
                    self.add_observation(new, kf_map[kf], idx)
        for old_kf, new_kf in kf_map.items():
            p = int(other.parent[old_kf])
            if p in kf_map:
                self.parent[new_kf] = kf_map[p]
                self.children[kf_map[p]].add(new_kf)
            self.update_connections(new_kf, set_parent=False)
        return kf_map, lm_map

    # ------------------------------------------------------------------
    # local map acquisition (ref module/local_map_updater)
    # ------------------------------------------------------------------
    def acquire_local_map(self, seed_lms: np.ndarray, max_kfs: int = 60):
        """KFs sharing landmarks with the seed set + their neighbors/parent/
        children (capped), and the union of their landmarks."""
        counts: Dict[int, int] = {}
        for lm in seed_lms:
            lm = int(lm)
            if lm < 0 or not self.lm_valid[lm]:
                continue
            for kf in self.lm_obs[lm]:
                if self.kf_valid[kf]:
                    counts[kf] = counts.get(kf, 0) + 1
        if not counts:
            return [], np.zeros(0, np.int64)
        base = sorted(counts, key=counts.get, reverse=True)
        local_kfs: List[int] = []
        seen = set()
        for kf in base:
            if len(local_kfs) >= max_kfs:
                break
            if kf not in seen:
                local_kfs.append(kf)
                seen.add(kf)
        for kf in list(local_kfs):
            if len(local_kfs) >= max_kfs:
                break
            extras = self.get_top_covisible(kf, 10)
            p = int(self.parent[kf])
            if p >= 0:
                extras.append(p)
            extras.extend(self.children[kf])
            for e in extras:
                if e not in seen and self.kf_valid[e]:
                    local_kfs.append(e)
                    seen.add(e)
                    if len(local_kfs) >= max_kfs:
                        break
        lm_set: Set[int] = set()
        for kf in local_kfs:
            arr = self.kf_lm_idx[kf]
            for lm in arr[arr >= 0]:
                if self.lm_valid[lm]:
                    lm_set.add(int(lm))
        return local_kfs, np.fromiter(lm_set, np.int64, len(lm_set))
