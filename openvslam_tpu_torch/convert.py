"""Carry the JAX package's parameters and state across to the port.

Every function takes plain dicts and numpy arrays (what ``np.asarray`` of a
JAX array gives), so nothing here imports JAX.
"""
from __future__ import annotations

import copy
from typing import Any, Mapping

import numpy as np
import torch

from .camera.base import make_camera_from_config
from .data.bow import BowDatabase
from .data.map_database import MapDatabase
from .device import resolve_device
from .models.frontend import OrbFrontend
from .models.track_step import LastFrame, LocalMap
from .ops.orb import pack_bits


def camera_from_config(spec: Mapping[str, Any]):
    """A camera from the spec dict of ``openvslam_tpu.camera.base.camera_to_config``
    (or the reference's ``Camera:`` section)."""
    return make_camera_from_config(spec)


def frontend_from_config(rows: int, cols: int, feature: Mapping[str, Any],
                         device="cuda") -> OrbFrontend:
    """An OrbFrontend from the reference's ``Feature:`` settings (the keys of
    ``openvslam_tpu.config.FeatureConfig``)."""
    return OrbFrontend(
        rows=rows, cols=cols,
        max_keypts=int(feature.get("max_num_keypts", 2000)),
        num_levels=int(feature.get("num_levels", 8)),
        scale_factor=float(feature.get("scale_factor", 1.2)),
        ini_fast_thr=float(feature.get("ini_fast_threshold", 20)),
        min_fast_thr=float(feature.get("min_fast_threshold", 7)),
        pattern=str(feature.get("descriptor_pattern", "learned")),
        device=device)


def packed_descriptors(desc, device) -> torch.Tensor:
    """(N,256) {0,1} bits or (N,8) uint32 words -> (N,8) packed int32 on device."""
    desc = np.asarray(desc)
    if desc.ndim == 2 and desc.shape[1] == 256:
        return pack_bits(torch.from_numpy(desc.astype(np.int64))).to(device)
    if desc.ndim == 2 and desc.shape[1] == 8:
        return torch.from_numpy(np.ascontiguousarray(desc).astype(np.uint32).view(np.int32)).to(device)
    raise ValueError(f"descriptors must be (N,256) bits or (N,8) words, got {desc.shape}")


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def last_frame_from_numpy(prev_pos, prev_desc_u32, prev_valid, prev_level,
                          device="cuda") -> LastFrame:
    """TrackStep's last-frame table (``prev_*`` operands of the JAX step)."""
    dev = resolve_device(device)
    return LastFrame(pos=_t(prev_pos, torch.float32, dev),
                     desc_u32=packed_descriptors(prev_desc_u32, dev),
                     valid=_t(prev_valid, torch.bool, dev),
                     level=_t(prev_level, torch.int64, dev))


def local_map_from_numpy(loc_pos, loc_desc, loc_valid, loc_maxd, loc_prev_slot,
                         device="cuda") -> LocalMap:
    """TrackStep's local-map table (``loc_*`` operands of the JAX step);
    ``loc_desc`` may be (L,256) bits, as the JAX step takes it, or packed."""
    dev = resolve_device(device)
    return LocalMap(pos=_t(loc_pos, torch.float32, dev),
                    desc_u32=packed_descriptors(loc_desc, dev),
                    valid=_t(loc_valid, torch.bool, dev),
                    max_dist=_t(loc_maxd, torch.float32, dev),
                    prev_slot=_t(loc_prev_slot, torch.int64, dev))


def map_state(db) -> dict:
    """Every column and table of a map database (the JAX package's or the
    port's: both are numpy with the same attribute names) as a dict of
    deep copies: keyframe, landmark and observation tables, covisibility
    graph, spanning tree, camera registry and counters."""
    return copy.deepcopy(dict(vars(db)))


def map_database_from_state(state: Mapping[str, Any]) -> MapDatabase:
    """The port's MapDatabase holding ``state`` (see ``map_state``).  Raises
    if the state's attributes are not exactly those of the port's class."""
    db = MapDatabase(kpt_capacity=int(state["K"]), max_kfs=1, max_lms=1)
    missing = set(vars(db)) - set(state)
    extra = set(state) - set(vars(db))
    if missing or extra:
        raise ValueError(f"map state does not fit the port's MapDatabase: missing "
                         f"{sorted(missing)}, unknown {sorted(extra)}")
    for k, v in state.items():
        setattr(db, k, copy.deepcopy(v))
    return db


def bow_state(bow_db) -> dict:
    """A BoW database's contents (the JAX package's or the port's): the
    per-keyframe word ids and tf-idf vectors and the inverted index's
    postings, as deep copies."""
    inv = bow_db.inverted
    return {"kf_words": copy.deepcopy(dict(bow_db.kf_words)),
            "kf_bow": copy.deepcopy(dict(bow_db.kf_bow)),
            "inverted": {k: copy.deepcopy(getattr(inv, k))
                         for k in ("num_words", "_w", "_kf", "_alive", "_n", "_kf_rows")}}


def bow_database_from_state(state: Mapping[str, Any], vocab, map_db, device="cpu") -> BowDatabase:
    """The port's BowDatabase over ``vocab`` and ``map_db`` holding ``state``
    (see ``bow_state``)."""
    bow_db = BowDatabase(vocab, map_db, device=resolve_device(device))
    if int(state["inverted"]["num_words"]) != vocab.num_words:
        raise ValueError(f"BoW state has {state['inverted']['num_words']} words, "
                         f"the vocabulary {vocab.num_words}")
    bow_db.kf_words = copy.deepcopy(dict(state["kf_words"]))
    bow_db.kf_bow = copy.deepcopy(dict(state["kf_bow"]))
    for k, v in state["inverted"].items():
        setattr(bow_db.inverted, k, copy.deepcopy(v))
    bow_db.inverted._csr = None
    return bow_db
