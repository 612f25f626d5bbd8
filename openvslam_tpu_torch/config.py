"""YAML configuration, schema-compatible with the reference (ref ``config.h/.cc``);
a copy of ``openvslam_tpu/config.py`` that builds the port's camera.

The reference parses a nested YAML with ``Camera:``, ``Feature:``, and
optional ``Mapping:``/``Tracking:``/``LoopDetector:``/``StereoRectifier:``
sections.  We accept both the nested form and dotted-flat keys
(``Camera.fx: ...``) so reference configs run unchanged.  PyYAML is imported
only by ``Config.from_yaml``: ``Config.from_dict`` needs nothing beyond the
standard library.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .camera.base import make_camera_from_config
from .types import Limits


def _unflatten(d: Dict[str, Any]) -> Dict[str, Any]:
    """Turn {'Camera.fx': v} into {'Camera': {'fx': v}} (merging with nested)."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if "." in k:
            head, rest = k.split(".", 1)
            out.setdefault(head, {})
            if isinstance(out[head], dict):
                out[head][rest] = v
        else:
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k].update(v)
            else:
                out[k] = v
    # one more pass for nested dotted keys
    for k, v in list(out.items()):
        if isinstance(v, dict) and any("." in kk for kk in v):
            out[k] = _unflatten(v)
    return out


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    max_num_keypts: int = 2000
    scale_factor: float = 1.2
    num_levels: int = 8
    ini_fast_threshold: int = 20
    min_fast_threshold: int = 7
    # rBRIEF test pattern: "learned" (our re-learned pattern) or "cv" (the
    # reference's bit_pattern_31, recovered from the OpenCV oracle — use for
    # descriptor-level interop with maps/vocabs made by the reference)
    descriptor_pattern: str = "learned"
    # rectangular mask zones: list of [y0, y1, x0, x1] ratios (reference schema)
    mask_rectangles: tuple = ()


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    reloc_distance_threshold: float = 0.2
    reloc_angle_threshold: float = 0.45
    enable_auto_relocalization: bool = True


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    baseline_dist_thr_ratio: float = 0.02
    redundant_obs_ratio_thr: float = 0.9
    num_covisibilities_for_landmark_generation: int = 10
    num_covisibilities_for_landmark_fusion: int = 10
    # stereo/RGBD depth seeding: per-grid-cell budget of total coverage
    # (tracked landmarks + new seeds, closest-depth first).  The leading
    # edge (unmapped cells) keeps its dense seeds — that density is what
    # holds fast forward motion (r3: a global cap collapsed the stress run
    # 0.775 -> 0.12 tracked) — while already-covered cells stop re-seeding
    # doomed duplicates (r4: 92% of created landmarks culled).  <= 0 (the
    # default) disables the gate: opt in per config (tools/city_bench.py
    # --seed-budget) until the long-course A/B justifies flipping it.
    seed_cell_budget: int = 0
    seed_grid: tuple = (6, 8)          # (rows, cols) coverage cells
    # danger bypass for the cell gate: when the keyframe tracks fewer than
    # this many CLOSE landmarks, seed uncapped (the reference's global
    # seed-while-<100-close rule, used here as a safety floor: the r5 A/B
    # showed a hard cell cap starves the leading edge exactly when inlier
    # counts dip — city lost at frame ~910 with budget 8, tracked clean
    # uncapped)
    seed_close_floor: int = 100


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    enabled: bool = True
    min_continuity: int = 3
    min_num_bow_matches: int = 20
    min_num_valid_obs: int = 40  # inlier gate after Sim3 optimize
    top_n_covisibilities_to_search: int = 10


@dataclasses.dataclass(frozen=True)
class Config:
    camera: Any
    feature: FeatureConfig
    tracking: TrackingConfig
    mapping: MappingConfig
    loop: LoopConfig
    limits: Limits
    depthmap_factor: float
    raw: Dict[str, Any]

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        d = _unflatten(dict(raw))
        cam_cfg = d.get("Camera", {})
        camera = make_camera_from_config(cam_cfg)

        feat = d.get("Feature", {})
        feature = FeatureConfig(
            max_num_keypts=int(feat.get("max_num_keypts", 2000)),
            scale_factor=float(feat.get("scale_factor", 1.2)),
            num_levels=int(feat.get("num_levels", 8)),
            ini_fast_threshold=int(feat.get("ini_fast_threshold", 20)),
            min_fast_threshold=int(feat.get("min_fast_threshold", 7)),
            descriptor_pattern=str(feat.get("descriptor_pattern", "learned")),
            mask_rectangles=tuple(tuple(r) for r in feat.get("mask_rectangles", [])),
        )
        trk = d.get("Tracking", {})
        tracking = TrackingConfig(
            reloc_distance_threshold=float(trk.get("reloc_distance_threshold", 0.2)),
            reloc_angle_threshold=float(trk.get("reloc_angle_threshold", 0.45)),
            enable_auto_relocalization=bool(trk.get("enable_auto_relocalization", True)),
        )
        mp = d.get("Mapping", {})
        mapping = MappingConfig(
            baseline_dist_thr_ratio=float(mp.get("baseline_dist_thr_ratio", 0.02)),
            redundant_obs_ratio_thr=float(mp.get("redundant_obs_ratio_thr", 0.9)),
            seed_cell_budget=int(mp.get("seed_cell_budget", 0)),
            seed_close_floor=int(mp.get("seed_close_floor", 100)),
        )
        lp = d.get("LoopDetector", {})
        loop = LoopConfig(
            enabled=bool(lp.get("enabled", True)),
            min_continuity=int(lp.get("min_continuity", 3)),
        )
        # capacity planning: round keypoint capacity up to a lane multiple
        mk = max(256, ((feature.max_num_keypts * 2 + 255) // 256) * 256)
        limits = Limits(
            max_keypts=mk,
            num_levels=feature.num_levels,
            scale_factor=feature.scale_factor,
        )
        depthmap_factor = float(cam_cfg.get("depthmap_factor", 1.0))
        return cls(camera, feature, tracking, mapping, loop, limits, depthmap_factor, d)
