"""The JAX System at chip_smoke's stereo and RGB-D working points, on the CPU.

Takes each point from ``chip_smoke.py``'s one definition and feeds the
same rendered frames to ``openvslam_tpu.system.System``, as chip_smoke
drives the port, and prints one JSON line per point:

* ``7c`` (``STEREO_LOOP_POINT``, ``stereo_loop_config_dict``,
  ``stereo_loop_scene``: tests/test_stereo_loop.py's octagon room and
  200-frame lap at 320x240, a 0.25 m baseline, synchronous mapping, frame
  by frame): first tracked frame, tracked share, loops closed, the Sim(3)
  scale of each correction, and the keyframe ATE(se3) that
  ``chip_smoke.STEREO_LOOP_REF_KF_ATE_M`` records (about 5 minutes);
* ``7`` (``kitti_config_dict``, ``stereo_pairs``: KITTI 00's stereo
  configuration over phase 7's 120 pairs along the wall) with async
  mapping through ``feed_sequence(kind="stereo", depth=3)``;
* ``7b`` (``tum_config_dict``: TUM fr1's RGB-D configuration over phase
  7b's 120 frames, uint16 depth maps) through ``feed_sequence(kind="rgbd",
  depth=3)``.

For 7 and 7b: tracked share, ATE(se3) and the frames whose camera centre
lies more than 5 cm from the ground truth (the map's origin is frame 0's
camera).

    JAX_PLATFORMS=cpu python tools/depth_points_jax.py 7c
    JAX_PLATFORMS=cpu python tools/depth_points_jax.py 7 7b
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from openvslam_tpu.config import Config  # noqa: E402
from openvslam_tpu.system import System  # noqa: E402
from openvslam_tpu.utils import evaluate, synthetic  # noqa: E402


def stereo_loop() -> dict:
    cfg = Config.from_dict(chip_smoke.stereo_loop_config_dict())
    cam = cfg.camera
    scene, gt, shift = chip_smoke.stereo_loop_scene(synthetic, cam)
    s = System(cfg, vocab_path="default")
    go = s.global_optimizer
    scales, correct = [], go.correct_loop

    def spy_correct(kf, cand, g, *a, **kw):
        scales.append(float(g[2]))
        return correct(kf, cand, g, *a, **kw)

    go.correct_loop = spy_correct
    s.startup()
    t0 = time.time()
    tracked = np.array([s.feed_stereo_frame(scene.render(cam, gt[i]),
                                            scene.render(cam, shift @ gt[i]), i / 20.0)
                        is not None for i in range(len(gt))])
    first = int(np.argmax(tracked))
    out = {"point": "7c", "rows": cam.rows, "cols": cam.cols, "frames": len(gt), "first": first,
           "tracked": float(tracked[first:].mean()), "loops_closed": go.num_loops_closed,
           "correction_scales": scales,
           "kf_ate_se3": chip_smoke.keyframe_ate(s.map_db, gt, evaluate, align="se3"),
           "keyframes": int(len(s.map_db.valid_kf_ids())), "seconds": time.time() - t0}
    s.shutdown()
    return out


def wall_point(point: str) -> dict:
    from openvslam_tpu_torch.config import Config as PortConfig

    if point == "7":
        cfg_dict, kind, async_mapping = chip_smoke.kitti_config_dict(), "stereo", True
        pairs, gt = chip_smoke.stereo_pairs(PortConfig.from_dict(cfg_dict).camera)
        items = [(a, b, i / 10.0) for i, (a, b) in enumerate(pairs)]
    else:
        cfg_dict, kind, async_mapping = chip_smoke.tum_config_dict(), "rgbd", False
        cam = PortConfig.from_dict(cfg_dict).camera
        items, gt = chip_smoke.rgbd_frames(cam)
    cfg = Config.from_dict(cfg_dict)
    s = System(cfg, vocab_path="default", async_mapping=async_mapping)
    s.startup()
    t0 = time.time()
    poses = [p for _, p in s.feed_sequence(iter(items), kind=kind, depth=3)]
    s.shutdown()
    T0 = gt[0]
    err = [None if p is None else float(np.linalg.norm(
        -p[:3, :3].T @ p[:3, 3] - (T0[:3, :3] @ (-g[:3, :3].T @ g[:3, 3]) + T0[:3, 3])))
        for p, g in zip(poses, gt)]
    return {"point": point, "frames": len(gt), "async_mapping": async_mapping, "depth": 3,
            "tracked": float(np.mean([p is not None for p in poses])),
            "ate_se3": chip_smoke.se3_ate(poses, gt, evaluate),
            "frames_off_by_5cm": [(i, round(e, 3)) for i, e in enumerate(err)
                                  if e is not None and e > 0.05],
            "fused_share": s._fused_frames / len(gt), "seconds": time.time() - t0}


if __name__ == "__main__":
    for point in sys.argv[1:] or ["7c"]:
        print(json.dumps(stereo_loop() if point == "7c" else wall_point(point)), flush=True)
