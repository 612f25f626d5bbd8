"""The JAX System at chip_smoke's fisheye and equirectangular working points, on the CPU.

Takes each point from ``chip_smoke.py``'s one definition and feeds the
same rendered frames to ``openvslam_tpu.system.System`` with synchronous
mapping, frame by frame, as ``chip_smoke.camera_phase`` drives the port,
and prints one JSON line per point:

* ``8`` (``fisheye_config_dict``: TUM VI's 512x512 equidistant cam0, 1000
  keypoints, 8 levels);
* ``8b`` (``equirect_config_dict``: the RICOH THETA S 1920x960
  equirectangular camera, 2000 keypoints, 8 levels);

both on ``camera_scene``: phase 6's octagon room and the first
``CAMERA_FRAMES`` (8) or ``EQUIRECT_FRAMES`` (8b) frames of its lap, loop
detection on.  Each line holds
the first tracked frame, the tracked share after it, the ATE(sim3) of the
System's tracked trajectory (``tracked_poses``) and of its keyframes, the
fused-step frames, the keyframes and the loops closed.  The tracked share
and the trajectory ATE are the readings that chip_smoke's
``FISHEYE_REF`` and ``EQUIRECT_REF`` record.  ``--key K`` seeds the JAX
tracker's bootstrap draws with ``jax.random.PRNGKey(K)`` instead of its
own key 42: which draws bootstrap the map is part of a point's
run-to-run spread.  About 25 minutes for 8 and 30 for 8b (60 frames) on 3 cores.

    JAX_PLATFORMS=cpu python tools/camera_points_jax.py 8
    JAX_PLATFORMS=cpu python tools/camera_points_jax.py 8b
    JAX_PLATFORMS=cpu python tools/camera_points_jax.py 8 --key 1
"""
import argparse
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

POINTS = {"8": chip_smoke.fisheye_config_dict, "8b": chip_smoke.equirect_config_dict}


def camera_point(point: str, key=None) -> dict:
    cfg = Config.from_dict(POINTS[point]())
    cam = cfg.camera
    scene, gt = chip_smoke.camera_scene(synthetic, cam)
    t0 = time.time()
    frames = [scene.render(cam, T) for T in gt]
    render_s = time.time() - t0
    s = System(cfg, vocab_path="default")
    if key is not None:
        import jax

        s.tracker.key = jax.random.PRNGKey(key)
    s.startup()
    t0 = time.time()
    tracked = np.array([s.feed_monocular_frame(im, i / cam.fps) is not None
                        for i, im in enumerate(frames)])
    seconds = time.time() - t0
    _, poses, mask = s.tracked_poses()
    first = int(np.argmax(tracked)) if tracked.any() else -1
    out = {"point": point, "key": 42 if key is None else key, "rows": cam.rows,
           "cols": cam.cols, "frames": len(gt), "first": first, "tracked": float(tracked[first:].mean()) if first >= 0 else 0.0,
           "tracked_all": float(tracked.mean()),
           "ate_sim3": chip_smoke.trajectory_ate([p if m else None for p, m in zip(poses, mask)],
                                                 gt, evaluate),
           "kf_ate_sim3": chip_smoke.keyframe_ate(s.map_db, gt, evaluate),
           "fused_frames": int(s._fused_frames), "keyframes": int(len(s.map_db.valid_kf_ids())),
           "loops_closed": s.global_optimizer.num_loops_closed, "render_s": render_s,
           "seconds": seconds}
    s.shutdown()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("points", nargs="*", default=list(POINTS), choices=list(POINTS))
    ap.add_argument("--key", type=int, default=None, help="the tracker's PRNG key (default 42)")
    args = ap.parse_args()
    for p in args.points:
        print(json.dumps(camera_point(p, args.key)), flush=True)
