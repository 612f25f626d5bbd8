"""The JAX System at chip_smoke's loop phase working point, on the CPU.

Takes the configuration, scene and lap from ``chip_smoke.py``'s one
definition (``LOOP_POINT``, ``loop_config_dict``, ``loop_scene``: the
organic loop test's octagon room and 200-frame lap at 640x480 with 1000
keypoints and 8 levels, loop detection on with minimum continuity 2),
feeds it to ``openvslam_tpu.system.System`` with synchronous mapping, then
3 blank frames and the view of frame 20 for up to 3 attempts, as
``chip_smoke.loop_phase`` drives the port, and prints one JSON line: first
tracked frame, tracked share, loops closed, keyframe ATE(sim3), loop
counters, and the relocalization's outcome against the System's own
as-tracked frame-20 pose.  Its keyframe ATE is the reference reading that
``chip_smoke.LOOP_REF_KF_ATE_M`` records.  With ``--async-mapping`` the
System maps on its worker threads (the System settles before the blank
frames), with ``--depth D`` the lap goes through ``feed_sequence(depth=D)``
instead of frame by frame, and ``--frames N`` spreads the lap over N frames
(chip_smoke phase 6b's slower lap).

    JAX_PLATFORMS=cpu python tools/loop_point_jax.py      # about 28 minutes
    JAX_PLATFORMS=cpu python tools/loop_point_jax.py --async-mapping --depth 3
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
from openvslam_tpu.module.tracking_module import TrackerState  # noqa: E402
from openvslam_tpu.system import System  # noqa: E402
from openvslam_tpu.utils import evaluate, synthetic  # noqa: E402


def main(async_mapping: bool = False, depth: int = 0,
         frames: int = chip_smoke.LOOP_POINT["frames"]) -> dict:
    cfg = Config.from_dict(chip_smoke.loop_config_dict())
    cam = cfg.camera
    scene, gt = chip_smoke.loop_scene(synthetic, cam, frames)
    n = frames
    s = System(cfg, vocab_path="default", async_mapping=async_mapping)
    s.startup()
    t0 = time.time()
    if depth:
        items = ((scene.render(cam, gt[i]), i / 20.0) for i in range(n))
        tracked = np.array([p is not None for _, p in s.feed_sequence(items, depth=depth)])
    else:
        tracked = np.array([s.feed_monocular_frame(scene.render(cam, gt[i]), i / 20.0) is not None
                            for i in range(n)])
    if async_mapping:
        go = s.global_optimizer
        for _ in range(2):              # the worker may still check the last batch
            while not (s._tracker_mapper.idle and go.loop_backlog == 0):
                time.sleep(0.1)
            time.sleep(2.0)
        go.join_global_ba(timeout=600)
    first = int(np.argmax(tracked))
    kf_ate = chip_smoke.keyframe_ate(s.map_db, gt, evaluate)
    blank = np.zeros((cam.rows, cam.cols), np.uint8)
    for i in range(3):
        s.feed_monocular_frame(blank, (n + i) / 20.0)
    lost = s.tracker.state == TrackerState.LOST
    _, poses, _ = s.tracked_poses()
    ref = poses[20]
    reloc, attempts = None, 0
    for a in range(3):
        attempts += 1
        reloc = s.feed_monocular_frame(scene.render(cam, gt[20]), (n + 3 + a) / 20.0)
        if reloc is not None:
            break
    go = s.global_optimizer
    out = {"rows": cam.rows, "cols": cam.cols, "frames": n, "async_mapping": async_mapping,
           "depth": depth, "first": first,
           "tracked": float(tracked[first:].mean()), "loops_closed": go.num_loops_closed,
           "kf_ate_sim3": kf_ate, "loop_checks": go.loop_checks_run,
           "cands": go.loop_cands_seen, "validations": go.loop_validations,
           "lost_after_blanks": bool(lost), "reloc_ok": reloc is not None,
           "reloc_attempts": attempts, "seconds": time.time() - t0}
    if reloc is not None:
        out["reloc_dc"] = float(np.linalg.norm(-reloc[:3, :3].T @ reloc[:3, 3]
                                               + ref[:3, :3].T @ ref[:3, 3]))
        out["reloc_dR"] = float(np.linalg.norm(reloc[:3, :3] - ref[:3, :3]))
    s.shutdown()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--async-mapping", action="store_true",
                    help="map on the System's worker threads")
    ap.add_argument("--depth", type=int, default=0,
                    help="feed the lap through feed_sequence at this depth (0: frame by frame)")
    ap.add_argument("--frames", type=int, default=chip_smoke.LOOP_POINT["frames"],
                    help="spread the lap's 200 degrees over this many frames")
    args = ap.parse_args()
    print(json.dumps(main(args.async_mapping, args.depth, args.frames)), flush=True)
