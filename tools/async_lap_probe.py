"""The port's async System on chip_smoke's turning lap, at several lap lengths
and feed depths, on one CUDA card.

Each ``--lap FRAMES:DEPTH`` renders phase 6's path over FRAMES frames first
(``chip_smoke.loop_frames``) and runs ``chip_smoke.async_loop_phase`` on it
at that ``feed_sequence`` depth, so the feed goes as fast as the tracker;
``--rendered-lap FRAMES:DEPTH`` renders each frame as the feed reads it
(``chip_smoke.LapRender``, as chip_smoke's phase 6b does); ``--sync
FRAMES:DEPTH`` feeds the pre-rendered lap to a System with synchronous
mapping through ``feed_sequence(depth)``; ``--system-async`` runs phase 5b.
A missed gate is recorded, not fatal.  One JSON line per run goes to
standard output.

    python tools/async_lap_probe.py --lap 400:3 --rendered-lap 400:3 --sync 200:3 --system-async
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

MISSES = []


def _record_miss(msg: str) -> None:
    chip_smoke.log(f"gate missed: {msg}")
    MISSES.append(msg)


def sync_lap(dev, frames, depth: int) -> dict:
    """The lap through a System with synchronous mapping, pipelined."""
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate

    cfg = Config.from_dict(chip_smoke.loop_config_dict())
    imgs, _, gt = frames
    n = len(imgs)
    s = System(cfg, device=dev)
    s.startup()
    t = time.perf_counter()
    poses = [p for _, p in s.feed_sequence(((imgs[i], i / 20.0) for i in range(n)),
                                           kind="monocular", depth=depth)]
    wall = time.perf_counter() - t
    tracked = np.array([p is not None for p in poses])
    first = int(np.argmax(tracked)) if tracked.any() else -1
    lost = [i for i in range(max(first, 0), n) if not tracked[i]]
    out = dict(frames=n, depth=depth, async_mapping=False, first_tracked=first,
               tracked_share_after_first=float(tracked[first:].mean()) if first >= 0 else 0.0,
               first_untracked=lost[0] if lost else None,
               keyframes=int(len(s.map_db.valid_kf_ids())),
               loops_closed=s.global_optimizer.num_loops_closed,
               keyframe_ate_sim3_m=chip_smoke.keyframe_ate(s.map_db, gt, evaluate),
               lap_wall_s=wall)
    s.shutdown()
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lap", action="append", default=[], metavar="FRAMES:DEPTH",
                    help="phase 6b on the lap over FRAMES frames at feed depth DEPTH")
    ap.add_argument("--rendered-lap", action="append", default=[], metavar="FRAMES:DEPTH",
                    help="phase 6b with each frame rendered as the feed reads it")
    ap.add_argument("--sync", action="append", default=[], metavar="FRAMES:DEPTH",
                    help="the lap through synchronous mapping at feed depth DEPTH")
    ap.add_argument("--system-async", action="store_true", help="run phase 5b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("async_lap_probe: no CUDA device", file=sys.stderr)
        return 1
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.config import Config

    chip_smoke.fail = _record_miss
    print(chip_smoke.card_line(), flush=True)
    kernels.build_all()
    dev = torch.device("cuda")
    cam = Config.from_dict(chip_smoke.loop_config_dict()).camera
    laps = {}

    def emit(kind, spec, out):
        row = dict(run=kind, spec=spec, gate_misses=list(MISSES), **out)
        MISSES.clear()
        print(json.dumps(row, default=str), flush=True)

    if args.system_async:
        frames = chip_smoke.system_frames(chip_smoke.system_config().camera)
        out, _ = chip_smoke.async_system_phase(dev, frames)
        emit("system_async", "240:3", out)
        del frames
    for kind, specs in (("sync", args.sync), ("async", args.lap),
                        ("async_rendered", args.rendered_lap)):
        for spec in specs:
            n, depth = (int(x) for x in spec.split(":"))
            if kind == "async_rendered":
                lap = chip_smoke.LapRender(cam, n)
                frames = (lap, lap[chip_smoke.revisit_index(n)], lap.gt)
            else:
                if n not in laps:
                    laps[n] = chip_smoke.loop_frames(cam, n)
                frames = laps[n]
            if kind == "sync":
                out = sync_lap(dev, frames, depth)
            else:
                out, _ = chip_smoke.async_loop_phase(dev, frames, depth)
            emit(kind, spec, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
