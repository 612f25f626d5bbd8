"""The port's pipelined feed on chip_smoke's turning lap on the card, with
every fused step replayed on the CPU.

Runs the port's System with synchronous mapping on one CUDA card at
chip_smoke phase 6's point (``LOOP_POINT``: the organic test's octagon room
and 200-frame lap at 640x480, 1000 keypoints, 8 levels) through
``feed_sequence(depth=--depth)``.  Synchronous mapping keeps the order of
every call fixed, so the run is the same program on both backends up to
float rounding.  At each fused dispatch the step's inputs (image, predicted
pose, last-frame and local-map tables) are replayed through a TrackStep on
the CPU, and one JSON line per step compares the card's outputs with the
CPU's: stage-1 and final inlier counts, the largest pose difference, and
the shares of equal keypoints, sources and inlier flags.  Each classic
ladder frame prints its stages' counts.  A last line sums up the lap.
With ``--repeat N`` the lap runs N more times on the card alone (frames
rendered once), each run's steps and ladder frames logged the same way,
and a line per run names the first frame whose counts differ from the
first run's: the card's own run-to-run spread.

``--cpu`` runs the lap once on the CPU instead (tens of minutes).

    python tools/card_lap_replay.py --depth 3 > chiprun_out/lap_replay.jsonl
    python tools/card_lap_replay.py --depth 3 --no-replay --repeat 3
    python tools/card_lap_replay.py --depth 3 --cpu
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

STAGES = ("_motion_match", "_bow_match_ref_kf", "_fallback_match_last_frame",
          "_rescue_with_local_map", "_pose_optimize", "_track_local_map")


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def run_lap(cfg, frames, gt, cpu_step, depth, emit, device="cuda"):
    """One synchronous-mapping run of the lap ``frames`` (ground truth
    ``gt``) at feed ``depth``
    on the card; with ``cpu_step`` each fused step is replayed on the CPU.
    Returns {frame: counts} of the fused steps and ladder frames."""
    import torch
    from openvslam_tpu_torch.models.track_step import LastFrame, LocalMap
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate

    s = System(cfg, device=device)
    card_step = s._track_step.step
    cpu = torch.device("cpu")
    rows, fid, counts = [], [None], {}

    def replayed(image_u8, mask, T_pred, last, local, aux=None):
        res = card_step(image_u8, mask, T_pred, last, local, aux)
        a = type(res)(*(x.cpu().numpy() for x in res))
        counts[fid[0]] = ("step", int(a.n_stage1), int(a.num_inliers))
        row = dict(step=fid[0], n_stage1=int(a.n_stage1), inliers=int(a.num_inliers))
        if cpu_step is not None:
            ref = cpu_step.step(image_u8.to(cpu), None if mask is None else mask.to(cpu),
                                T_pred.to(cpu), LastFrame(*(x.to(cpu) for x in last)),
                                LocalMap(*(x.to(cpu) for x in local)))
            b = type(ref)(*(x.numpy() for x in ref))
            row.update(n_stage1=[int(a.n_stage1), int(b.n_stage1)],
                       inliers=[int(a.num_inliers), int(b.num_inliers)],
                       dT=float(np.abs(a.T_cw - b.T_cw).max()),
                       keypoints_equal=bool(np.array_equal(a.kp_xy, b.kp_xy)
                                            and np.array_equal(a.kp_valid, b.kp_valid)),
                       src_equal=float((a.kp_src == b.kp_src).mean()),
                       inlier_equal=float((a.kp_inlier == b.kp_inlier).mean()),
                       desc_equal=float((a.kp_desc_u32 == b.kp_desc_u32).all(-1).mean()))
        rows.append(row)
        emit(row)
        return res

    s._track_step.step = replayed
    tr, log = s.tracker, []
    for name in STAGES:
        fn = getattr(tr, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            log.append((_name, int(out[1]) if isinstance(out, tuple) else int(out)))
            return out

        setattr(tr, name, wrapped)
    ladder = tr._track_frame

    def logged(frame):
        del log[:]
        pose = ladder(frame)
        counts[int(frame.frame_id)] = ("ladder", tuple(log), pose is not None)
        emit(dict(ladder=int(frame.frame_id), ok=pose is not None, stages=list(log)))
        return pose

    tr._track_frame = logged
    dispatch = tr.track_fused_dispatch

    def numbered(image_u8, frame_id, *a, **kw):
        fid[0] = int(frame_id)
        return dispatch(image_u8, frame_id, *a, **kw)

    tr.track_fused_dispatch = numbered
    s.startup()
    t = time.time()
    items = ((frames[i], i / 20.0) for i in range(len(frames)))
    tracked = np.array([p is not None for _, p in s.feed_sequence(items, depth=depth)])
    first = int(np.argmax(tracked))
    lost = [i for i in range(first, len(tracked)) if not tracked[i]]
    out = dict(summary=True, depth=depth, frames=len(tracked), first_tracked=first,
               tracked_share_after_first=float(tracked[first:].mean()),
               first_untracked=lost[0] if lost else None, fused_steps=len(rows),
               loops_closed=s.global_optimizer.num_loops_closed,
               keyframe_ate_sim3_m=chip_smoke.keyframe_ate(s.map_db, gt, evaluate),
               seconds=time.time() - t)
    if cpu_step is not None:
        out.update(steps_with_other_counts=[r["step"] for r in rows
                                            if r["n_stage1"][0] != r["n_stage1"][1]
                                            or r["inliers"][0] != r["inliers"][1]][:40],
                   steps_with_other_keypoints=[r["step"] for r in rows
                                               if not r["keypoints_equal"]][:40],
                   max_dT=max((r["dT"] for r in rows), default=0.0))
    emit(out)
    s.shutdown()
    return counts


def main() -> int:
    import torch
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.system import System

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--frames", type=int, default=chip_smoke.LOOP_POINT["frames"])
    ap.add_argument("--no-replay", action="store_true", help="skip the CPU replay of each step")
    ap.add_argument("--repeat", type=int, default=0, help="run the lap this many more times")
    ap.add_argument("--cpu", action="store_true", help="run the lap once on the CPU")
    args = ap.parse_args()
    if args.cpu:
        cfg = Config.from_dict(chip_smoke.loop_config_dict())
        lap = chip_smoke.LapRender(cfg.camera, args.frames)
        run_lap(cfg, lap, lap.gt, None, args.depth, emit, device="cpu")
        return 0
    if not torch.cuda.is_available():
        print("card_lap_replay: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    cfg = Config.from_dict(chip_smoke.loop_config_dict())
    lap = chip_smoke.LapRender(cfg.camera, args.frames)
    cpu_step = System(cfg, device="cpu")._track_step
    frames = [lap[i] for i in range(len(lap))] if args.repeat else lap
    first_run = run_lap(cfg, frames, lap.gt, None if args.no_replay else cpu_step, args.depth,
                        emit)
    for k in range(args.repeat):
        counts = run_lap(cfg, frames, lap.gt, None, args.depth, emit)
        differ = [f for f in sorted(set(first_run) | set(counts))
                  if first_run.get(f) != counts.get(f)]
        emit(dict(repeat=k + 1, first_frame_with_other_counts=differ[0] if differ else None,
                  frames_with_other_counts=len(differ)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
