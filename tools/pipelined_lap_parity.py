"""The pipelined feed on the organic lap at its 320x240 point, on the CPU.

tests/test_organic_loop.py's octagon room (seed ``--seed``, default 7) and
200-frame path, 500 keypoints, 3 levels, synchronous mapping, fed through
``feed_sequence(depth=--depth)`` for ``--frames`` frames.

``--side port`` or ``--side jax`` runs that package's System and prints, for
every frame that goes through the classic ladder, each stage's count
(matches, or inliers of a pose), then a summary line (tracked share, the
untracked frames).

``--replay`` runs the JAX System and, at each fused dispatch and each
classic-ladder frame, runs the port on the same state (the JAX map carried
across by ``convert``, the tracker's fields, its local-map table and pose
history, the same image or frame): it prints the two fused steps' stage-1
and inlier counts, the largest pose difference and the share of equal
keypoint sources, and the two ladders' stage counts.

    JAX_PLATFORMS=cpu python tools/pipelined_lap_parity.py --side port --seed 7
    JAX_PLATFORMS=cpu python tools/pipelined_lap_parity.py --replay --frames 40
"""
import argparse
import copy
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

ROWS, COLS = 240, 320
STAGES = ("_motion_match", "_bow_match_ref_kf", "_fallback_match_last_frame",
          "_rescue_with_local_map", "_pose_optimize", "_track_local_map")
CARRIED = ("velocity", "ref_kf", "frames_since_reloc", "num_tracked", "_peak_tracked",
           "last_kf_frame_id")


def cfg_dict() -> dict:
    return {"Camera": {"name": "lap", "setup": "monocular", "model": "perspective",
                       "fx": 260.0, "fy": 260.0, "cx": COLS / 2, "cy": ROWS / 2,
                       "cols": COLS, "rows": ROWS, "fps": 20},
            "Feature": {"max_num_keypts": 500, "num_levels": 3, "scale_factor": 1.2},
            "LoopDetector": {"enabled": True, "min_continuity": 2}}


def spy(tracker, log) -> None:
    """Record each ladder stage's count into ``log``."""
    for name in STAGES:
        fn = getattr(tracker, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            log.append((_name, int(out[1]) if isinstance(out, tuple) else int(out)))
            return out

        setattr(tracker, name, wrapped)


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def run_side(side: str, seed: int, n: int, depth: int) -> None:
    if side == "jax":
        from openvslam_tpu.config import Config
        from openvslam_tpu.system import System
        from openvslam_tpu.utils import synthetic
        kw = dict(vocab_path="default")
    else:
        from openvslam_tpu_torch.config import Config
        from openvslam_tpu_torch.system import System
        from openvslam_tpu_torch.utils import synthetic
        kw = dict(device="cpu")
    cfg = Config.from_dict(cfg_dict())
    cam = cfg.camera
    scene = synthetic.RoomSceneRenderer(np.random.default_rng(seed), half=10.0, rows=ROWS,
                                        cols=COLS, n_walls=8)
    gt = synthetic.lap_trajectory(200, radius=6.0, laps=200 / 180)
    s = System(cfg, **kw)
    s.startup()
    tr, log = s.tracker, []
    spy(tr, log)
    ladder = tr._track_frame

    def logged(frame):
        del log[:]
        pose = ladder(frame)
        emit(dict(frame=int(frame.frame_id), ok=pose is not None, stages=list(log)))
        return pose

    tr._track_frame = logged
    t = time.time()
    items = ((scene.render(cam, gt[i]), i / 20.0) for i in range(n))
    tracked = [p is not None for _, p in s.feed_sequence(items, depth=depth)]
    emit(dict(side=side, seed=seed, depth=depth, frames=n, tracked=float(np.mean(tracked)),
              untracked=[i for i, x in enumerate(tracked) if not x][:30],
              keyframes=int(len(s.map_db.valid_kf_ids())), seconds=time.time() - t))
    s.shutdown()


def run_replay(seed: int, n: int, depth: int) -> None:
    import torch
    from openvslam_tpu.config import Config as JaxConfig
    from openvslam_tpu.data import Frame as JaxFrame
    from openvslam_tpu.system import System as JaxSystem
    from openvslam_tpu.utils import synthetic as jsyn
    from openvslam_tpu_torch import convert
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.data import Frame
    from openvslam_tpu_torch.data.bow import default_vocabulary
    from openvslam_tpu_torch.module import relocalizer as reloc
    from openvslam_tpu_torch.module.tracking_module import (TrackerState, TrackingModule,
                                                            _u32_as_i32)
    from openvslam_tpu_torch.system import System

    jcfg = JaxConfig.from_dict(cfg_dict())
    cam = jcfg.camera
    scene = jsyn.RoomSceneRenderer(np.random.default_rng(seed), half=10.0, rows=ROWS,
                                   cols=COLS, n_walls=8)
    gt = jsyn.lap_trajectory(200, radius=6.0, laps=200 / 180)
    s = JaxSystem(jcfg, vocab_path="default")
    s.startup()
    jt = s.tracker
    pcfg = Config.from_dict(cfg_dict())
    pstep = System(pcfg, device="cpu")._track_step
    vocab = default_vocabulary()

    def port_frame(jframe):
        return Frame(**{f.name: copy.deepcopy(getattr(jframe, f.name))
                        for f in dataclasses.fields(JaxFrame)})

    def port_tracker(with_bow: bool):
        db = convert.map_database_from_state(convert.map_state(s.map_db))
        rl = None
        if with_bow:
            bow = convert.bow_database_from_state(convert.bow_state(s.global_optimizer.bow_db),
                                                  vocab, db)
            rl = reloc.Relocalizer(pcfg, pcfg.camera, db, bow, device="cpu")
        pt = TrackingModule(pcfg, pcfg.camera, db, mapper=None, relocalizer=rl, device="cpu")
        for name in CARRIED:
            setattr(pt, name, copy.deepcopy(getattr(jt, name)))
        pt._pose_hist.clear()
        pt._pose_hist.extend((fid, pose.copy()) for fid, pose in jt._pose_hist)
        pt.state = TrackerState.TRACKING
        pt.last_frame = port_frame(jt.last_frame)
        return pt, db

    jlog = []
    spy(jt, jlog)
    jax_ladder, jax_dispatch = jt._track_frame, jt.track_fused_dispatch

    def ladders(frame):
        pt, _ = port_tracker(with_bow=True)
        plog = []
        spy(pt, plog)
        ppose = pt._track_frame(port_frame(frame))
        del jlog[:]
        jpose = jax_ladder(frame)
        row = dict(ladder=int(frame.frame_id), jax=list(jlog), port=plog,
                   jax_ok=jpose is not None, port_ok=ppose is not None)
        if jpose is not None and ppose is not None:
            row["dT"] = float(np.abs(np.asarray(jpose) - ppose).max())
        emit(row)
        return jpose

    def steps(image_u8, frame_id, timestamp, step, mask=None, aux=None):
        pt, db = port_tracker(with_bow=False)
        handle = jax_dispatch(image_u8, frame_id, timestamp, step, mask, aux)
        jc = jt._lm_cache
        cand, k = jc["cand"], jc["n"]
        L = pt.LOCAL_LM_CAP
        pos, desc = np.zeros((L, 3), np.float32), np.zeros((L, 8), np.int32)
        valid, maxd = np.zeros(L, bool), np.zeros(L, np.float32)
        pos[:k], valid[:k] = np.asarray(jc["pos"])[:k], True
        maxd[:k] = np.asarray(jc["maxd"])[:k]
        desc[:k] = _u32_as_i32(db.lm_desc_u32[cand[:k]])
        # JAX's local-map table as its dispatch left it
        pt._lm_cache = {"key": (db.version, pt.ref_kf), "cand": cand, "n": k,
                        "pos": torch.from_numpy(pos), "desc_u32": torch.from_numpy(desc),
                        "valid": torch.from_numpy(valid), "maxd": torch.from_numpy(maxd)}
        pr = pt.track_fused_dispatch(image_u8, frame_id, timestamp, pstep, None)["res"]
        jr = handle["fetch"].result()
        emit(dict(step=int(frame_id), lead=int(frame_id - jt.last_frame.frame_id),
                  n_stage1=[int(jr.n_stage1), int(pr.n_stage1)],
                  inliers=[int(jr.num_inliers), int(pr.num_inliers)],
                  dT=float(np.abs(np.asarray(jr.T_cw) - pr.T_cw.numpy()).max()),
                  src_equal=float((np.asarray(jr.kp_src) == pr.kp_src.numpy()).mean())))
        return handle

    jt._track_frame, jt.track_fused_dispatch = ladders, steps
    items = ((scene.render(cam, gt[i]), i / 20.0) for i in range(n))
    tracked = [p is not None for _, p in s.feed_sequence(items, depth=depth)]
    emit(dict(side="jax", seed=seed, depth=depth, frames=n, tracked=float(np.mean(tracked))))
    s.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--side", choices=("port", "jax"), help="run one package's System")
    mode.add_argument("--replay", action="store_true",
                      help="run JAX and replay its steps and ladders through the port")
    ap.add_argument("--seed", type=int, default=7, help="the room's texture seed")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--depth", type=int, default=3)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(2)
    if args.replay:
        run_replay(args.seed, args.frames, args.depth)
    else:
        run_side(args.side, args.seed, args.frames, args.depth)
    return 0


if __name__ == "__main__":
    sys.exit(main())
