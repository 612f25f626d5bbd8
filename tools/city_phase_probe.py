"""Phase 11's city drive (``chip_smoke.city_drive``) at several loop seeds
and on chosen frames, reporting its readings instead of gating them.

Each run prints one JSON line: tracked share from frame 5, keyframes, loops
closed, the keyframe ATE(se3) just before each loop correction, after its
global BA and at the end, and the run's seconds.  The frames are rendered on
the device by ``render_sequence_torch`` (as phase 11 renders them), or read
from ``--frames LEFT.npy RIGHT.npy``, (N, rows, cols) uint8 arrays: for
example the numpy render's, which ``tools/city_bench.py --frames 700
--straight 60 --corner-r 12 --laps 1.1 --render numpy --render-only`` writes
to its cache.  ``--seeds`` seeds the loop detector's RANSAC generator
with each value in turn, one run a seed (its own seed otherwise).  With
``--replay`` the first global BA's problem is solved again on the CPU, and
the keyframe ATE(se3) of its keyframe poses is reported beside that of the
run's own solve.

    python3 tools/city_phase_probe.py --seeds 1 2 3             # on the card
    python3 tools/city_phase_probe.py --frames L.npy R.npy --seeds 1 23
    python3 tools/city_phase_probe.py --device cpu --frames L.npy R.npy
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from openvslam_tpu_torch.config import Config  # noqa: E402
from openvslam_tpu_torch.utils import evaluate, synthetic  # noqa: E402


def _replay(cam, db, gt, built, out):
    """Keyframe ATE(se3) of a global BA's keyframe poses: the run's own
    solve ``out`` and the same problem solved on the CPU."""
    from openvslam_tpu_torch.module import global_optimization_module as GO
    from openvslam_tpu_torch.optimize.ba import BAProblem, make_global_ba

    ba = make_global_ba(cam, iters=GO.GLOBAL_BA_ITERS, cg_iters=GO.GLOBAL_BA_CG_ITERS,
                        stereo=True)
    res = ba(BAProblem(*(torch.as_tensor(a) for a in built["prob"])))
    kfs = list(built["cam_index"])
    rows = [built["cam_index"][k] for k in kfs]
    gk = np.stack([-gt[j][:3, :3].T @ gt[j][:3, 3] for j in db.kf_src_frame[kfs]])

    def ate(T):
        ek = np.stack([-T[i][:3, :3].T @ T[i][:3, 3] for i in rows])
        return float(evaluate.ate_rmse(ek, gk, align="se3"))

    T_cpu = res.T_cw.numpy()
    return dict(kf_ate_se3_run=ate(out[0]), kf_ate_se3_cpu=ate(T_cpu),
                pose_max_abs_diff=float(np.abs(out[0][rows] - T_cpu[rows]).max()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", nargs=2, default=None, metavar=("LEFT", "RIGHT"),
                    help="(N, rows, cols) uint8 .npy files")
    ap.add_argument("--seeds", type=int, nargs="*", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replay", action="store_true",
                    help="solve the first global BA again on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cam = Config.from_dict(chip_smoke.city_config_dict()).camera
    scene, gt, shift = chip_smoke.city_scene(synthetic, cam)
    if args.frames:
        left, right = (np.load(f) for f in args.frames)
        source = args.frames[0]
    else:
        left, right, _ = chip_smoke.city_frames(dev, cam, scene, gt, shift)
        source = f"render_sequence_torch on {dev}"
    for seed in (args.seeds or [None]):
        s, poses, _, wall, rec = chip_smoke.city_drive(dev, left, right, gt, loop_seed=seed,
                                                       keep_global_ba=args.replay)
        tracked = np.array([p is not None for p in poses])
        replay = _replay(cam, s.map_db, gt, *rec["cap_gba"][0]) if rec["cap_gba"] else None
        out = dict(frames=source, seed=seed, tracked_from_5=float(tracked[5:].mean()),
                   keyframes=int(len(s.map_db.valid_kf_ids())),
                   loops_closed=s.global_optimizer.num_loops_closed,
                   kf_ate_se3_before_correction=rec["ate_before_correction"],
                   kf_ate_se3_after_global_ba=rec["ate_after_global_ba"],
                   kf_ate_se3=chip_smoke.keyframe_ate(s.map_db, gt, evaluate, "se3"),
                   global_ba_replay=replay, wall_s=wall)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
