"""chip_smoke's phase 5b (the async System at bench.py's point, depth 3) or
phase 8's seeded runs (TUM VI's fisheye on the rendered room, one System
per bootstrap seed) N times in the checkout given as the first argument, on
one CUDA card; missed gates are printed and the runs go on, one RESULT line
each.  Phase 8's lines carry a digest of the tracked poses, so repeats of
one seed show whether the card's run is reproducible.  Put two checkouts
in one call to compare them on the same card:

    python tools/phase_repeat.py <checkout> <runs> [--phase 5b|8|8-smoke]
        [--seeds 42,1,2,3] [--index-add] [--deterministic]

``--phase 8-smoke`` runs chip_smoke's whole phase 8 (the seeded runs, the
captures and their replays on the CPU) and prints its summary.

``--index-add`` sums the bundle adjustments' and pose graph's blocks with
``index_add_`` (atomics on the card) instead of in fixed order;
``--deterministic`` turns on ``torch.use_deterministic_algorithms``
(warnings only) and prints the operations it warned about.
"""
import argparse
import hashlib
import json
import os
import sys

ap = argparse.ArgumentParser()
ap.add_argument("tree")
ap.add_argument("runs", type=int)
ap.add_argument("--phase", default="5b", choices=("5b", "8", "8-smoke"))
ap.add_argument("--seeds", default="42")
ap.add_argument("--index-add", action="store_true")
ap.add_argument("--deterministic", action="store_true")
args = ap.parse_args()
tree = os.path.abspath(args.tree)
sys.path.insert(0, tree)
os.chdir(tree)
if args.deterministic:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def phase8_runs(dev, seeds, runs):
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate, synthetic

    cfg = Config.from_dict(chip_smoke.fisheye_config_dict())
    cam = cfg.camera
    scene, gt = chip_smoke.camera_scene(synthetic, cam)
    imgs, _ = chip_smoke.camera_frames(dev, cam, scene, gt)
    for r in range(runs):
        ates = []
        for seed in seeds:
            s = System(cfg, device=dev)
            s.tracker.gen.manual_seed(seed)
            s.startup()
            poses = [s.feed_monocular_frame(imgs[i], i / cam.fps) for i in range(len(gt))]
            s.shutdown()
            _, tp, mask = s.tracked_poses()
            ate = chip_smoke.trajectory_ate([p if k else None for p, k in zip(tp, mask)], gt,
                                            evaluate)
            ates.append(ate)
            digest = hashlib.sha256(np.ascontiguousarray(tp[mask.astype(bool)],
                                                         np.float64).tobytes()).hexdigest()
            print("RESULT", json.dumps({
                "tree": args.tree, "run": r, "seed": seed, "ate": ate,
                "tracked": float(np.mean([p is not None for p in poses])),
                "keyframes": s.stats()["num_keyframes"], "poses_sha256": digest[:16],
                "local_ba_runs": s.mapper.ba_runs,
                "local_ba_ms_mean": s.mapper.ba_wall_s / max(s.mapper.ba_runs, 1) * 1e3}),
                flush=True)
        print("MEDIAN", json.dumps({"run": r, "seeds": seeds, "median_ate": float(np.median(ates)),
                                    "gate": chip_smoke.LOOP_ATE_MARGIN
                                    * chip_smoke.FISHEYE_REF["ate_sim3_m"]}), flush=True)


def main() -> int:
    import functools
    import warnings

    import torch
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.optimize import ba, pose_graph, segment_sum

    chip_smoke.fail = lambda m: print("GATE MISSED:", m, flush=True)
    if args.index_add:
        plain = functools.partial(segment_sum.segment_sums, fixed_order=False)
        ba.segment_sums = pose_graph.segment_sums = plain
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    kernels.build_all()
    dev = torch.device("cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if args.phase == "8":
            phase8_runs(dev, [int(x) for x in args.seeds.split(",")], args.runs)
        elif args.phase == "8-smoke":
            for r in range(args.runs):
                out, counts, _ = chip_smoke.camera_phase(dev, "8")
                print("RESULT", json.dumps({
                    "tree": args.tree, "run": r, "median_ate": out["ate_sim3_gated_m"],
                    "ate_by_seed": [x["ate_sim3_m"] for x in out["runs"]],
                    "ba_check": out["ba_check"], "lm_check": out["lm_check"],
                    "launches": counts}), flush=True)
        else:
            frames = chip_smoke.system_frames(chip_smoke.system_config().camera)
            for r in range(args.runs):
                out, _ = chip_smoke.async_system_phase(dev, frames)
                print("RESULT", json.dumps({
                    "tree": args.tree, "run": r, "ate": out["ate_sim3_m"],
                    "tracked": out["tracked_share"],
                    "median_ms": out["track_ms_median_after_40"],
                    "kfs": out.get("keyframes"), "inserted": out.get("keyframes_inserted")}),
                    flush=True)
    if args.deterministic:
        msgs = sorted({str(w.message).split("\n")[0][:200] for w in caught})
        print("NONDETERMINISTIC", json.dumps(msgs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
