"""Self-contained demo on the PyTorch port: renders a synthetic
textured-wall sequence, runs the full SLAM system on the CUDA card (or on
the CPU with --device cpu), reports ATE against the known ground truth and
timing.  Needs no dataset.

    python3 examples_torch/run_synthetic_slam.py            # monocular
    python3 examples_torch/run_synthetic_slam.py --stereo   # stereo (metric scale)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> dict:
    """Run the demo; returns frames, tracked, ATE (m), its alignment and the
    device line."""
    p = argparse.ArgumentParser()
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--rows", type=int, default=320)
    p.add_argument("--cols", type=int, default=416)
    p.add_argument("--feats", type=int, default=600)
    p.add_argument("--traj-out", default=None)
    p.add_argument("--viewer-out", default=None,
                   help="export a self-contained HTML map viewer")
    p.add_argument("--pipeline", action="store_true",
                   help="software-pipelined feeding (System.feed_sequence)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the System (default: the CUDA card)")
    args = p.parse_args(argv)

    from examples_torch.common import device_line
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate, synthetic

    baseline = 0.2
    cfg = Config.from_dict({
        "Camera": {
            "name": "synthetic", "setup": "stereo" if args.stereo else "monocular",
            "model": "perspective",
            "fx": 350.0, "fy": 350.0, "cx": args.cols / 2, "cy": args.rows / 2,
            "cols": args.cols, "rows": args.rows, "fps": 20,
            "focal_x_baseline": 350.0 * baseline, "depth_threshold": 30.0,
        },
        "Feature": {"max_num_keypts": args.feats, "num_levels": 4},
        "LoopDetector": {"enabled": False},
    })
    cam = cfg.camera
    rng = np.random.default_rng(7)
    scene = synthetic.PlaneSceneRenderer(rng, x_range=(-4, 14), y_range=(-5, 5), plane_z=7.0,
                                         rows=cam.rows, cols=cam.cols)
    xs = np.linspace(0.0, 8.0, args.frames)
    poses = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7)) for x in xs])
    images = [scene.render(cam, poses[i]) for i in range(args.frames)]
    if args.stereo:
        shift = np.eye(4)
        shift[0, 3] = -baseline
        rights = [scene.render(cam, shift @ poses[i]) for i in range(args.frames)]

    system = System(cfg, device=args.device)
    system.startup()
    t_track = []
    if args.pipeline:
        if args.stereo:
            items = ((images[i], rights[i], i / 20.0) for i in range(args.frames))
        else:
            items = ((images[i], i / 20.0) for i in range(args.frames))
        t_last = time.perf_counter()
        for _ in system.feed_sequence(items, kind="stereo" if args.stereo else "monocular"):
            now = time.perf_counter()
            t_track.append(now - t_last)
            t_last = now
    else:
        for i in range(args.frames):
            t0 = time.perf_counter()
            if args.stereo:
                system.feed_stereo_frame(images[i], rights[i], i / 20.0)
            else:
                system.feed_monocular_frame(images[i], i / 20.0)
            t_track.append(time.perf_counter() - t0)
    system.shutdown()

    ts, est_poses, mask = system.tracked_poses()
    idx = np.where(mask)[0]
    est = np.stack([-est_poses[i][:3, :3].T @ est_poses[i][:3, 3] for i in idx])
    gt = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    align = "se3" if args.stereo else "sim3"
    ate = evaluate.ate_rmse(est, gt, align=align)
    tt = np.array(t_track[3:])
    dev = device_line(system.device)
    print(f"tracked {mask.sum()}/{args.frames} frames | "
          f"ATE({align}) = {ate*100:.1f} cm over {np.ptp(gt[:,0]):.1f} m | "
          f"keyframes {system.map_db.n_kfs}, landmarks {len(system.map_db.valid_lm_ids())}")
    print(f"median frame time {np.median(tt)*1000:.0f} ms "
          f"({1/np.median(tt):.1f} fps) on {dev}")
    if args.traj_out:
        system.save_frame_trajectory(args.traj_out, "TUM")
    if args.viewer_out:
        from openvslam_tpu_torch.publish.html_viewer import export_html
        export_html(system.map_publisher, args.viewer_out)
        print(f"viewer written to {args.viewer_out}")
    return dict(frames=args.frames, tracked=int(mask.sum()), ate_m=float(ate), align=align,
                device=dev, keyframes=int(system.map_db.n_kfs))


if __name__ == "__main__":
    main()
