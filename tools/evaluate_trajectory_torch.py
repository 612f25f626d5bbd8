"""Trajectory evaluation with the PyTorch port's modules (the counterpart of
tools/evaluate_trajectory.py, with the same flags): ATE and RPE of an
estimated trajectory against ground truth.

    python3 tools/evaluate_trajectory_torch.py EST GT [--format TUM|KITTI]
        [--align sim3|se3|none] [--rpe-delta N] [--max-diff S]

EST/GT are trajectory files.  TUM format rows are
`ts tx ty tz qx qy qz qw` (associated by timestamp); KITTI rows are 3x4
row-major poses (associated by line index).  The evaluation is numpy on the
host, as in the JAX package's tool.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load(path: str, fmt: str):
    """-> (timestamps or None, (N,4,4) cam-from-world poses)."""
    from openvslam_tpu_torch.io import trajectory_io
    if fmt == "TUM":
        return trajectory_io.load_trajectory_tum(path)
    return None, trajectory_io.load_trajectory_kitti(path)


def centers(poses: np.ndarray) -> np.ndarray:
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)


def main(argv=None):
    from openvslam_tpu_torch.utils import evaluate

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("est")
    p.add_argument("gt")
    p.add_argument("--format", default="TUM", choices=["TUM", "KITTI"])
    p.add_argument("--align", default="sim3", choices=["sim3", "se3", "none"])
    p.add_argument("--rpe-delta", type=int, default=1)
    p.add_argument("--max-diff", type=float, default=0.02,
                   help="TUM timestamp association tolerance (s)")
    args = p.parse_args(argv)

    ts_e, pe = load(args.est, args.format)
    ts_g, pg = load(args.gt, args.format)
    if args.format == "TUM":
        pairs = evaluate.associate_timestamps(ts_e, ts_g, args.max_diff)
        pe, pg = pe[[a for a, _ in pairs]], pg[[b for _, b in pairs]]
    else:
        n = min(len(pe), len(pg))
        pe, pg = pe[:n], pg[:n]
    if len(pe) < 3:
        raise SystemExit(f"only {len(pe)} associated poses — cannot evaluate")

    ce, cg = centers(pe), centers(pg)
    ate = evaluate.ate_rmse(ce, cg, align=args.align)
    if args.align != "none":
        # align the estimate onto the ground truth before RPE too (a
        # monocular scale is arbitrary; unaligned RPE would measure it)
        s_, R_, t_ = evaluate.umeyama_alignment(ce, cg, with_scale=args.align == "sim3")
        pe_aligned = pe.copy()
        for i in range(len(pe)):
            c_new = s_ * R_ @ ce[i] + t_
            R_wc = R_ @ pe[i][:3, :3].T
            pe_aligned[i][:3, :3] = R_wc.T
            pe_aligned[i][:3, 3] = -R_wc.T @ c_new
        rpe_t, rpe_r = evaluate.rpe(pe_aligned, pg, delta=args.rpe_delta)
    else:
        rpe_t, rpe_r = evaluate.rpe(pe, pg, delta=args.rpe_delta)
    span = float(np.linalg.norm(cg.max(0) - cg.min(0)))
    print(f"associated poses: {len(pe)}")
    print(f"trajectory span:  {span:.2f} m")
    print(f"ATE RMSE ({args.align}): {ate:.4f} m")
    print(f"RPE (delta={args.rpe_delta}): {rpe_t:.4f} m, {rpe_r:.3f} deg")
    return dict(poses=len(pe), ate_m=float(ate), rpe_m=float(rpe_t), rpe_deg=float(rpe_r))


if __name__ == "__main__":
    main()
