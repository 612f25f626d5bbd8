"""KITTI odometry runner (ref example/run_kitti_slam.cc), stereo or mono,
on the PyTorch port:

    python3 examples_torch/run_kitti_slam.py -s configs/kitti_stereo_00.json -d <sequence dir>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch.common import base_parser, build_system, feed_loop, finish  # noqa: E402


def main(argv=None):
    p = base_parser("KITTI odometry SLAM")
    p.add_argument("-d", "--data-dir", required=True,
                   help="sequence dir containing image_0[,image_1], times.txt")
    args = p.parse_args(argv)
    cfg, system = build_system(args)

    from openvslam_tpu_torch.camera.base import SetupType
    from openvslam_tpu_torch.utils.datasets import KittiOdometrySequence

    stereo = cfg.camera.setup == SetupType.STEREO
    seq = KittiOdometrySequence(args.data_dir, stereo=stereo)
    if stereo and len(seq) and seq[0][2] is None:
        print("WARNING: stereo config but no right images found — feeding monocular")
        stereo = False

    def items():
        for i in range(0, len(seq), args.frame_skip):
            ts, left, right = seq[i]
            yield (left, right, ts) if stereo else (left, ts)
    times = feed_loop(args, system, items(), "stereo" if stereo else "monocular")
    finish(args, system, times)
    return system


if __name__ == "__main__":
    main()
