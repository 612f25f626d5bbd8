"""TUM RGB-D runner (ref example/run_tum_rgbd_slam.cc) on the PyTorch port:
monocular or RGB-D as the setting's Camera.setup says.

    python3 examples_torch/run_tum_rgbd_slam.py -s configs/tum_rgbd_rgbd_fr1.json -d <sequence>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch.common import base_parser, build_system, feed_loop, finish  # noqa: E402


def main(argv=None):
    p = base_parser("TUM RGB-D SLAM")
    p.add_argument("-d", "--data-dir", required=True)
    args = p.parse_args(argv)
    cfg, system = build_system(args)

    from openvslam_tpu_torch.camera.base import SetupType
    from openvslam_tpu_torch.utils.datasets import TumRgbdSequence

    seq = TumRgbdSequence(args.data_dir)
    rgbd = cfg.camera.setup == SetupType.RGBD
    if rgbd and len(seq) and seq[0][2] is None:
        print("WARNING: RGBD config but no depth maps found — feeding monocular")
        rgbd = False

    def items():
        for i in range(0, len(seq), args.frame_skip):
            ts, img, depth = seq[i]
            if rgbd and depth is None:
                continue        # an unpaired frame
            yield (img, depth, ts) if rgbd else (img, ts)
    times = feed_loop(args, system, items(), "rgbd" if rgbd else "monocular")
    finish(args, system, times)
    return system


if __name__ == "__main__":
    main()
