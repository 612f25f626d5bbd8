"""EuRoC MAV runner (ref example/run_euroc_slam.cc) on the PyTorch port:
stereo (rectified by the setting's StereoRectifier section where it has
one) or monocular.

    python3 examples_torch/run_euroc_slam.py -s configs/euroc_stereo.json -d <sequence root>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch.common import base_parser, build_system, feed_loop, finish  # noqa: E402


def main(argv=None):
    p = base_parser("EuRoC MAV SLAM")
    p.add_argument("-d", "--data-dir", required=True, help="sequence root (contains mav0/)")
    args = p.parse_args(argv)
    cfg, system = build_system(args)

    from openvslam_tpu_torch.camera.base import SetupType
    from openvslam_tpu_torch.utils.datasets import EurocSequence

    stereo = cfg.camera.setup == SetupType.STEREO
    rectifier = None
    if stereo and "StereoRectifier" in cfg.raw:
        from openvslam_tpu_torch.utils.stereo_rectifier import StereoRectifier
        rectifier = StereoRectifier(cfg.camera, cfg.raw, device=system.device)
    seq = EurocSequence(args.data_dir, stereo=stereo)
    if stereo and len(seq) and seq[0][2] is None:
        print("WARNING: stereo config but no cam1 images found — feeding monocular")
        stereo = False

    def items():
        for i in range(0, len(seq), args.frame_skip):
            ts, left, right = seq[i]
            if stereo:
                if rectifier is not None:
                    left, right = rectifier.rectify(left, right)
                yield left, right, ts
            else:
                yield left, ts
    times = feed_loop(args, system, items(), "stereo" if stereo else "monocular")
    finish(args, system, times)
    return system


if __name__ == "__main__":
    main()
