"""Image-directory runner (ref example/run_image_slam.cc) on the PyTorch
port: the images of a directory, in name order, fed at the setting's fps.
Localization mode via --map-db-in.

    python3 examples_torch/run_image_slam.py -s configs/euroc_mono.json -i <image dir>
"""
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch.common import base_parser, build_system, feed_loop, finish  # noqa: E402


def main(argv=None):
    p = base_parser("image-sequence SLAM")
    p.add_argument("-i", "--image-dir", required=True)
    p.add_argument("--ext", default="png")
    args = p.parse_args(argv)
    cfg, system = build_system(args)

    from openvslam_tpu_torch.utils.datasets import _imread_gray

    files = sorted(glob.glob(os.path.join(args.image_dir, f"*.{args.ext}")))
    fps = cfg.camera.fps
    items = ((_imread_gray(files[i]), i / fps) for i in range(0, len(files), args.frame_skip))
    times = feed_loop(args, system, items, "monocular")
    finish(args, system, times)
    return system


if __name__ == "__main__":
    main()
