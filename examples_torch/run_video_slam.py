"""Video-file runner (ref example/run_video_slam.cc) on the PyTorch port:
a video decoded with OpenCV (``cv2``, which this runner alone needs), its
frames fed at their timestamps.  Localization mode via --map-db-in.

    python3 examples_torch/run_video_slam.py -s <setting.json> -m <video file>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch.common import base_parser, build_system, feed_loop, finish  # noqa: E402

NEEDS_CV2 = ("run_video_slam decodes the video with OpenCV, which is not installed "
             "(pip install opencv-python); the image-directory runner "
             "(examples_torch/run_image_slam.py) needs no OpenCV")


def main(argv=None):
    p = base_parser("video SLAM")
    p.add_argument("-m", "--video", required=True, help="video file path")
    p.add_argument("--start-time", type=float, default=0.0)
    args = p.parse_args(argv)
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(NEEDS_CV2) from e

    cfg, system = build_system(args)
    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise SystemExit(f"cannot open {args.video}")
    fps = cap.get(cv2.CAP_PROP_FPS) or cfg.camera.fps

    def items():
        i = -1
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            i += 1
            if i % args.frame_skip:
                continue
            if frame.ndim == 3:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            yield frame, args.start_time + i / fps
    times = feed_loop(args, system, items(), "monocular")
    cap.release()
    finish(args, system, times)
    return system


if __name__ == "__main__":
    main()
