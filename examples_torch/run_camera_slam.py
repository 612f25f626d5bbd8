"""Live-camera runner (ref example/run_camera_slam.cc) on the PyTorch port:
an OpenCV capture device (``cv2``, which this runner alone needs) fed in
real time; pair with --viewer for the live web view.

    python3 examples_torch/run_camera_slam.py -s <setting.json> -n 0
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch.common import base_parser, build_system, feed_loop, finish  # noqa: E402

NEEDS_CV2 = ("run_camera_slam reads the camera through OpenCV, which is not installed "
             "(pip install opencv-python)")


def main(argv=None):
    p = base_parser("live camera SLAM")
    p.add_argument("-n", "--cam-num", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=0,
                   help="stop after N frames (0 = until interrupted)")
    args = p.parse_args(argv)
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(NEEDS_CV2) from e

    cfg, system = build_system(args)
    cap = cv2.VideoCapture(args.cam_num)
    if not cap.isOpened():
        raise SystemExit(f"cannot open camera {args.cam_num}")
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, cfg.camera.cols)
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, cfg.camera.rows)

    def items():
        n = 0
        while not args.max_frames or n < args.max_frames:
            ok, frame = cap.read()
            if not ok:
                return
            if frame.ndim == 3:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            yield frame, time.time()
            n += 1
    try:
        times = feed_loop(args, system, items(), "monocular")
    except KeyboardInterrupt:
        times = system.track_times
    cap.release()
    finish(args, system, times)
    return system


if __name__ == "__main__":
    main()
