"""chip_smoke's phases 8 and 8b alone on one CUDA card, missed gates recorded.

Builds the kernels, then runs ``chip_smoke.camera_phase`` for each
argument in turn: ``8`` (TUM VI's fisheye) or ``8b`` (the THETA S
equirectangular camera) on frames rendered on the card, or ``8:host`` on
frames rendered in numpy on the host (as tools/camera_points_jax.py renders
them for the JAX System).  A missed gate is printed and the run goes on;
each phase's summary and kernel rows follow as one JSON line.

    python tools/camera_phase_probe.py 8:host 8 8 8b
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def host_frames(dev, cam, scene, gt):
    """``chip_smoke.camera_frames``' contract, the frames rendered in numpy."""
    t = time.perf_counter()
    imgs = [scene.render(cam, T) for T in gt]
    return imgs, dict(render_card_s=0.0, render_host_s=time.perf_counter() - t,
                      render_host_frame0_s=0.0, frame0_within_1_gray=1.0,
                      frame0_max_gray_diff=0)


def main(args) -> int:
    import torch
    from openvslam_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("camera_phase_probe: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.fail = lambda msg: print(f"camera_phase_probe: gate missed: {msg}", flush=True)
    print(chip_smoke.card_line(), flush=True)
    kernels.build_all()
    card_frames = chip_smoke.camera_frames
    for arg in args:
        point, _, how = arg.partition(":")
        chip_smoke.camera_frames = host_frames if how == "host" else card_frames
        t = time.time()
        out, _, rows = chip_smoke.camera_phase(torch.device("cuda"), point)
        print(f"phase {arg}: {time.time() - t:.1f}s", flush=True)
        print(json.dumps({"phase": arg, "out": out, "rows": rows}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["8", "8b"]))
