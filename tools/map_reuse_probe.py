"""chip_smoke's phases 5 and 9 alone on one CUDA card, missed gates recorded.

Builds the kernels, renders phase 5's frames, runs ``chip_smoke.system_phase``
(the mono System at bench.py's system point) and then
``chip_smoke.map_reuse_phase`` (save and load in both schemas, the BoW
rebuild, localization on the loaded maps, the autosave resume, the
viewers) on that System.  A missed gate is printed and the run goes on;
phase 9's summary and kernel rows follow as one JSON line.

``--publish-ab`` instead runs phase 5's System over its first 130 frames
twice, with the publish hook as shipped and with it replaced by a no-op,
each with a profiler window over frames 120-129 (mapping disabled for the
window, so it holds the tracking path alone), and prints the
CUDA kernels and the CUDA runtime's synchronizing and copy calls per frame
of both: the hook hands host numpy to the publishers, so neither count
should move.

    python tools/map_reuse_probe.py [--publish-ab]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def publish_ab(dev, frames) -> dict:
    """Kernels and synchronizing / copy runtime calls per frame of phase 5's
    profiler window (frames 120-129), with and without the publish hook."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from openvslam_tpu_torch.system import System

    imgs, _ = frames
    out = {}
    for tag in ("hook", "no_hook"):
        s = System(chip_smoke.system_config(), device=dev)
        if tag == "no_hook":
            s._publish = lambda *a, **k: None
        for i in range(120):
            s.feed_monocular_frame(imgs[i], i / 20.0)
        s.disable_mapping_module()      # the window holds the tracking path alone
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(120, 130):
                s.feed_monocular_frame(imgs[i], i / 20.0)
            torch.cuda.synchronize()
        s.shutdown()
        ev = prof.events()
        dev_ev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
        out[tag] = dict(
            kernels_per_frame=len(dev_ev) / 10,
            sync_calls_per_frame=sum("Synchronize" in e.name for e in ev) / 10,
            memcpy_calls_per_frame=sum(e.name.startswith("cudaMemcpy") for e in ev) / 10,
            published_frame=None if s.frame_publisher.get_current_frame() is None
            else s.frame_publisher.get_current_frame()["frame_id"])
    return out


def main() -> int:
    import faulthandler

    import torch
    from openvslam_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("map_reuse_probe: no CUDA device", file=sys.stderr)
        return 1
    faulthandler.enable(all_threads=True)
    chip_smoke.fail = lambda msg: print(f"map_reuse_probe: gate missed: {msg}", flush=True)
    print(chip_smoke.card_line(), flush=True)
    kernels.build_all()
    dev = torch.device("cuda")
    frames = chip_smoke.system_frames(chip_smoke.system_config().camera)
    if "--publish-ab" in sys.argv[1:]:
        print(json.dumps({"publish_ab": publish_ab(dev, frames)}), flush=True)
        return 0
    out5, _, s, poses = chip_smoke.system_phase(dev, frames=frames)
    out9, counts, rows = chip_smoke.map_reuse_phase(dev, s, frames, poses)
    print(json.dumps({"system": {k: out5[k] for k in ("tracked_share", "ate_sim3_m", "keyframes",
                                                     "landmarks", "track_ms_median_after_40")},
                      "map_reuse": out9, "launches": counts, "kernel_rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
