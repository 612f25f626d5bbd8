"""Shared command-line plumbing of the PyTorch port's example runners, the
counterparts of ``examples/`` (the reference's ``example/run_*_slam.cc``
flags: --vocab, --setting, the dataset directory, --mask, --frame-skip,
--no-sleep, --auto-term, --debug, --eval-log, --map-db in and out), plus
--device: the System runs on the CUDA card unless ``--device cpu`` is
given.

A setting is a JSON file (``configs/*.json``) read into
``Config.from_dict``; a YAML setting is read with PyYAML where it is
installed."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("-v", "--vocab", default="default",
                   help="vocabulary file (.npz / ORBvoc.txt / .dbow2) or 'default' or 'none'")
    p.add_argument("-s", "--setting", required=True,
                   help="config JSON (configs/*.json); YAML where PyYAML is installed")
    p.add_argument("--mask", default=None, help="mask image (png/pgm)")
    p.add_argument("--frame-skip", type=int, default=1)
    p.add_argument("--no-sleep", action="store_true")
    p.add_argument("--auto-term", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--eval-log", action="store_true",
                   help="dump frame_trajectory.txt + track_times.txt")
    p.add_argument("--map-db-in", default=None)
    p.add_argument("--map-db-out", default=None)
    p.add_argument("--map-format", default="native", choices=["native", "openvslam"],
                   help="--map-db-out schema: fast columnar (native) or the reference's "
                        "msgpack layout (openvslam); loading auto-detects either")
    p.add_argument("--traj-out", default="frame_trajectory.txt")
    p.add_argument("--traj-format", default="TUM", choices=["TUM", "KITTI"])
    p.add_argument("--viewer", action="store_true",
                   help="serve the live web viewer (ref socket_publisher)")
    p.add_argument("--viewer-port", type=int, default=7007)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (Chrome trace JSON) to DIR")
    p.add_argument("--auto-save", default=None, metavar="PATH",
                   help="periodic async map snapshots to PATH")
    p.add_argument("--sync-mapping", action="store_true",
                   help="run mapping inline with tracking (default: own thread, the "
                        "reference's 3-module concurrency)")
    p.add_argument("--pipeline", action="store_true",
                   help="software-pipelined feeding (frame N+1's device step overlaps "
                        "frame N's bookkeeping)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="frames kept in flight with --pipeline")
    p.add_argument("--device", default="cuda",
                   help="torch device of the System (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    return p


def load_config(path: str):
    """The setting at ``path``: JSON through ``Config.from_dict``; YAML
    through ``Config.from_yaml`` where PyYAML imports, else an exit that
    names the JSON route."""
    from openvslam_tpu_torch.config import Config

    if path.endswith((".yaml", ".yml")):
        try:
            import yaml  # noqa: F401
        except ImportError:
            twin = os.path.splitext(path)[0] + ".json"
            raise SystemExit(
                f"{path} is YAML, and reading it needs PyYAML, which is not installed: "
                f"pass a JSON setting instead (-s {twin}; configs/*.json hold the JSON "
                f"twins of configs/*.yaml)") from None
        return Config.from_yaml(path)
    with open(path) as f:
        return Config.from_dict(json.load(f))


def device_line(device) -> str:
    """The torch device, and the card's name where it is a CUDA device."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def build_system(args):
    import logging

    import torch

    from openvslam_tpu_torch.system import System

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    cfg = load_config(args.setting)
    vocab = None if args.vocab == "none" else args.vocab
    system = System(cfg, vocab_path=vocab,
                    async_mapping=not getattr(args, "sync_mapping", False),
                    device=args.device)
    if getattr(args, "mask", None):
        # reference convention (run_*_slam --mask): nonzero pixels = extract
        from openvslam_tpu_torch.utils.datasets import _imread_gray
        m = _imread_gray(args.mask)
        if m.shape != (cfg.camera.rows, cfg.camera.cols):
            raise SystemExit(f"mask shape {m.shape} != camera "
                             f"({cfg.camera.rows}, {cfg.camera.cols})")
        system.add_mask(m)      # merged with mask_rectangles
    if args.map_db_in:
        system.load_map_database(args.map_db_in)
        system.disable_mapping_module()
    system.startup(need_initialize=not args.map_db_in)
    # the runner's own live viewer and profiler, kept on its arguments
    args.live_viewer = args.live_profiler = None
    if getattr(args, "viewer", False):
        from openvslam_tpu_torch.publish import SocketViewer
        args.live_viewer = SocketViewer(system, port=args.viewer_port).start()
        print(f"live viewer at {args.live_viewer.url}")
    if getattr(args, "auto_save", None):
        system.enable_autosave(args.auto_save)
    if getattr(args, "profile", None):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if system.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        args.live_profiler = torch.profiler.profile(activities=acts)
        args.live_profiler.start()
    print(f"device: {device_line(system.device)}")
    return cfg, system


def frame_gate(args) -> bool:
    """Honor the live viewer's playback controls each frame (ref
    pangolin_viewer: the example loop checks pause/step/terminate).
    Returns False when the loop should stop feeding."""
    v = getattr(args, "live_viewer", None)
    return True if v is None else v.wait_if_paused()


def feed_loop(args, system, items, kind: str):
    """Feed a sequence of per-frame tuples (see System.feed_sequence for the
    shapes per kind).  Honors the viewer's playback gate each frame.  With
    --pipeline the software-pipelined System.feed_sequence is used; the
    classic per-frame API otherwise.  Returns per-frame wall times."""
    times = []
    if getattr(args, "pipeline", False):
        def gated():
            for it in items:
                if not frame_gate(args):
                    return
                yield it
        t_last = time.perf_counter()
        for _ts, _pose in system.feed_sequence(gated(), kind=kind,
                                               depth=getattr(args, "pipeline_depth", 1)):
            now = time.perf_counter()
            times.append(now - t_last)
            t_last = now
        return times
    feed = {"monocular": system.feed_monocular_frame,
            "stereo": system.feed_stereo_frame,
            "rgbd": system.feed_RGBD_frame}[kind]
    for it in items:
        if not frame_gate(args):
            break
        with Timer() as t:
            feed(*it)
        times.append(t.dt)
    return times


def finish(args, system, track_times):
    prof = getattr(args, "live_profiler", None)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    if getattr(args, "live_viewer", None) is not None:
        args.live_viewer.stop()
    system.shutdown()
    system.save_frame_trajectory(args.traj_out, args.traj_format)
    if args.eval_log:
        with open("track_times.txt", "w") as f:
            f.writelines(f"{t:.9f}\n" for t in track_times)
    if args.map_db_out:
        system.save_map_database(args.map_db_out, format=args.map_format)
    tt = np.array(track_times)
    if len(tt):
        print(f"median tracking time: {np.median(tt)*1000:.1f} ms "
              f"({1.0/np.median(tt):.1f} fps)")
        print(f"mean tracking time:   {tt.mean()*1000:.1f} ms")


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.dt = time.perf_counter() - self.t0
