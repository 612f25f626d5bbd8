"""The port's live web viewer and autosave (``openvslam_tpu_torch/publish/
socket_viewer.py``, ``System.enable_autosave``), as tests/test_socket_viewer.py
holds the JAX package's: a port System served over HTTP on 127.0.0.1 (port
0: a free port), its page, state.json, frame.png and control endpoints;
autosave snapshots a second System loads; the playback controls.  The
autosave writer's exception is counted in ``stats()["worker_exceptions"]``
(the port's rule for worker threads), and ``shutdown`` joins the writer."""
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.publish.socket_viewer import SocketViewer, encode_png
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import synthetic
from openvslam_tpu_torch.utils.datasets import decode_png


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _cfg():
    rows, cols = 240, 320
    return Config.from_dict({
        "Camera": {"name": "t", "setup": "monocular", "model": "perspective",
                   "fx": 260.0, "fy": 260.0, "cx": cols / 2, "cy": rows / 2,
                   "cols": cols, "rows": rows, "fps": 20},
        "Feature": {"max_num_keypts": 400, "num_levels": 3, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})


def _orbit(seed, n, arc):
    cfg = _cfg()
    cam = cfg.camera
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(seed), n_points=500,
                                         center=(0, 0, 6), extent=(5, 4, 2), rows=cam.rows,
                                         cols=cam.cols)
    poses = synthetic.orbit_trajectory(n, radius=2.0, target=(0, 0, 6), arc=arc)
    return cfg, [scene.render(cam, p) for p in poses]


def test_png_encoder_roundtrip_header():
    img = (np.arange(40 * 30) % 256).astype(np.uint8).reshape(30, 40)
    png = encode_png(img)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(png[16:20], "big") == 40
    assert int.from_bytes(png[20:24], "big") == 30
    np.testing.assert_array_equal(decode_png(png), img)
    rgb = np.zeros((5, 7, 3), np.uint8)
    assert encode_png(rgb)[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(encode_png(rgb)), rgb)


def test_live_viewer_serves_session():
    cfg, frames = _orbit(3, 12, np.pi / 6)
    s = System(cfg, device="cpu")
    s.startup()
    viewer = SocketViewer(s, host="127.0.0.1", port=0).start()
    try:
        for i, im in enumerate(frames):
            s.feed_monocular_frame(im, i / 20.0)

        status, ctype, body = _get(viewer.url)
        assert status == 200 and "html" in ctype and b"openvslam_tpu" in body

        status, ctype, body = _get(viewer.url + "state.json")
        assert status == 200
        state = json.loads(body)
        assert state["stats"]["frame_id"] == 11
        assert len(state["kf_centers"]) == len(s.map_db.valid_kf_ids())
        assert state["stats"]["n_landmarks"] == len(s.map_db.valid_lm_ids())
        assert state["cur"] is not None and len(state["cur"]) == 3

        status, ctype, body = _get(viewer.url + "frame.png")
        assert status == 200 and ctype == "image/png"
        assert decode_png(body).shape == (cfg.camera.rows, cfg.camera.cols, 3)

        _, _, body = _get(viewer.url + "control?cmd=toggle_mapping")
        assert json.loads(body)["mapping"] is False
        _, _, body = _get(viewer.url + "control?cmd=toggle_mapping")
        assert json.loads(body)["mapping"] is True
        _, _, body = _get(viewer.url + "control?cmd=toggle_loop")
        assert json.loads(body)["ok"]
        _, _, body = _get(viewer.url + "control?cmd=terminate")
        assert json.loads(body)["terminate"] is True
        _, _, body = _get(viewer.url + "control?cmd=bogus")
        assert json.loads(body)["ok"] is False
    finally:
        viewer.stop()
        s.shutdown()


def test_autosave_snapshots(tmp_path):
    cfg, frames = _orbit(4, 14, np.pi / 5)
    snap = tmp_path / "auto.msg"
    s = System(cfg, device="cpu")
    s.enable_autosave(str(snap), every_n_keyframes=2)
    s.startup()
    for i, im in enumerate(frames):
        s.feed_monocular_frame(im, i / 20.0)
    s.shutdown()                    # joins the writer
    assert s._autosave_thread is not None and not s._autosave_thread.is_alive()
    assert snap.exists() and not os.path.exists(str(snap) + ".tmp")
    assert s.stats()["worker_exceptions"] == 0
    s2 = System(cfg, device="cpu")
    s2.load_map_database(str(snap))
    assert s2.map_db.n_kfs >= 2
    assert len(s2.map_db.valid_lm_ids()) > 50


def test_autosave_writer_fault_is_counted(tmp_path):
    """A snapshot that cannot be written is a counted worker exception with
    its traceback kept, not a lost one; the feed goes on."""
    cfg, frames = _orbit(4, 8, np.pi / 6)
    s = System(cfg, device="cpu")
    s.enable_autosave(str(tmp_path / "missing_dir" / "auto.msg"), every_n_keyframes=1)
    for i, im in enumerate(frames):
        s.feed_monocular_frame(im, i / 20.0)
        s.join_autosave()
    s.shutdown()
    st = s.stats()
    assert st["frames_tracked"] >= 6
    assert st["worker_exceptions"] >= 1
    assert "autosave writer" in st["worker_first_exception"]
    assert "FileNotFoundError" in st["worker_first_exception"]


def test_playback_pause_step_controls():
    class _Sys:
        mapping_enabled = True

        def loop_detector_is_enabled(self):
            return False

    v = SocketViewer(_Sys())
    assert v.wait_if_paused() is True

    out = v.control("playback")
    assert out["ok"] and out["playback_paused"]
    passed = []
    t = threading.Thread(target=lambda: passed.append(v.wait_if_paused()))
    t.start()
    time.sleep(0.15)
    assert not passed, "the feed loop ran through a paused viewer"
    v.control("step")
    t.join(timeout=5)
    assert passed == [True]

    t2 = threading.Thread(target=lambda: passed.append(v.wait_if_paused()))
    t2.start()
    time.sleep(0.15)
    v.control("terminate")
    t2.join(timeout=5)
    assert passed == [True, False]
