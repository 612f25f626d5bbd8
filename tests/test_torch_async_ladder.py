"""The classic ladder on the same inputs in both packages.

The JAX System with synchronous mapping feeds the organic lap
(tests/test_organic_loop.py's room and path at its 320x240 point) through
``feed_sequence(depth=3)``.  Its fused steps collapse at frames 2-5, 21-24,
27-31 and 42, and each of those frames goes through the classic ladder
(motion match, BoW match against the reference keyframe, the last-frame
fallback, the wide local-map rescue and its weak acceptance).  Just before
JAX's ladder runs on such a frame, the port's ladder runs on the same
state: the JAX map carried across by ``convert``, the same tracker fields
and the same frame.  At frame 42 both ladders fall through to the rescue,
which JAX accepts as weak (12-19 inliers that agree with the prediction).

Tolerances: the stage-by-stage counts (matches, inliers) identical, the
same accept or loss, the pose within 1e-3 (float32 pose optimization).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from openvslam_tpu.config import Config as JaxConfig
from openvslam_tpu.data import Frame as JaxFrame
from openvslam_tpu.system import System as JaxSystem
from openvslam_tpu.utils import synthetic as jsyn
from openvslam_tpu_torch import convert
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.data import Frame
from openvslam_tpu_torch.data.bow import default_vocabulary
from openvslam_tpu_torch.module import relocalizer as reloc
from openvslam_tpu_torch.module.tracking_module import TrackerState, TrackingModule

ROWS, COLS = 240, 320
FRAMES = 43
STAGES = ("_motion_match", "_bow_match_ref_kf", "_fallback_match_last_frame",
          "_rescue_with_local_map", "_pose_optimize", "_track_local_map")
CARRIED = ("velocity", "ref_kf", "frames_since_reloc", "num_tracked", "_peak_tracked",
           "last_kf_frame_id")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict():
    return {"Camera": {"name": "lap", "setup": "monocular", "model": "perspective",
                       "fx": 260.0, "fy": 260.0, "cx": COLS / 2, "cy": ROWS / 2,
                       "cols": COLS, "rows": ROWS, "fps": 20},
            "Feature": {"max_num_keypts": 500, "num_levels": 3, "scale_factor": 1.2},
            "LoopDetector": {"enabled": True, "min_continuity": 2}}


def _spy(tracker, log):
    """Record each ladder stage's count (matches, or inliers of a pose)."""
    for name in STAGES:
        fn = getattr(tracker, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            log.append((_name, int(out[1]) if isinstance(out, tuple) else int(out)))
            return out

        setattr(tracker, name, wrapped)


def _port_frame(jframe):
    return Frame(**{f.name: copy.deepcopy(getattr(jframe, f.name))
                    for f in dataclasses.fields(JaxFrame)})


@pytest.fixture(scope="module")
def ladders():
    """{frame id: (JAX stages, port stages, JAX pose, port pose)} for every
    frame that went through JAX's classic ladder."""
    jcfg = JaxConfig.from_dict(_cfg_dict())
    cam = jcfg.camera
    scene = jsyn.RoomSceneRenderer(np.random.default_rng(7), half=10.0, rows=ROWS, cols=COLS,
                                   n_walls=8)
    gt = jsyn.lap_trajectory(200, radius=6.0, laps=200 / 180)
    s = JaxSystem(jcfg, vocab_path="default")
    s.startup()
    jt = s.tracker
    pcfg = Config.from_dict(_cfg_dict())
    vocab = default_vocabulary()
    jlog, out = [], {}
    _spy(jt, jlog)
    jax_ladder = jt._track_frame

    def both(frame):
        db = convert.map_database_from_state(convert.map_state(s.map_db))
        bow = convert.bow_database_from_state(convert.bow_state(s.global_optimizer.bow_db),
                                              vocab, db)
        pt = TrackingModule(pcfg, pcfg.camera, db, mapper=None,
                            relocalizer=reloc.Relocalizer(pcfg, pcfg.camera, db, bow,
                                                          device="cpu"),
                            device="cpu")
        for name in CARRIED:
            setattr(pt, name, copy.deepcopy(getattr(jt, name)))
        pt.state = TrackerState.TRACKING
        pt.last_frame = _port_frame(jt.last_frame)
        plog = []
        _spy(pt, plog)
        ppose = pt._track_frame(_port_frame(frame))
        del jlog[:]
        jpose = jax_ladder(frame)
        out[int(frame.frame_id)] = (list(jlog), plog, jpose, ppose)
        return jpose

    jt._track_frame = both
    items = ((scene.render(cam, gt[i]), i / 20.0) for i in range(FRAMES))
    tracked = [p is not None for _, p in s.feed_sequence(items, depth=3)]
    s.shutdown()
    assert all(tracked[1:]), tracked
    return out


def test_ladder_frames_are_the_collapses(ladders):
    assert {2, 3, 4, 5, 21, 22, 23, 24, 42} <= set(ladders)


@pytest.mark.parametrize("which", ["frame 42", "every ladder frame"])
def test_ladder_matches_jax_on_the_same_inputs(ladders, which):
    frames = [42] if which == "frame 42" else sorted(ladders)
    for f in frames:
        jstages, pstages, jpose, ppose = ladders[f]
        assert pstages == jstages, (f, pstages, jstages)
        assert (ppose is None) == (jpose is None), f
        if jpose is not None:
            np.testing.assert_allclose(ppose, np.asarray(jpose), atol=1e-3, err_msg=str(f))
    if which == "frame 42":
        # the wide local-map rescue ran and its thin inlier set was taken
        jstages = ladders[42][0]
        assert jstages[-1][0] == "_rescue_with_local_map"
        assert 12 <= jstages[-1][1] < 20
        assert ladders[42][2] is not None
