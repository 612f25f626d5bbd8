"""The port's pipelined feed beyond depth 1, held to the gates of
tests/test_pipeline_feed.py: depth 2 (a three-frame-stale map, lead-3
prediction) keeps tracking and ATE(sim3) in class, and blank frames
mid-sequence force the Lost path, after which the feed drains, takes the
classic ladder and keeps yielding in order.  Also the sequence kinds:
an empty stereo or RGB-D sequence yields nothing on a System of that
setup, and an unknown kind raises.
"""
import numpy as np
import pytest
import torch

from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.system import System
from test_torch_async_pipeline import make_config, render_sequence, sim3_ate


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's worker processes share the cores
    (see tests/test_torch_system.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_depth2_pipeline_quality():
    cfg = make_config()
    images, poses_gt = render_sequence(cfg)
    s = System(cfg, device="cpu")
    s.startup()
    out = list(s.feed_sequence(((img, i / 20.0) for i, img in enumerate(images)), depth=2))
    s.shutdown()
    n = len(images)
    assert len(out) == n
    tracked = sum(p is not None for _, p in out)
    assert tracked > 0.85 * n, f"tracked {tracked}/{n}"
    assert s._fused_frames > 0.7 * n
    ate = sim3_ate(s, poses_gt)
    assert ate < 0.12, f"depth-2 ATE {ate:.3f} m"


def test_pipeline_survives_lost_and_reinit():
    """Blank frames mid-sequence force the Lost path: the pipeline drains,
    falls back to the classic ladder and keeps yielding in order."""
    cfg = make_config()
    images, _ = render_sequence(cfg, n_frames=30)
    blank = np.zeros_like(images[0])
    seq = images[:18] + [blank, blank, blank] + images[18:]
    s = System(cfg, device="cpu")
    s.startup()
    out = list(s.feed_sequence(((img, i / 20.0) for i, img in enumerate(seq)),
                               kind="monocular"))
    s.shutdown()
    assert len(out) == len(seq)
    np.testing.assert_allclose([t for t, _ in out], np.arange(len(seq)) / 20.0)
    for _, p in out[18:21]:
        assert p is None          # blanks cannot be tracked
    assert any(p is not None for _, p in out[:18])


def test_refuses_other_sequence_kinds():
    for kind, setup in (("stereo", "stereo"), ("rgbd", "rgbd")):
        cfg = make_config()
        cfg = Config.from_dict(dict(cfg.raw, Camera=dict(cfg.raw["Camera"], setup=setup,
                                                         focal_x_baseline=35.0)))
        s = System(cfg, device="cpu")
        assert s.feed_kind() == kind
        assert list(s.feed_sequence(iter([]), kind=kind)) == []
        assert s.frame_id == 0 and not s.trajectory
    s = System.__new__(System)
    with pytest.raises(ValueError):
        next(s.feed_sequence(iter([]), kind="thermal"))
