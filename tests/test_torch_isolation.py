"""The port stands alone and keeps its device rules:

* no module of ``openvslam_tpu_torch/`` (nor ``chip_smoke.py``) imports
  ``jax``, ``flax`` or ``openvslam_tpu``, and importing the package loads
  no JAX and builds no kernel;
* an entry point asked for the default CUDA device on a machine without one
  raises instead of running on the CPU;
* kernel wrappers take the plain version only for CPU tensors and count no
  launch for them; other devices raise;
* the package carries its own descriptor patterns and vocabularies, and a
  missing one raises;
* the System runs with loop detection on (the config's default), takes
  perspective and fisheye cameras of any setup and the (always monocular)
  equirectangular camera, and refuses an unknown camera model with the
  JAX factory's ValueError instead of ignoring it;
* no module names a path outside the package (its native source and build
  live inside it), and a failed native build raises instead of falling
  back to Python;
* ``Config.from_dict`` needs no PyYAML.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import openvslam_tpu_torch
from openvslam_tpu_torch import kernels
from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.data import bow
from openvslam_tpu_torch.models.frame_step import FrameStep
from openvslam_tpu_torch.models.frontend import OrbFrontend
from openvslam_tpu_torch.models.track_step import TrackStep
from openvslam_tpu_torch.ops import fast, match, orb, pose_lm
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import native, stereo_rectifier

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(openvslam_tpu_torch.__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "openvslam_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_no_jax_imports_in_port():
    sources = _port_sources()
    assert len(sources) >= 20
    bad = [(p, m) for p in sources for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


def test_import_loads_no_jax_and_builds_nothing():
    code = ("import sys, openvslam_tpu_torch, openvslam_tpu_torch.models.track_step, "
            "openvslam_tpu_torch.convert, openvslam_tpu_torch.system, "
            "openvslam_tpu_torch.kernels as k, openvslam_tpu_torch.utils.native as nat, torch\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', 'openvslam_tpu.')) "
            "or m == 'openvslam_tpu' for m in sys.modules), sorted(sys.modules)\n"
            "assert not k._libs and nat._lib is None\n"
            "assert 'yaml' not in sys.modules\n"
            "assert torch.backends.cudnn.allow_tf32 is False\n"
            "assert torch.backends.cuda.matmul.allow_tf32 is False\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=120)


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = Perspective(fx=100.0, fy=100.0, cx=32.0, cy=24.0, cols=64, rows=48)
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameStep(cam, max_keypts=64, num_levels=2, lm_capacity=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        OrbFrontend(48, 64, max_keypts=64, num_levels=2)
    fe = OrbFrontend(48, 64, max_keypts=64, num_levels=2, device="cpu")
    for mode in ("mono", "stereo", "rgbd"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TrackStep(cam, fe, lm_capacity=16, mode=mode)
    raw = {"StereoRectifier": {"K_left": [100, 0, 32, 0, 100, 24, 0, 0, 1], "D_left": [0] * 5,
                               "K_right": [100, 0, 32, 0, 100, 24, 0, 0, 1], "D_right": [0] * 5}}
    with pytest.raises(RuntimeError, match="CUDA"):
        stereo_rectifier.StereoRectifier(cam, raw)
    assert stereo_rectifier.StereoRectifier(cam, raw, device="cpu").map_l.device.type == "cpu"


def test_wrappers_dispatch_by_device(rng):
    before = kernels.launch_counts()
    img = torch.from_numpy(rng.integers(0, 255, (32, 40)).astype(np.float32))
    vals, idxs = fast.fast_cell_pools([img], 20.5, 7.0, [16])   # any threshold on the CPU
    assert vals.shape == idxs.shape == (1, 2 * 33)
    assert kernels.launch_counts() == before
    meta = torch.empty((8, 8), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        fast.fast_cell_pools([meta], 20.0, 7.0, [16])
    d = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        match.projection_scale_match(d, d, *[torch.empty(4, device="meta")] * 7)
    with pytest.raises(RuntimeError, match="unsupported device"):
        pose_lm.pose_lm(torch.eye(4), torch.empty((4, 3), device="meta"), None, None, None,
                        fx=1.0, fy=1.0, cx=0.0, cy=0.0, fxb=0.0, chi2_thr=5.991)


def test_pattern_assets_are_the_ports_own(monkeypatch, tmp_path):
    ours = orb.get_pattern_np("learned")
    ref = np.load(os.path.join(ROOT, "openvslam_tpu", "assets", "brief_pattern.npy"))
    np.testing.assert_array_equal(ours, ref.astype(np.float32))
    assert orb._PATTERN_ASSETS["learned"].startswith(PKG)
    # the default vocabularies (one per pattern) are read from the package
    for pattern, path in bow.VOCAB_ASSETS.items():
        assert path.startswith(os.path.join(PKG, "assets") + os.sep)
        voc = bow.default_vocabulary(pattern=pattern)
        ref = np.load(os.path.join(ROOT, "assets", os.path.basename(path)))
        np.testing.assert_array_equal(voc.centers_i8, ref["centers"].astype(np.int8))
        np.testing.assert_array_equal(voc.idf, ref["idf"])
    monkeypatch.setitem(orb._PATTERN_ASSETS, "cv", str(tmp_path / "missing.npy"))
    monkeypatch.setitem(bow.VOCAB_ASSETS, "cv", str(tmp_path / "missing.npz"))
    orb.get_pattern_np.cache_clear()
    try:
        with pytest.raises(FileNotFoundError):
            orb.get_pattern_np("cv")
        with pytest.raises(FileNotFoundError):
            bow.default_vocabulary(pattern="cv")
    finally:
        orb.get_pattern_np.cache_clear()


def _small_config(**extra):
    return {"Camera": {"name": "tiny", "setup": "monocular", "model": "perspective",
                       "fx": 100.0, "fy": 100.0, "cx": 32.0, "cy": 24.0, "cols": 64, "rows": 48},
            "Feature": {"max_num_keypts": 64, "num_levels": 2},
            "LoopDetector": {"enabled": False}, **extra}


def test_system_refuses_missing_cuda_and_unported_features(monkeypatch):
    on = System(Config.from_dict(_small_config(LoopDetector={"enabled": True})), device="cpu")
    assert on.loop_detector_is_enabled() and not on.loop_BA_is_running()
    default = {k: v for k, v in _small_config().items() if k != "LoopDetector"}
    s = System(Config.from_dict(default), device="cpu")
    assert s.loop_detector_is_enabled()
    s.startup()
    assert s.feed_monocular_frame(np.zeros((48, 64), np.uint8), 0.0) is None
    s.shutdown()
    for model in ("fisheye", "equirectangular"):
        cam = dict(_small_config()["Camera"], model=model)
        assert System(Config.from_dict(_small_config(Camera=cam)),
                      device="cpu").cam.model_name == model
    cam = dict(_small_config()["Camera"], model="omnidirectional")
    with pytest.raises(ValueError, match="omnidirectional"):
        System(Config.from_dict(_small_config(Camera=cam)), device="cpu")
    cam = dict(_small_config()["Camera"], model="equirectangular", setup="stereo")
    s = System(Config.from_dict(_small_config(Camera=cam)), device="cpu")
    assert s.cam.setup.value == "monocular" and s._track_step.mode == "mono"
    assert System(Config.from_dict(_small_config()), device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for setup in ("monocular", "stereo", "rgbd"):
        cam = dict(_small_config()["Camera"], setup=setup, focal_x_baseline=10.0)
        with pytest.raises(RuntimeError, match="CUDA"):
            System(Config.from_dict(_small_config(Camera=cam)))


def test_port_names_no_path_outside_its_package():
    """Every absolute path a port module holds (source, build and asset
    locations) lies inside the package, and no source spells a path into
    the JAX package's tree (``native/``, ``openvslam_tpu/``)."""
    import importlib
    import pkgutil

    held = 0
    for info in pkgutil.walk_packages(openvslam_tpu_torch.__path__, "openvslam_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, value in vars(mod).items():
            for v in value.values() if isinstance(value, dict) else [value]:
                if isinstance(v, str) and os.path.isabs(v):
                    held += 1
                    real = os.path.realpath(v)
                    assert real == PKG or real.startswith(PKG + os.sep), (info.name, name, v)
    assert held >= 5        # kernels' csrc and build, native's source and build, assets
    for path in _port_sources()[1:]:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                v = node.value
                assert v != "native" and "native/" not in v and ".." not in v.split("/"), (path, v)
    assert native.SRC.startswith(PKG) and native.lib_path().startswith(PKG)


def test_native_build_fails_loudly(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    descs = np.zeros((3, 8), np.uint32)
    with pytest.raises(RuntimeError, match="native build"):
        native.min_median_hamming(descs)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="native build"):
        native.min_median_hamming(descs)
    assert native._lib is None and not list(tmp_path.glob("*.so"))


def test_config_needs_no_yaml(tmp_path):
    code = ("import sys\nsys.modules['yaml'] = None\n"
            "from openvslam_tpu_torch.config import Config\n"
            f"cfg = Config.from_dict({_small_config()!r})\n"
            "assert cfg.camera.cols == 64 and not cfg.loop.enabled\n"
            "try:\n    Config.from_yaml('missing.yaml')\nexcept ImportError:\n    pass\n"
            "else:\n    raise SystemExit('from_yaml ran without PyYAML')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=tmp_path, env=env, timeout=120)
