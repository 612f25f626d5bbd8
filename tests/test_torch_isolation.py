"""The port stands alone and keeps its device rules:

* no module of ``openvslam_tpu_torch/`` (nor ``chip_smoke.py``) imports
  ``jax``, ``flax`` or ``openvslam_tpu``, and importing the package loads
  no JAX and builds no kernel;
* an entry point asked for the default CUDA device on a machine without one
  raises instead of running on the CPU;
* kernel wrappers take the plain version only for CPU tensors and count no
  launch for them; other devices raise;
* the package carries its own descriptor patterns, and a missing one raises.
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
from openvslam_tpu_torch.models.frame_step import FrameStep
from openvslam_tpu_torch.models.frontend import OrbFrontend
from openvslam_tpu_torch.models.track_step import TrackStep
from openvslam_tpu_torch.ops import fast, match, orb, pose_lm

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
            "openvslam_tpu_torch.convert, openvslam_tpu_torch.kernels as k, torch\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', 'openvslam_tpu.')) "
            "or m == 'openvslam_tpu' for m in sys.modules), sorted(sys.modules)\n"
            "assert not k._libs\n"
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
    with pytest.raises(RuntimeError, match="CUDA"):
        TrackStep(cam, fe, lm_capacity=16)


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
    monkeypatch.setitem(orb._PATTERN_ASSETS, "cv", str(tmp_path / "missing.npy"))
    orb.get_pattern_np.cache_clear()
    try:
        with pytest.raises(FileNotFoundError):
            orb.get_pattern_np("cv")
    finally:
        orb.get_pattern_np.cache_clear()
