"""The port's landmark-sharded BA (``parallel/distributed_ba.py``) against
the JAX package's, on tests/test_ba.py's problem.

* ``partition_problem`` equals JAX's array for array.
* 1 and 8 in-process shards: every pose within 0.02 of the truth and the
  two costs within 5 % of each other (JAX's own gates); each cost within
  a relative 1e-5 of JAX's cost at the same shard count (measured:
  5.6e-7 at 1 shard, 1.1e-7 at 8; the Jacobians are analytic here and
  autodiff there, the sums run in another order).
* Noiseless: every pose within 1e-3 at 8 shards.
* The multi-camera edge through ``res_fn_override`` (autodiff Jacobians)
  against the analytic ``multicam`` path: costs within 1e-4, poses within
  1e-4.
* Two gloo processes (a file store, no port) equal the 2-shard solve in
  one process bit for bit: poses, landmarks and cost.  Each rank's
  ``multihost.shard_to_global`` rows are ``rank_rows`` at its rank, and
  ``multihost.assign_keyframe_ranges`` gives both ranks the same offsets.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from openvslam_tpu.parallel import make_mesh as jax_make_mesh
from openvslam_tpu.parallel import make_distributed_ba as jax_make_distributed_ba
from openvslam_tpu.parallel.distributed_ba import partition_problem as jax_partition_problem
from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.optimize import residuals as R
from openvslam_tpu_torch.optimize.ba import BAProblem
from openvslam_tpu_torch.parallel import make_distributed_ba, make_mesh
from openvslam_tpu_torch.parallel.distributed_ba import partition_problem, rank_rows
from test_ba import _build_problem, _pose_errors

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CAM = Perspective(fx=500.0, fy=500.0, cx=320.0, cy=240.0, cols=640, rows=480)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(prob) -> BAProblem:
    return BAProblem(*(torch.from_numpy(np.array(a)) for a in prob))


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_partition_matches_jax(rng, shards):
    _, prob, *_ = _build_problem(rng, L=512, O=4096)
    ours = partition_problem(_port(prob), shards)
    ref = jax_partition_problem(prob, shards)
    for f, a, b in zip(ours._fields, ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
        assert a.numpy().dtype == np.asarray(b).dtype, f


def test_distributed_matches_single_and_jax(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs conftest's 8 virtual JAX devices")
    jcam, prob, T_true, _, n_cams, _ = _build_problem(rng, L=512, O=4096)
    costs = {}
    for shards in (1, 8):
        T, X, c = make_distributed_ba(CAM, make_mesh(shards, "cpu"), iters=10)(
            partition_problem(_port(prob), shards))
        e = _pose_errors(T.numpy(), T_true, n_cams)
        assert e.max() < 0.02, (shards, e)
        assert X.shape == (512, 3) and torch.isfinite(X).all()
        _, _, cj = jax_make_distributed_ba(jcam, jax_make_mesh(shards), iters=10)(
            jax_partition_problem(prob, shards))
        assert abs(float(c) - float(cj)) / float(cj) < 1e-5, (shards, float(c), float(cj))
        costs[shards] = float(c)
    assert abs(costs[1] - costs[8]) / max(costs[1], 1e-9) < 0.05


def test_distributed_ba_converges_noiseless(rng):
    _, prob, T_true, _, n_cams, _ = _build_problem(rng, L=512, O=4096, noise_px=0.0)
    T, _, _ = make_distributed_ba(CAM, make_mesh(8, "cpu"), iters=12)(
        partition_problem(_port(prob), 8))
    errs = _pose_errors(T.numpy(), T_true, n_cams)
    assert errs.max() < 1e-3, errs


def test_override_residual_matches_analytic_multicam(rng):
    _, prob, *_ = _build_problem(rng, n_lms=120, C=8, L=128, O=1024)
    p = _port(prob)
    camv = torch.from_numpy(R.make_camv(dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                             cols=640, rows=480)))
    p = p._replace(obs_uv=torch.cat([p.obs_uv, camv.expand(p.obs_uv.shape[0], -1)], 1))
    sp = partition_problem(p, 2)
    mesh = make_mesh(2, "cpu")
    Ta, Xa, ca = make_distributed_ba(None, mesh, iters=4, multicam=True)(sp)
    To, Xo, co = make_distributed_ba(
        None, mesh, iters=4, res_fn_override=R.make_multicam_mono_residual())(sp)
    assert abs(float(ca) - float(co)) / float(ca) < 1e-4, (float(ca), float(co))
    np.testing.assert_allclose(To.numpy(), Ta.numpy(), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def gloo_pair(tmp_path_factory):
    """Two gloo processes (``tests/test_torch_multihost.py ba``) solve
    tests/test_ba.py's problem at 2 shards; each saves its solve, its
    ``shard_to_global`` rows and its ``assign_keyframe_ranges`` offsets."""
    tmp = tmp_path_factory.mktemp("gloo_pair")
    _, prob, *_ = _build_problem(np.random.default_rng(7), L=512, O=4096)
    p = _port(prob)
    np.savez(tmp / "prob.npz", iters=6, **{f: t.numpy() for f, t in zip(p._fields, p)})
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "test_torch_multihost.py"),
                               "ba", str(r), "2", str(tmp / "store"), str(tmp / "prob.npz"),
                               str(tmp / "out.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    for q in procs:
        try:
            logs.append(q.communicate(timeout=300)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for k in procs:
                k.kill()
            raise
    for q, log in zip(procs, logs):
        assert q.returncode == 0, log[-3000:]
    return p, [np.load(tmp / f"out{r}.npz") for r in range(2)]


def test_two_gloo_processes_equal_two_shards(gloo_pair):
    p, got = gloo_pair
    T, X, c = make_distributed_ba(CAM, make_mesh(2, "cpu"), iters=6)(partition_problem(p, 2))
    for g in got:
        np.testing.assert_array_equal(g["T"], T.numpy())
        np.testing.assert_array_equal(g["X"], X.numpy())
        assert g["cost"] == c.numpy()


def test_two_gloo_processes_shard_rows_and_keyframe_ranges(gloo_pair):
    """Each rank's ``shard_to_global`` rows are ``rank_rows`` at its rank,
    and both ranks agree on the keyframe offsets of counts 3 and 4."""
    p, got = gloo_pair
    sp = partition_problem(p, 4)
    for r, g in enumerate(got):
        mine = rank_rows(sp, 4, 2, r)
        for f, a in zip(mine._fields, mine):
            np.testing.assert_array_equal(g[f"rows_{f}"], a.numpy(), err_msg=f)
        assert g["rows_X"].shape == (sp.X.shape[0] // 2, 3)
        np.testing.assert_array_equal(g["kf_offsets"], [0, 3, 7])
