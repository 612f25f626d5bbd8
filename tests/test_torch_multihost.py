"""Two processes, one gloo group on the CPU (a file store, no port), each
with a stereo session of its own (the JAX package's
test_multi_session_multihost.py scene), then one pooled BA across them
(``parallel/multi_session_multihost.py``):

* each session tracks >= 0.8 of its frames and builds a map;
* both ranks assemble the identical global problem;
* the 2-process solve equals the 2-shard solve of that problem in one
  process bit for bit (poses, landmarks, cost);
* each rank writes back exactly its own sessions' rows of the solve, at
  its camera and landmark offsets.

Run as a script, this file is one rank of such a group (it imports no
JAX); tests/test_torch_distributed_ba.py starts it in its ``ba`` mode:

    python test_torch_multihost.py ba <rank> <world> <store> <problem.npz> <out.npz>
    python test_torch_multihost.py sessions <rank> <world> <store> <out.npz>

``ba``: solve the BAProblem saved in problem.npz with the distributed BA
over the group (one shard per rank); every rank saves T, X and the cost,
its ``shard_to_global`` rows of the problem at two shards a rank, and the
``assign_keyframe_ranges`` offsets of counts 3 + rank (out<rank>.npz).
``sessions``: run one small stereo session of its own (the JAX package's
multisession_multihost_worker.py scene, a track of its own per rank), then
one pooled BA over the group (``MultihostSessionPool``); every rank saves
its global problem, the solve and its session's map after the write-back.
The rendezvous is a file store (``file://<store>``): no port is opened.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openvslam_tpu_torch.camera import Perspective  # noqa: E402
from openvslam_tpu_torch.optimize.ba import BAProblem  # noqa: E402
from openvslam_tpu_torch.parallel import make_distributed_ba, make_mesh, multihost  # noqa: E402
from openvslam_tpu_torch.parallel.distributed_ba import partition_problem  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_process_sessions_pooled_ba(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = tmp_path / "rank.npz"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "sessions", str(r), "2", str(tmp_path / "store"), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    for q in procs:
        try:
            logs.append(q.communicate(timeout=600)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for k in procs:
                k.kill()
            raise
    for q, log in zip(procs, logs):
        assert q.returncode == 0, log[-3000:]
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r in res:
        assert r["tracked"].mean() >= 0.8, r["tracked"]
        assert len(r["kf_slot"]) >= 2 and len(r["lm_slot"]) >= 50
        assert np.isfinite(r["cost"]) and r["cost"] == r["cost2"]
    # the same global problem and the same solve on both ranks
    for f in BAProblem._fields:
        np.testing.assert_array_equal(res[0][f"prob_{f}"], res[1][f"prob_{f}"], err_msg=f)
    for f in ("T_out", "X_out", "cam_off", "lm_off"):
        np.testing.assert_array_equal(res[0][f], res[1][f], err_msg=f)
    # ... equal to the 2-shard solve in one process
    prob = BAProblem(*(torch.from_numpy(res[0][f"prob_{f}"]) for f in BAProblem._fields))
    assert prob.obs_uv.shape[1] == 3
    cam = Perspective(fx=260.0, fy=260.0, cx=160.0, cy=120.0, cols=320, rows=240,
                      focal_x_baseline=260.0 * 0.12)
    T, X, c = make_distributed_ba(cam, make_mesh(2, "cpu"), stereo=True, iters=8)(
        partition_problem(prob, 2))
    np.testing.assert_array_equal(res[0]["T_out"], T.numpy())
    np.testing.assert_array_equal(res[0]["X_out"], X.numpy())
    assert res[0]["cost"] == float(c)
    # each rank's map holds its own rows of the solve (fixed keyframes keep
    # their pose)
    cam_opt = res[0]["prob_cam_opt"]
    for rank, r in enumerate(res):
        rows = r["cam_off"][rank] + r["kf_slot"]
        moved = cam_opt[rows]
        assert moved.any()
        np.testing.assert_array_equal(r["kf_pose"][moved], r["T_out"][rows[moved]])
        np.testing.assert_array_equal(r["lm_pos"], r["X_out"][r["lm_off"][rank] + r["lm_slot"]])


# ---- one rank of the group, run as a script ------------------------------

def _rank_ba(rank, world, problem, out):
    data = np.load(problem)
    prob = BAProblem(*(torch.from_numpy(data[f]) for f in BAProblem._fields))
    cam = Perspective(fx=500.0, fy=500.0, cx=320.0, cy=240.0, cols=640, rows=480)
    opt = make_distributed_ba(cam, ["cpu"], group=torch.distributed.group.WORLD,
                              iters=int(data["iters"]))
    T, X, cost = opt(partition_problem(prob, world))
    rows = multihost.shard_to_global(partition_problem(prob, 2 * world), 2 * world)
    offsets = multihost.assign_keyframe_ranges(3 + rank)
    np.savez(out, T=T.numpy(), X=X.numpy(), cost=cost.numpy(), kf_offsets=offsets,
             **{f"rows_{f}": a.numpy() for f, a in zip(rows._fields, rows)})


def _rank_sessions(rank, out):
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.parallel.multi_session_multihost import MultihostSessionPool
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import synthetic

    rows, cols, baseline = 240, 320, 0.12
    cfg = Config.from_dict({
        "Camera": {"name": "synthetic", "setup": "stereo", "model": "perspective",
                   "fx": 260.0, "fy": 260.0, "cx": cols / 2, "cy": rows / 2,
                   "cols": cols, "rows": rows, "fps": 10,
                   "focal_x_baseline": 260.0 * baseline, "depth_threshold": 40.0},
        "Feature": {"max_num_keypts": 400, "num_levels": 3, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})
    cam = cfg.camera
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(100 + rank), x_range=(-4, 12),
                                         y_range=(-5, 5), plane_z=7.0, rows=rows, cols=cols)
    n = 16
    xs = np.linspace(0.0, 3.0, n) + 4.0 * rank           # a track of its own per rank
    poses = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7)) for x in xs])
    shift = np.eye(4)
    shift[0, 3] = -baseline
    frames = [(scene.render(cam, p), scene.render(cam, shift @ p), i / 10.0)
              for i, p in enumerate(poses)]
    s = System(cfg, device="cpu")
    pool = MultihostSessionPool([s])
    tracked = pool.run_local([frames])
    gp = pool.global_problem()
    cost = pool.joint_bundle_adjust(iters=8)
    s.shutdown()
    # the solve the pool wrote back, again (deterministic: the same bits)
    _, solve = multihost.make_multihost_ba(cam, torch.device("cpu"), stereo=gp["stereo"],
                                           iters=8, multicam=gp["multicam"])
    T_out, X_out, cost2 = solve(gp["prob"])
    per = gp["local"]["per_session"][0]
    kf_ids = sorted(per["cam_index"])
    lm_ids = sorted(per["lm_index"])
    db = s.map_db
    np.savez(out, tracked=np.asarray(tracked[0]), cost=cost, cost2=cost2,
             cam_off=gp["cam_off"], lm_off=gp["lm_off"], T_out=T_out, X_out=X_out,
             kf_slot=np.asarray([per["cam_index"][k] for k in kf_ids]),
             lm_slot=np.asarray([per["lm_index"][l] for l in lm_ids]),
             kf_pose=np.stack([db.kf_pose_cw[k] for k in kf_ids]),
             lm_pos=np.stack([db.lm_pos[l] for l in lm_ids]),
             **{f"prob_{f}": getattr(gp["prob"], f).numpy() for f in BAProblem._fields})


def _rank_main():
    mode, rank, world, store = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, device="cpu")
    try:
        if mode == "ba":
            _rank_ba(rank, world, sys.argv[5], sys.argv[6].replace(".npz", f"{rank}.npz"))
        else:
            _rank_sessions(rank, sys.argv[5].replace(".npz", f"{rank}.npz"))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    _rank_main()
