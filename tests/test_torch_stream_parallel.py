"""Stream-parallel tracking in the port (``parallel/stream_parallel.py``):
4 streams over a device list, each exactly the single-stream FrameStep's
result (the JAX package's test_stream_parallel.py, on the CPU here, where
the streams run one after another; on the card each has its own CUDA
stream, chip_smoke phase 10b)."""
import numpy as np
import pytest
import torch

from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.models.frame_step import FrameStep
from openvslam_tpu_torch.parallel import make_mesh
from openvslam_tpu_torch.parallel.stream_parallel import StreamParallelStep
from openvslam_tpu_torch.utils import synthetic


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stream_parallel_matches_frame_step():
    cam = Perspective(fx=350.0, fy=350.0, cx=160.0, cy=120.0, cols=320, rows=240, fps=30.0)
    fs = FrameStep(cam, max_keypts=400, num_levels=4, lm_capacity=512, device="cpu")
    sp = StreamParallelStep(fs, make_mesh(4, "cpu"))
    assert sp.n_streams == 4

    scene = synthetic.PatchSceneRenderer(np.random.default_rng(9), n_points=400,
                                         center=(0, 0, 6), extent=(4, 3, 2), rows=240, cols=320)
    poses = synthetic.orbit_trajectory(4, radius=2.0, target=(0, 0, 6), arc=np.pi / 8)
    imgs = np.stack([scene.render(cam, p) for p in poses])

    kp0 = fs.frontend.extract(torch.from_numpy(imgs[0]))
    L = 512
    lm_pos = np.zeros((L, 3), np.float32)
    lm_desc = np.zeros((L, 8), np.int32)
    lm_valid = np.zeros(L, bool)
    pc0 = (poses[0][:3, :3] @ scene.points.T).T + poses[0][:3, 3]
    uv0, _, vis0 = (t.numpy() for t in cam.project(torch.from_numpy(pc0.astype(np.float32))))
    kxy, kval = kp0.xy.numpy(), kp0.valid.numpy()
    n = 0
    for i in np.where(vis0)[0]:
        d = np.linalg.norm(kxy - uv0[i], axis=-1)
        d[~kval] = 1e9
        j = int(np.argmin(d))
        if d[j] < 3.0 and n < L:
            lm_pos[n], lm_desc[n], lm_valid[n] = scene.points[i], kp0.desc_u32[j].numpy(), True
            n += 1
    assert n > 15
    lm_lvl = np.full(L, -1, np.int64)

    B = 4
    stacked = (imgs, np.stack([p.astype(np.float32) for p in poses]),
               np.broadcast_to(lm_pos, (B, L, 3)).copy(),
               np.broadcast_to(lm_desc, (B, L, 8)).copy(),
               np.broadcast_to(lm_valid, (B, L)).copy(), np.broadcast_to(lm_lvl, (B, L)).copy())
    with pytest.raises(ValueError, match="streams"):
        sp.shard(*(a[:3] for a in stacked))
    out = sp.step(*sp.shard(*(torch.from_numpy(a) for a in stacked)))
    for i in range(B):
        o1 = fs.step(*(torch.from_numpy(a[i]) for a in stacked))
        for f in o1._fields:
            assert torch.equal(getattr(o1, f), getattr(out, f)[i]), (i, f)
    assert int(out.num_inliers[0]) > 10
