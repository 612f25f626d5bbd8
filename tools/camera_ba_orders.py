"""Whether phase 8's last local BA depends on the order of its sums, on
one CUDA card.

Runs the port's System at chip_smoke phase 8's point (TUM VI's fisheye on
the room lap, ``chip_smoke.fisheye_config_dict``, frames rendered on the
card) ``--runs`` times, keeps each run's last local BA problem and its
result, solves the problem twice more on the card (``index_add_`` sums in
no fixed order) and on the CPU three times (the observations as given and
in two fixed permutations), and prints one JSON line per pair of solutions
with chip_smoke's ``ba_agreement`` verdict (inlier flips, cost and
reprojection differences).

    python tools/camera_ba_orders.py --runs 2
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def permuted(prob, seed: int):
    """``prob`` with its valid observations in a fixed random order, and the
    index that restores the given order."""
    import torch

    n = int(prob.obs_mask.sum())
    idx = torch.arange(len(prob.obs_mask))
    idx[:n] = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    inv = torch.empty_like(idx)
    inv[idx] = torch.arange(len(idx))
    return prob._replace(obs_cam=prob.obs_cam[idx], obs_lm=prob.obs_lm[idx],
                         obs_uv=prob.obs_uv[idx], obs_sigma2=prob.obs_sigma2[idx],
                         obs_mask=prob.obs_mask[idx]), inv


def main(runs: int) -> int:
    import torch
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.optimize.ba import BAResult, make_local_ba
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import synthetic

    if not torch.cuda.is_available():
        print("camera_ba_orders: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    kernels.build_all()
    dev = torch.device("cuda")
    cfg = Config.from_dict(chip_smoke.fisheye_config_dict())
    cam = cfg.camera
    scene, gt = chip_smoke.camera_scene(synthetic, cam)
    imgs, _ = chip_smoke.camera_frames(dev, cam, scene, gt)
    for run in range(runs):
        s = System(cfg, device=dev)
        solve, last = s.mapper.local_ba, []

        def spy(p, solve=solve, last=last):
            r = solve(p)
            last[:] = [(p, r)]
            return r

        s.mapper.local_ba = spy
        for i in range(len(gt)):
            s.feed_monocular_frame(imgs[i], i / cam.fps)
        s.shutdown()
        prob, res = last[0]
        ba = make_local_ba(cam, 5, 10)
        cpu = prob.to("cpu")
        sols = {"card0": BAResult(*(t.cpu() for t in res))}
        for k in (1, 2):
            sols[f"card{k}"] = BAResult(*(t.cpu() for t in ba(prob)))
        sols["cpu0"] = ba(cpu)
        for k in (1, 2):
            p2, inv = permuted(cpu, k)
            r2 = ba(p2)
            sols[f"cpu{k}"] = BAResult(r2.T_cw, r2.X, r2.obs_inlier[inv], r2.cost)
        names = list(sols)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                row = chip_smoke.ba_agreement(cam, cpu, sols[a], sols[b])
                print(json.dumps(dict(run=run, pair=[a, b], ok=row["ok"],
                                      flips=row["inlier_flips"], cost_rel=row["cost_rel_diff"],
                                      reproj_px=row["reproj_max_px"])), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    sys.exit(main(ap.parse_args().runs))
