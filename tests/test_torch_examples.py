"""The port's example runners (``examples_torch/``), its JSON settings
(``configs/*.json``) and its user tools (``tools/train_vocab_torch.py``,
``tools/evaluate_trajectory_torch.py``) on the CPU (``--device cpu``):

* the synthetic runner, monocular and stereo at a small size, through
  ``--traj-out`` and ``--viewer-out``;
* each dataset runner's argument path on tiny dataset trees written under
  ``tmp_path`` in the layouts tests/test_torch_io_datasets.py writes (TUM,
  KITTI, EuRoC, an image directory), with a JSON setting, through
  ``--map-db-out`` and then ``--map-db-in`` of the saved map;
* the video and camera runners exit with a message when OpenCV is absent,
  and a YAML setting without PyYAML exits naming the JSON route;
* each ``configs/*.json`` equals ``yaml.safe_load`` of its YAML twin;
* the trajectory tool prints what the JAX package's prints, and the
  vocabulary tool renders the JAX tool's synthetic frames and trains the
  JAX ``Vocabulary.train``'s vocabulary on the same descriptors."""
import glob
import importlib.util
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from openvslam_tpu_torch.publish.socket_viewer import encode_png
from openvslam_tpu_torch.utils import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS, FX, BASELINE = 120, 160, 150.0, 0.3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_runner(tmp_path, capsys):
    from examples_torch import run_synthetic_slam

    for stereo in (False, True):
        traj, html = tmp_path / f"traj{stereo}.txt", tmp_path / f"map{stereo}.html"
        out = run_synthetic_slam.main(["--device", "cpu", "--frames", "12", "--rows", "96",
                                       "--cols", "128", "--feats", "200",
                                       "--traj-out", str(traj), "--viewer-out", str(html)]
                                      + ["--stereo"] * stereo)
        printed = capsys.readouterr().out
        assert out["device"] == "cpu" and "on cpu" in printed
        assert out["align"] == ("se3" if stereo else "sim3")
        assert out["tracked"] >= 2 and out["keyframes"] >= 1 and np.isfinite(out["ate_m"])
        rows = [ln for ln in traj.read_text().splitlines() if ln.strip()]
        assert len(rows) >= out["tracked"] and all(len(r.split()) == 8 for r in rows)
        assert "<html" in html.read_text().lower()


def _scene_frames(n: int):
    """n frames of a textured plane 7 m away at ROWS x COLS, sliding
    sideways, each with its right view (BASELINE)."""
    from openvslam_tpu_torch.camera import Perspective

    pc = Perspective(fx=FX, fy=FX, cx=COLS / 2, cy=ROWS / 2, cols=COLS, rows=ROWS)
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(7), x_range=(-5, 8),
                                         y_range=(-5, 5), plane_z=7.0, rows=ROWS, cols=COLS)
    shift = np.eye(4)
    shift[0, 3] = -BASELINE
    out = []
    for x in np.linspace(0.0, 0.6, n):
        T = synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7))
        out.append((scene.render(pc, T), scene.render(pc, shift @ T)))
    return out


def _setting(tmp_path, setup):
    cfg = {"Camera": {"name": f"tiny {setup}", "setup": setup, "model": "perspective",
                      "fx": FX, "fy": FX, "cx": COLS / 2, "cy": ROWS / 2, "cols": COLS,
                      "rows": ROWS, "fps": 10.0, "focal_x_baseline": FX * BASELINE,
                      "depth_threshold": 40.0, "depthmap_factor": 5000.0},
           "Feature": {"max_num_keypts": 300, "num_levels": 3, "scale_factor": 1.2},
           "LoopDetector": {"enabled": False}}
    path = tmp_path / f"{setup}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.astype(np.uint8).tobytes())


def _png16(img: np.ndarray) -> bytes:
    """A 16-bit grayscale PNG of ``img`` (no row filter)."""
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + row.astype(">u2").tobytes() for row in img)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 16, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _kitti(root, frames):
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir()
    for i, (l, r) in enumerate(frames):
        (root / "image_0" / f"{i:06d}.png").write_bytes(encode_png(l))
        (root / "image_1" / f"{i:06d}.png").write_bytes(encode_png(r))
    (root / "times.txt").write_text("".join(f"{0.1 * i:.6f}\n" for i in range(len(frames))))


def _euroc(root, frames):
    d = root / "mav0" / "cam0" / "data"
    d.mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i, (l, _) in enumerate(frames):
        _write_pgm(str(d / f"{i}.pgm"), l)
        rows.append(f"{1403636579763555584 + i * 50000000},{i}.pgm")
    (root / "mav0" / "cam0" / "data.csv").write_text("\n".join(rows))


def _tum(root, frames):
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    lr, ld = [], []
    for i, (l, _) in enumerate(frames):
        (root / "rgb" / f"{i}.png").write_bytes(encode_png(l))
        (root / "depth" / f"{i}.png").write_bytes(_png16(np.full(l.shape, 7 * 5000, np.uint16)))
        lr.append(f"{1.0 + i * 0.1:.6f} rgb/{i}.png")
        ld.append(f"{1.0 + i * 0.1:.6f} depth/{i}.png")
    (root / "rgb.txt").write_text("\n".join(lr))
    (root / "depth.txt").write_text("\n".join(ld))


def _images(root, frames):
    root.mkdir(parents=True)
    for i, (l, _) in enumerate(frames):
        (root / f"{i:04d}.png").write_bytes(encode_png(l))


RUNNERS = {"kitti": ("run_kitti_slam", "stereo", _kitti, "-d"),
           "euroc": ("run_euroc_slam", "monocular", _euroc, "-d"),
           "tum": ("run_tum_rgbd_slam", "rgbd", _tum, "-d"),
           "image": ("run_image_slam", "monocular", _images, "-i")}


@pytest.fixture(scope="module")
def frames():
    return _scene_frames(4)


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_dataset_runner_saves_and_reloads_its_map(name, frames, tmp_path, capsys):
    import importlib

    module, setup, write, flag = RUNNERS[name]
    runner = importlib.import_module(f"examples_torch.{module}")
    data = tmp_path / name
    write(data, frames)
    setting = _setting(tmp_path, setup)
    map_path, traj = str(tmp_path / "map.msg"), str(tmp_path / "traj.txt")
    mask = tmp_path / "mask.png"
    mask.write_bytes(encode_png(np.full((ROWS, COLS), 255, np.uint8)))
    common = ["-s", setting, flag, str(data), "--device", "cpu", "--traj-out", traj]
    first = runner.main(common + ["--sync-mapping", "--map-db-out", map_path, "--mask", str(mask)])
    assert "device: cpu" in capsys.readouterr().out
    n_kfs = first.map_db.n_kfs
    assert n_kfs >= 1 and os.path.getsize(map_path) > 0
    assert first.tracked_poses()[2].sum() >= 2
    assert first._static_mask.device.type == "cpu" and bool((first._static_mask == 1).all())
    # localization on the saved map (mapping off, the tracker relocalizing
    # in the map as it was saved), with the mapping thread; one runner with
    # a profile
    prof = ["--profile", str(tmp_path / "prof")] if name == "kitti" else []
    second = runner.main(common + ["--map-db-in", map_path] + prof)
    assert second.map_db.n_kfs == n_kfs
    assert second.tracked_poses()[2].sum() >= 1
    assert not prof or os.path.getsize(tmp_path / "prof" / "trace.json") > 0


@pytest.mark.parametrize("module", ["run_video_slam", "run_camera_slam"])
def test_cv2_runners_exit_without_opencv(module, monkeypatch):
    import importlib

    runner = importlib.import_module(f"examples_torch.{module}")
    monkeypatch.setitem(sys.modules, "cv2", None)
    args = ["-s", os.path.join(ROOT, "configs", "euroc_mono.json"), "--device", "cpu"]
    args += ["-m", "clip.mp4"] if module == "run_video_slam" else []
    with pytest.raises(SystemExit, match="OpenCV"):
        runner.main(args)


def test_yaml_setting_without_pyyaml_names_the_json_route(monkeypatch):
    from examples_torch import common, run_kitti_slam

    monkeypatch.setitem(sys.modules, "yaml", None)
    yaml_path = os.path.join(ROOT, "configs", "kitti_stereo_00.yaml")
    with pytest.raises(SystemExit, match=r"PyYAML.*kitti_stereo_00\.json"):
        common.load_config(yaml_path)
    with pytest.raises(SystemExit, match="JSON"):
        run_kitti_slam.main(["-s", yaml_path, "-d", "unused", "--device", "cpu"])
    cfg = common.load_config(os.path.join(ROOT, "configs", "kitti_stereo_00.json"))
    assert (cfg.camera.cols, cfg.camera.rows, cfg.feature.max_num_keypts) == (1241, 376, 2000)


@pytest.mark.parametrize("name", ["euroc_mono", "euroc_stereo", "kitti_stereo_00",
                                  "tum_rgbd_mono_fr1", "tum_rgbd_rgbd_fr1"])
def test_json_settings_equal_their_yaml(name):
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        ref = yaml.safe_load(f)
    with open(os.path.join(ROOT, "configs", f"{name}.json")) as f:
        assert json.load(f) == ref
    assert {os.path.basename(p)[:-5] for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml"))
            } == {os.path.basename(p)[:-5] for p in glob.glob(os.path.join(ROOT, "configs",
                                                                            "*.json"))}


@pytest.mark.parametrize("fmt,align", [("TUM", "sim3"), ("TUM", "se3"), ("KITTI", "none")])
def test_evaluate_trajectory_prints_as_jax(fmt, align, tmp_path, capsys, monkeypatch):
    from openvslam_tpu_torch.io import trajectory_io

    rng = np.random.default_rng(2)
    gt = synthetic.orbit_trajectory(30, radius=2.0, target=(0, 0, 6), arc=np.pi / 3)
    est = np.stack([synthetic.random_pose_cw(rng, 0.01, 0.02) @ T for T in gt])
    est[:, :3, 3] *= 1.3
    ts = np.arange(30) * 0.1
    paths = [str(tmp_path / f"{k}.txt") for k in ("est", "gt")]
    for p, poses in zip(paths, (est, gt)):
        if fmt == "TUM":
            trajectory_io.save_trajectory_tum(p, ts, poses)
        else:
            trajectory_io.save_trajectory_kitti(p, poses)
    args = paths + ["--format", fmt, "--align", align, "--rpe-delta", "2"]
    out = _tool("evaluate_trajectory_torch").main(args)
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["evaluate_trajectory.py"] + args)
    _tool("evaluate_trajectory").main()
    assert ours == capsys.readouterr().out
    assert out["poses"] == 30 and out["ate_m"] > 0


def test_train_vocab_renders_and_trains_as_jax(tmp_path, monkeypatch):
    from openvslam_tpu.data.bow import Vocabulary as JaxVocabulary
    from openvslam_tpu_torch.data.bow import load_vocabulary

    tool = _tool("train_vocab_torch")
    got = {}
    render, extract = tool.synthetic_images, tool.extract_descriptors

    def keep(key, fn):
        def w(*a, **kw):
            got[key] = fn(*a, **kw)
            return got[key]
        return w

    monkeypatch.setattr(tool, "synthetic_images", keep("images", render))
    monkeypatch.setattr(tool, "extract_descriptors", keep("descs", extract))
    out = str(tmp_path / "voc.npz")
    tool.main(["--synthetic", "12", "-o", out, "--words", "32", "--iters", "3", "--seed", "4",
               "--max-keypts", "200", "--num-levels", "3", "--device", "cpu"])
    ref_images = _tool("train_vocab").synthetic_images(12, seed=4 + 42)
    assert len(got["images"]) == len(ref_images) == 12
    for a, b in zip(got["images"], ref_images):
        np.testing.assert_array_equal(a, b)
    ref = JaxVocabulary.train(got["descs"], num_words=32, iters=3, seed=4)
    voc = load_vocabulary(out)
    np.testing.assert_array_equal(voc.centers_i8, np.asarray(ref.centers_i8))
    np.testing.assert_array_equal(voc.idf, np.asarray(ref.idf))
