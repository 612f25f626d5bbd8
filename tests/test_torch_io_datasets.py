"""The port's dataset loaders, PNG decoder and publishers
(``openvslam_tpu_torch/utils/datasets.py``, ``publish/``), as
tests/test_io_datasets.py holds the JAX package's: the TUM, KITTI and EuRoC
trees written under ``tmp_path`` (as PGM, as the JAX test writes them, and
as PNG, which the datasets ship and the port decodes itself), the
publishers and the HTML export on a port System.  The PNG decoder is held
against images of known pixels written with each of the five row filters
(8-bit gray, RGB, RGBA, gray+alpha, palette; 16-bit gray depth), against
``encode_png`` and against PIL where this machine has it; interlaced PNG
and JPEG raise."""
import struct
import zlib

import numpy as np
import pytest
import torch

from openvslam_tpu_torch.publish.socket_viewer import encode_png
from openvslam_tpu_torch.utils import datasets, synthetic


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.astype(np.uint8).tobytes())


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(img, filters, ctype=None, depth=8, interlace=0, palette=None):
    """A PNG of ``img`` with row r filtered by ``filters[r % len]`` (the
    filters computed here independently of the decoder)."""
    if ctype is None:
        ctype = {1: 0, 3: 2, 2: 4, 4: 6}[1 if img.ndim == 2 else img.shape[2]]
    h, w = img.shape[:2]
    if depth == 16:
        px = img.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        px = img.astype(np.uint8).reshape(h, -1)
    bpp = px.shape[1] // w
    raw = bytearray()
    prev = np.zeros(px.shape[1], np.int64)
    for r in range(h):
        cur = px[r].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = filters[r % len(filters)]
        pred = [np.zeros_like(cur), left, prev, (left + prev) // 2, _paeth(left, prev, upleft)][f]
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                            0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray_alpha", "depth16"])
def test_png_decoder_every_filter(rng, filt, kind):
    shape = {"gray": (17, 23), "rgb": (17, 23, 3), "rgba": (9, 11, 4),
             "gray_alpha": (9, 11, 2), "depth16": (13, 19)}[kind]
    depth = 16 if kind == "depth16" else 8
    img = rng.integers(0, 2 ** depth, shape).astype(np.uint16 if depth == 16 else np.uint8)
    img[3:6] = img[3:6].min()               # flat rows, where Up and Paeth ties show
    filters = [0, 1, 2, 3, 4] if filt == "mixed" else [filt]
    out = datasets.decode_png(_png(img, filters, depth=depth))
    assert out.dtype == img.dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


def test_png_decoder_palette(rng):
    pal = rng.integers(0, 256, (7, 3))
    idx = rng.integers(0, 7, (10, 12)).astype(np.uint8)
    out = datasets.decode_png(_png(idx, [4, 1], ctype=3, palette=pal))
    np.testing.assert_array_equal(out, pal[idx].astype(np.uint8))


def test_png_decoder_reads_encode_png(rng):
    for img in (rng.integers(0, 256, (30, 40), dtype=np.uint8),
                rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)):
        np.testing.assert_array_equal(datasets.decode_png(encode_png(img)), img)


def test_png_decoder_against_pil(rng, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    # a smooth image so PIL's adaptive filtering picks more than one filter
    yy, xx = np.mgrid[0:48, 0:64]
    base = (128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)).astype(np.uint8)
    cases = {"L": base, "RGB": np.stack([base, base[::-1], np.roll(base, 5, 1)], -1),
             "RGBA": np.stack([base, 255 - base, base // 2, np.full_like(base, 200)], -1)}
    for mode, img in cases.items():
        p = str(tmp_path / f"{mode}.png")
        Image.fromarray(img).save(p)
        np.testing.assert_array_equal(datasets.imread(p), img)
    d = (rng.integers(0, 60000, (24, 32))).astype(np.uint16)
    p = str(tmp_path / "depth.png")
    Image.fromarray(d).save(p)
    np.testing.assert_array_equal(datasets.imread(p), d)
    np.testing.assert_allclose(datasets.load_depth_png(p), d.astype(np.float32) / 5000.0)


def test_interlaced_png_and_jpeg_raise(rng, tmp_path):
    img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    with pytest.raises(ValueError, match="interlaced"):
        datasets.decode_png(_png(img, [0], interlace=1))
    p = tmp_path / "frame.jpg"
    p.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="JPEG"):
        datasets.imread(str(p))
    bad = bytearray(_png(img, [0]))
    bad[30] ^= 0xFF                          # inside IHDR: the CRC no longer matches
    with pytest.raises(ValueError):
        datasets.decode_png(bytes(bad))


def test_gray_reduction_matches_rec601(rng, tmp_path):
    rgb = rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
    p = tmp_path / "c.png"
    p.write_bytes(encode_png(rgb))
    want = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.uint8)
    np.testing.assert_array_equal(datasets._imread_gray(str(p)), want)


# --- the loaders (tests/test_io_datasets.py) -----------------------------
def test_tum_loader(tmp_path, rng):
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    lines = ["# rgb images"]
    for i in range(5):
        _write_pgm(str(root / "rgb" / f"{i}.pgm"), rng.integers(0, 255, (48, 64), np.uint8))
        lines.append(f"{1.0 + i * 0.05:.6f} rgb/{i}.pgm")
    (root / "rgb.txt").write_text("\n".join(lines))
    seq = datasets.TumRgbdSequence(str(root))
    assert len(seq) == 5
    ts, img, depth = seq[2]
    assert abs(ts - 1.1) < 1e-6
    assert img.shape == (48, 64) and depth is None


def test_tum_loader_png_rgbd(tmp_path, rng):
    """TUM as it ships: RGB PNG frames and 16-bit depth PNG, associated by
    timestamp; depth in metres (/5000)."""
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgbs, deps, lr, ld = [], [], [], []
    for i in range(4):
        rgb = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
        dep = rng.integers(0, 40000, (12, 16)).astype(np.uint16)
        (root / "rgb" / f"{i}.png").write_bytes(encode_png(rgb))
        (root / "depth" / f"{i}.png").write_bytes(_png(dep, [2, 4], depth=16))
        lr.append(f"{1.0 + i * 0.05:.6f} rgb/{i}.png")
        ld.append(f"{1.005 + i * 0.05:.6f} depth/{i}.png")
        rgbs.append(rgb)
        deps.append(dep)
    (root / "rgb.txt").write_text("\n".join(lr))
    (root / "depth.txt").write_text("\n".join(ld))
    seq = datasets.TumRgbdSequence(str(root))
    assert len(seq) == 4
    ts, img, d = seq[3]
    assert abs(ts - 1.15) < 1e-6 and img.shape == (12, 16) and img.dtype == np.uint8
    np.testing.assert_allclose(d, deps[3].astype(np.float32) / 5000.0)


def test_kitti_loader(tmp_path, rng):
    root = tmp_path / "kitti"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir()
    imgs = [rng.integers(0, 255, (32, 48), np.uint8) for _ in range(3)]
    for i, im in enumerate(imgs):
        (root / "image_0" / f"{i:06d}.png").write_bytes(_png(im, [i % 5]))
        (root / "image_1" / f"{i:06d}.png").write_bytes(encode_png(im[::-1]))
    (root / "times.txt").write_text("0.0\n0.1\n0.2\n")
    seq = datasets.KittiOdometrySequence(str(root))
    assert len(seq) == 3
    ts, left, right = seq[2]
    assert ts == pytest.approx(0.2)
    np.testing.assert_array_equal(left, imgs[2])
    np.testing.assert_array_equal(right, imgs[2][::-1])


def test_euroc_loader(tmp_path, rng):
    root = tmp_path / "euroc"
    d = root / "mav0" / "cam0" / "data"
    d.mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i in range(4):
        _write_pgm(str(d / f"{i}.pgm"), rng.integers(0, 255, (24, 32), np.uint8))
        rows.append(f"{1403636579763555584 + i * 50000000},{i}.pgm")
    (root / "mav0" / "cam0" / "data.csv").write_text("\n".join(rows))
    seq = datasets.EurocSequence(str(root), stereo=False)
    assert len(seq) == 4
    ts, left, right = seq[1]
    assert left.shape == (24, 32) and right is None


# --- the publishers and the HTML export on a port System -----------------
@pytest.fixture(scope="module")
def plane_session():
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.system import System

    cfg = Config.from_dict({
        "Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                   "fx": 350.0, "fy": 350.0, "cx": 208.0, "cy": 160.0, "cols": 416,
                   "rows": 320, "fps": 20},
        "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})
    cam = cfg.camera
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(7), x_range=(-5, 8),
                                         y_range=(-5, 5), plane_z=7.0, rows=cam.rows,
                                         cols=cam.cols)
    s = System(cfg, device="cpu")
    s.startup()
    for i, x in enumerate(np.linspace(0.0, 1.5, 8)):
        s.feed_monocular_frame(scene.render(cam, synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7))),
                               i / 20.0)
    s.shutdown()
    return s


def test_publishers(plane_session):
    s = plane_session
    snap = s.frame_publisher.get_current_frame()
    assert snap is not None and snap["state"] == "TRACKING"
    assert snap["frame_id"] == 7 and snap["image"].shape == (320, 416)
    assert snap["keypoints"].shape[1] == 2 and snap["tracked"].any()
    ids, kf_poses = s.map_publisher.get_keyframes()
    assert len(ids) >= 2 and kf_poses.shape[1:] == (4, 4)
    lm_ids, lm_pos = s.map_publisher.get_landmarks()
    assert len(lm_ids) > 50 and lm_pos.shape[1] == 3
    assert len(s.map_publisher.get_spanning_tree_edges()) >= 1
    _, poses, mask = s.tracked_poses()
    np.testing.assert_array_equal(s.map_publisher.get_current_pose(), poses[mask][-1])


def test_html_viewer_export(plane_session, tmp_path):
    from openvslam_tpu_torch.publish.html_viewer import export_html

    out = tmp_path / "map.html"
    export_html(plane_session.map_publisher, str(out))
    html = out.read_text()
    assert "kf_centers" in html and "landmarks" in html
    assert len(html) > 5000
