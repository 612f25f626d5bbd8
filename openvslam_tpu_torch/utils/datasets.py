"""Dataset loaders for the reference's evaluation suites (counterpart of
``openvslam_tpu/utils/datasets.py``; ref ``example/util/{tum_rgbd,euroc,
kitti}_util``): directory layouts -> (timestamps, image paths), images
loaded lazily as grayscale uint8 numpy arrays.

KITTI, EuRoC and TUM store their frames as PNG (TUM's depth as 16-bit PNG).
The port decodes PNG itself (``decode_png``, on the standard library's
``zlib``) and reads binary PGM as the JAX package does; it needs no image
library.  Interlaced PNG and JPEG raise: there is no decoder for them here,
and nothing falls back to another library.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from .evaluate import associate_timestamps

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples per pixel


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth).

    Byte x of a row depends on the byte ``bpp`` to its left (a), the byte
    above (b) and the one above-left (c), so every pixel on one
    anti-diagonal of the (row, pixel) grid can be reconstructed at once: the
    loop runs over rows + pixels diagonals, each a vector step."""
    rows = raw.reshape(h, row_bytes + 1)
    ftype = rows[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    data = rows[:, 1:]
    if not ftype.any():
        return data.copy()
    w = row_bytes // bpp
    filt = data.reshape(h, w, bpp).astype(np.int32)
    # recon with a zero row above and a zero pixel column to the left
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        j = d - r
        a = rec[r + 1, j]
        b = rec[r, j + 1]
        c = rec[r, j]
        ft = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, j + 1] = (filt[r, j] + pred) & 0xFF
    return rec[1:, 1:].reshape(h, row_bytes).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> its image: (H,W) for gray, (H,W,2) gray+alpha,
    (H,W,3) RGB, (H,W,4) RGBA, as uint8 (bit depth 8) or uint16 (bit depth
    16); a palette image (bit depth 8) is expanded to RGB or RGBA.  Raises
    ValueError on anything else (interlaced, other bit depths, a corrupt
    file)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr, palette, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError("PNG: truncated chunk")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in {tag!r} chunk")
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, comp, filt_method, interlace = hdr
    if interlace:
        raise ValueError("PNG: interlaced (Adam7) images are not supported")
    if ctype not in _CHANNELS or comp or filt_method:
        raise ValueError(f"PNG: unsupported colour type {ctype} / method {comp}, {filt_method}")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"PNG: bit depth {depth} (colour type {ctype}) is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"PNG: {raw.size} bytes of image data, expected {h * (w * bpp + 1)}")
    px = _unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        img = px.reshape(h, w * ch, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]
    else:
        img = px
    img = img.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        idx = img[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError("PNG: palette index out of range")
        rgb = palette[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:len(trns)] = trns[:len(palette)]
        return np.concatenate([rgb, alpha[idx][..., None]], -1)
    return img[..., 0] if ch == 1 else img


def imread(path: str) -> np.ndarray:
    """A PNG or binary PGM file as decode_png returns it (PGM: (H,W) uint8,
    or uint16 when its maximum is above 255).  Raises ValueError on another
    format (JPEG included)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == b"P5":
        return _decode_pgm(data)
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError(f"{path}: JPEG is not supported (no JPEG decoder in the port); "
                         "convert the frames to PNG")
    raise ValueError(f"{path}: not a PNG or binary PGM file")


def _decode_pgm(data: bytes) -> np.ndarray:
    """Binary PGM, header parsed as the JAX reader parses it."""
    lines = data.split(b"\n", 3)
    pos = len(lines[0]) + 1
    rest = data[pos:]
    while rest.startswith(b"#"):
        rest = rest[rest.index(b"\n") + 1:]
    line, rest = rest.split(b"\n", 1)
    w, h = map(int, line.split())
    line, rest = rest.split(b"\n", 1)
    maxv = int(line)
    return np.frombuffer(rest, np.uint8 if maxv < 256 else ">u2").reshape(h, w).copy()


def _imread_gray(path: str) -> np.ndarray:
    """Grayscale uint8, reduced as the JAX reader reduces it: RGB(A) by the
    Rec.601 weights, 16-bit samples by 256 (PGM: by 257) when above 255."""
    img = imread(path)
    if path.endswith((".pgm", ".PGM")):
        return img if img.dtype == np.uint8 else (img / 257).astype(np.uint8)
    if img.ndim == 3:
        img = (img[..., 0] if img.shape[-1] < 3 else
               0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    if img.dtype != np.uint8:
        if img.max() > 255:
            img = img / 256.0
        img = img.astype(np.uint8)
    return img


def load_depth_png(path: str, factor: float = 5000.0) -> np.ndarray:
    """16-bit depth PNG -> float32 metres (TUM convention: /5000)."""
    return imread(path).astype(np.float32) / factor


class TumRgbdSequence:
    """TUM RGB-D: rgb.txt / depth.txt (+ groundtruth.txt), association by
    nearest timestamp (ref example/util/tum_rgbd_util)."""

    def __init__(self, root: str, max_diff: float = 0.02):
        self.root = root
        self.rgb = self._read_list(os.path.join(root, "rgb.txt"))
        depth_file = os.path.join(root, "depth.txt")
        self.depth = self._read_list(depth_file) if os.path.exists(depth_file) else []
        self.pairs: List[Tuple[float, str, Optional[str]]] = []
        if self.depth:
            ts_r = [t for t, _ in self.rgb]
            ts_d = [t for t, _ in self.depth]
            for ir, idd in associate_timestamps(ts_r, ts_d, max_diff):
                self.pairs.append((self.rgb[ir][0], self.rgb[ir][1], self.depth[idd][1]))
        else:
            self.pairs = [(t, p, None) for t, p in self.rgb]

    def _read_list(self, path: str):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                out.append((float(ts), os.path.join(self.root, rel)))
        return out

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        ts, rgb, depth = self.pairs[i]
        img = _imread_gray(rgb)
        d = load_depth_png(depth) if depth else None
        return ts, img, d


class EurocSequence:
    """EuRoC MAV: mav0/cam{0,1}/data.csv + data/*.png (ref euroc_util)."""

    def __init__(self, root: str, stereo: bool = True):
        self.root = root
        self.cam0 = self._read_cam(os.path.join(root, "mav0", "cam0"))
        self.cam1 = self._read_cam(os.path.join(root, "mav0", "cam1")) if stereo else []
        if self.cam1:
            n = min(len(self.cam0), len(self.cam1))
            self.cam0, self.cam1 = self.cam0[:n], self.cam1[:n]

    def _read_cam(self, cam_dir: str):
        out = []
        csv = os.path.join(cam_dir, "data.csv")
        if not os.path.exists(csv):
            return out
        with open(csv) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts_ns, fname = line.split(",")[:2]
                out.append((int(ts_ns) * 1e-9, os.path.join(cam_dir, "data", fname.strip())))
        return out

    def __len__(self):
        return len(self.cam0)

    def __getitem__(self, i):
        ts, p0 = self.cam0[i]
        left = _imread_gray(p0)
        right = _imread_gray(self.cam1[i][1]) if self.cam1 else None
        return ts, left, right


class KittiOdometrySequence:
    """KITTI odometry: image_0/ image_1/ %06d.png + times.txt (ref kitti_util)."""

    def __init__(self, root: str, stereo: bool = True):
        self.root = root
        with open(os.path.join(root, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.left_dir = os.path.join(root, "image_0")
        self.right_dir = os.path.join(root, "image_1") if stereo else None

    def __len__(self):
        return len(self.times)

    def __getitem__(self, i):
        name = f"{i:06d}.png"
        left = _imread_gray(os.path.join(self.left_dir, name))
        right = (_imread_gray(os.path.join(self.right_dir, name))
                 if self.right_dir and os.path.isdir(self.right_dir) else None)
        return self.times[i], left, right
