"""ctypes bridge to the port's native host kernels (``csrc/map_core.cpp``;
counterpart of ``openvslam_tpu/utils/native.py``).

The source is compiled with ``g++`` on first use into ``build/`` inside
this package (the library's name carries a hash of the source and flags,
and processes building it at once each write their own temporary file).  A failed
build raises: there is no silent Python fallback.  The numpy version stays
here as the plain reference for the tests.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "map_core.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def lib_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libmapcore-{digest}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SRC], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native build of {SRC} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build of {SRC} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            out = lib_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
            lib.min_median_hamming.restype = ctypes.c_int32
            lib.min_median_hamming.argtypes = [ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
            i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
            lib.bow_shared_words.restype = ctypes.c_int32
            lib.bow_shared_words.argtypes = [i32p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
                                             i64p, i32p, ctypes.c_int64]
            _lib = lib
        return _lib


def min_median_hamming(descs_u32: np.ndarray) -> int:
    """Index of the (n,8) packed descriptor with the least median Hamming
    distance to the others."""
    d = np.ascontiguousarray(descs_u32, np.uint32)
    if d.ndim != 2 or d.shape[1] != 8:
        raise ValueError(f"descriptors must be (n, 8) words, got {d.shape}")
    return int(library().min_median_hamming(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), d.shape[0]))


def min_median_hamming_plain(descs_u32: np.ndarray) -> int:
    """numpy version of ``min_median_hamming`` (the same lower median of each
    row, first index among ties)."""
    d = np.asarray(descs_u32, np.uint32)
    x = np.bitwise_count(d[:, None, :] ^ d[None, :, :]).sum(-1)
    n = d.shape[0]
    med = np.partition(x, n // 2, axis=1)[:, n // 2]
    return int(np.argmin(med))


def bow_shared_words(query_words: np.ndarray, inv_offsets: np.ndarray, inv_kfs: np.ndarray,
                     max_out: int = 8192):
    """Keyframes sharing words with a query: (kf_ids (n,) int64, counts (n,)
    int32), each query word counted once, over the CSR inverted index
    (``inv_offsets`` (W+1,), ``inv_kfs``)."""
    qw = np.ascontiguousarray(query_words, np.int32)
    io_ = np.ascontiguousarray(inv_offsets, np.int64)
    ik = np.ascontiguousarray(inv_kfs, np.int64)
    out_kf = np.empty(max_out, np.int64)
    out_ct = np.empty(max_out, np.int32)
    i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
    n = library().bow_shared_words(
        qw.ctypes.data_as(i32p), len(qw), io_.ctypes.data_as(i64p), ik.ctypes.data_as(i64p),
        len(io_) - 1, out_kf.ctypes.data_as(i64p), out_ct.ctypes.data_as(i32p), max_out)
    return out_kf[:n].copy(), out_ct[:n].copy()


def bow_shared_words_plain(query_words: np.ndarray, inv_offsets: np.ndarray,
                           inv_kfs: np.ndarray):
    """numpy version of ``bow_shared_words``: the same counts, in keyframe
    order (the native order is the hash map's)."""
    qw = np.asarray(query_words)
    io_ = np.asarray(inv_offsets, np.int64)
    words = np.unique(qw[(qw >= 0) & (qw < len(io_) - 1)])
    kfs = np.concatenate([np.asarray(inv_kfs, np.int64)[io_[w]:io_[w + 1]] for w in words]) \
        if len(words) else np.zeros(0, np.int64)
    ks, vs = np.unique(kfs, return_counts=True)
    return ks.astype(np.int64), vs.astype(np.int32)
