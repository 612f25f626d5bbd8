"""Build, load and count the package's hand-written CUDA kernels.

The sources in ``csrc/`` have a plain C interface: each exported function
takes device pointers, sizes and the CUDA stream, launches on that stream,
allocates nothing and returns ``cudaGetLastError()``.  They are compiled
with ``nvcc`` for ``sm_90a`` into one shared library per source under
``build/`` on first use (all sources at once, one ``nvcc`` each, in
parallel) and bound with ``ctypes``.  Nothing here runs at import time.

``LAUNCHES`` counts, per kernel wrapper, the calls that launched the CUDA
kernel (``count_launch``, under a lock: the tracking thread and the loop
worker launch kernels at the same time), and ``launch_counts_by_thread``
splits the same counts by the launching thread's name; the plain PyTorch
versions never touch them.  Every kernel takes a batch of problems in one
launch; ``BATCHED_LAUNCHES`` counts, per kernel, the launches that carried
more than one problem (a subset of ``LAUNCHES``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = {"fast": "fast.cu", "match": "match.cu", "pose_lm": "pose_lm.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# K1 (now the fused detect kernel) keeps its first key, so launch records line up
LAUNCHES = {"fast_score_maps": 0, "projection_match": 0, "pose_lm": 0}
BATCHED_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
_BY_THREAD: dict = {}           # thread name -> {kernel: launches}
_count_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
MAX_LEVELS = 16


class LevelTable(ctypes.Structure):
    """Per-level geometry and operands of the all-levels K1 launch, passed by
    value (``struct LevelTable`` in csrc/fast.cu)."""
    _fields_ = [("num_levels", _I), ("vmax", _I),
                ("height", _I * MAX_LEVELS), ("width", _I * MAX_LEVELS),
                ("cells_x", _I * MAX_LEVELS), ("k_cell", _I * MAX_LEVELS),
                ("cell_start", _I * (MAX_LEVELS + 1)),
                ("img", _P * MAX_LEVELS), ("mask", _P * MAX_LEVELS)]


# every entry takes a batch of problems of one shape (the batch count is the
# first integer after the table for K1, the first argument for K2 and K3)
_SIGNATURES = {
    "fast": ("fast_cell_pools", [LevelTable, _I, _F, _F, _P, _P, _P]),
    "match": ("projection_match", [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P,
                                   _I, _I, _F, _I, _I, _I, _I, _I, _F, _I,
                                   _P, _P, _P, _P]),
    "pose_lm": ("pose_lm", [_I, _P, _P, _P, _I, _P, _P, _I,
                            _F, _F, _F, _F, _F, _F, _I, _I,
                            _P, _P, _P, _P, _P]),
}

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}


def count_launch(name: str, batch: int = 1) -> None:
    """Count one launch of kernel ``name`` (over ``batch`` problems) by the
    calling thread."""
    with _count_lock:
        LAUNCHES[name] += 1
        if batch > 1:
            BATCHED_LAUNCHES[name] += 1
        per = _BY_THREAD.setdefault(threading.current_thread().name, dict.fromkeys(LAUNCHES, 0))
        per[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            BATCHED_LAUNCHES[k] = 0
        _BY_THREAD.clear()


def launch_counts() -> dict:
    with _count_lock:
        return dict(LAUNCHES)


def batched_launch_counts() -> dict:
    with _count_lock:
        return dict(BATCHED_LAUNCHES)


def launch_counts_by_thread() -> dict:
    with _count_lock:
        return {t: dict(c) for t, c in _BY_THREAD.items()}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all() -> dict:
    """Compile every source that has no up-to-date library yet, one nvcc
    process per source, all started together.  Returns {name: seconds}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    times = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def library(name: str):
    """The loaded ctypes function of kernel source ``name`` (built on first use)."""
    with _lock:
        if name not in _libs:
            if not all(os.path.exists(_lib_path(n)) for n in SOURCES):
                build_all()
            lib = ctypes.CDLL(_lib_path(name))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = _I
            _libs[name] = fn
        return _libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
