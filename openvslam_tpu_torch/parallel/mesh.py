"""Device lists (counterpart of ``openvslam_tpu/parallel/mesh.py``).

JAX's mesh is one controller over many devices.  Here a "mesh" is a list
of ``torch.device``: shard or stream k runs on entry k.  One card may
stand for several entries (``make_mesh(4, "cuda:0")``), which runs the
same program with the same number of shards and streams on one GPU;
several processes, one per card, join through ``parallel.multihost``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..device import resolve_device


def make_mesh(n: Optional[int] = None, devices=None) -> List[torch.device]:
    """A device list: ``devices`` (one name, repeated ``n`` times, or a
    list, cut to ``n``); by default every CUDA device, cut to ``n``.  A
    CUDA device raises when no GPU is present: pass ``devices="cpu"`` for
    the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices='cpu' for the CPU")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n is not None:
            if n > len(devs):
                raise ValueError(f"make_mesh: {n} devices asked, {len(devs)} present")
            devs = devs[:n]
        return devs
    if isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)] * (1 if n is None else n)
    devs = [resolve_device(d) for d in devices]
    return devs if n is None else devs[:n]
