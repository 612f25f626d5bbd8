"""Several processes: one ``torch.distributed`` group and the distributed
BA across it (counterpart of ``openvslam_tpu/parallel/multihost.py``).

JAX joins its hosts with ``jax.distributed.initialize`` into one runtime
whose mesh spans every process, and moves small numpy payloads with
``process_allgather``.  PyTorch's idiom is one process per GPU:

  1. ``initialize`` joins this process into a group: NCCL when its device
     is a GPU, gloo when it is the CPU.  The backend follows the device; a
     failing NCCL raises and never falls back to gloo or the CPU.
  2. ``make_multihost_ba``: every rank holds the same host problem and
     places only its own landmark shards on its device; the reduced
     camera system is summed with ``all_reduce(SUM)``
     (``distributed_ba.make_distributed_ba`` with ``group``).
  3. The control plane (keyframe counts, pooled-solve metadata) moves as
     pickled numpy payloads with ``all_gather_object``
     (``process_allgather``).

Nothing on the machine names a cluster: the caller gives the rendezvous
address (``tcp://127.0.0.1:<port>``, or ``file://<path>`` for a file
store), the world size and the rank.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .distributed_ba import (ShardedBAProblem, make_distributed_ba, partition_problem,
                             rank_rows)


def initialize(init_method: str, world_size: int, rank: int, device="cuda",
               backend: Optional[str] = None):
    """Join this process into the default group and return its device.
    The backend is NCCL for a CUDA ``device`` (which becomes the current
    device) and gloo for the CPU; naming another backend that does not fit
    the device raises."""
    from datetime import timedelta

    dev = resolve_device(device)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend is not None and backend != want:
        raise ValueError(f"backend {backend!r} does not fit device {dev} (it takes {want!r})")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(want, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=300))
    return dev


def shutdown() -> None:
    """Leave the default group (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_allgather(x) -> np.ndarray:
    """Gather a small per-process numpy payload from every rank, stacked
    along a new leading axis in rank order (the control plane)."""
    out: List = [None] * dist.get_world_size()
    dist.all_gather_object(out, np.asarray(x))
    return np.stack(out)


def shard_to_global(sp: ShardedBAProblem, n_shards: int) -> ShardedBAProblem:
    """``distributed_ba.rank_rows`` at this process's rank: its contiguous
    block of ``n_shards // world`` landmark shards of a problem that every
    rank holds whole, and their observations (cameras whole).  JAX's
    function of this name goes the other way, from each process's rows to
    one array on a mesh that spans the processes; no tensor spans
    processes here, so the step that links a rank's rows to the global
    problem is this selection, and the distributed BA places only these
    rows on the rank's device."""
    return rank_rows(sp, n_shards, dist.get_world_size(), dist.get_rank())


def assign_keyframe_ranges(counts_local: int) -> np.ndarray:
    """Every rank reports how many keyframes its sessions hold; returns the
    cumulative offsets (each rank's camera-slot range in the pooled
    problem), agreed through an allgather."""
    counts = process_allgather(np.asarray([counts_local], np.int64))[:, 0]
    offs = np.zeros(len(counts) + 1, np.int64)
    offs[1:] = np.cumsum(counts)
    return offs


def make_multihost_ba(cam, device, stereo: bool = False, iters: int = 10,
                      multicam: bool = False):
    """Distributed BA over the default group, one landmark shard on each
    rank's ``device``.  Returns (shards, solve): solve(prob:
    optimize.ba.BAProblem) partitions the problem (every rank passes the
    same one) into ``shards`` = world shards, solves it with the rank's own
    shard and returns (T (C,4,4), X (L_total,3), cost) as numpy and a
    float, identical on every rank."""
    shards = dist.get_world_size()
    opt = make_distributed_ba(cam, [device], group=dist.group.WORLD, stereo=stereo,
                              iters=iters, multicam=multicam)

    def solve(prob):
        T, X, cost = opt(partition_problem(prob, shards))
        return T.cpu().numpy(), X.cpu().numpy(), float(cost)

    return shards, solve
