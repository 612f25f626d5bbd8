"""Stream-parallel tracking (counterpart of
``openvslam_tpu/parallel/stream_parallel.py``): K tracking streams, stream
k on device k of a device list, each with its own CUDA stream.

JAX's version ``shard_map``s the single-stream FrameStep over its mesh,
one stream per chip.  Here each stream runs ``FrameStep.step`` itself, on
its device and its own CUDA stream: a round launches every stream's step
before it reads any stream back, so K streams on one card overlap (one
card may fill the whole list).  Each stream's result equals the
single-stream ``FrameStep``'s bit for bit: the same kernels run on the
same operands.  On the CPU the streams run one after another.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..device import canonical_device
from ..models.frame_step import FrameStep, FrameStepResult


class StreamParallelStep:
    """K = len(mesh) tracking streams.

    step(images (K,H,W) u8, T_pred (K,4,4), lm_pos (K,L,3), lm_desc_u32
         (K,L,8), lm_valid (K,L), lm_pred_level (K,L)) -> FrameStepResult
    with a leading K, on the first device of the list.  Each operand may
    also be a sequence of K per-stream tensors (``shard``'s output)."""

    def __init__(self, frame_step: FrameStep, mesh: Sequence[torch.device]):
        self.fs = frame_step
        self.mesh = [canonical_device(d) for d in mesh]
        steps = {}
        self._steps = [steps.setdefault(d, frame_step.on_device(d)) for d in self.mesh]
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in self.mesh]
        self._first = True

    @property
    def n_streams(self) -> int:
        return len(self.mesh)

    def shard(self, *arrays) -> tuple:
        """Place per-stream-stacked arrays (leading axis = stream, which must
        equal the number of streams) on the streams' devices: for each array
        a list of K tensors."""
        out = []
        for a in arrays:
            if a.shape[0] != self.n_streams:
                raise ValueError(f"leading axis {a.shape[0]} != number of streams "
                                 f"{self.n_streams}: one stream per device entry")
            a = torch.as_tensor(a)
            out.append([a[k].to(d) for k, d in enumerate(self.mesh)])
        return tuple(out)

    def step(self, images, T_pred, lm_pos, lm_desc_u32, lm_valid, lm_pred_level
             ) -> FrameStepResult:
        args = (images, T_pred, lm_pos, lm_desc_u32, lm_valid, lm_pred_level)
        results: List[FrameStepResult] = []
        prev = None
        for k, (d, fs, cs) in enumerate(zip(self.mesh, self._steps, self._streams)):
            if cs is None:
                results.append(fs.step(*(a[k] for a in args)))
                continue
            # the stream starts after what the caller queued on the device;
            # in the first round also after the stream before it, whose step
            # uploads the tables the steps cache on first use
            cs.wait_stream(torch.cuda.current_stream(d))
            if self._first and prev is not None and prev.device == cs.device:
                cs.wait_stream(prev)
            prev = cs
            with torch.cuda.stream(cs):
                r = fs.step(*(torch.as_tensor(a[k]).to(d, non_blocking=True) for a in args))
            results.append(r)
        self._first = False
        d0 = self.mesh[0]
        for d, cs, r in zip(self.mesh, self._streams, results):
            if cs is None:
                continue
            torch.cuda.current_stream(d).wait_stream(cs)
            for t in r:
                t.record_stream(torch.cuda.current_stream(d))
        return FrameStepResult(*(torch.stack([getattr(r, f).to(d0) for r in results])
                                 for f in FrameStepResult._fields))
