"""Row sums of per-observation blocks in one fixed order.

``index_add_`` on a CUDA tensor adds with atomics: the order of the
additions, and with it the rounding, changes from one run to the next, and
an ill-conditioned bundle adjustment window (a fisheye's rim observations)
then lands somewhere else on every run of the same input.  A ``SegmentSum``
made for a CUDA index places each block in a slot of its own in an (n, m)
grid, m the largest count of one index, in block order, and runs a sum
along m: ``cumsum`` over a dimension that is not the last adds one slot
after another in float32 on the card, so the card makes the additions of
``index_add_`` on the CPU, in its order, on every run (on the CPU
``cumsum`` accumulates in float64).  The blocks outside a
``keep`` mask (the padding and masked observations, which the solvers
weight by zero) take no slot: they all share index 0, and would widen the
grid to the padding's count.  The widths are read back once, when the
plans are made (``segment_sums``), not inside a solve.  On the CPU
``index_add_`` already adds in index order and is kept.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


class SegmentSum:
    """``out[k] = sum of blocks[o] over idx[o] == k`` for an index fixed
    over many calls.  ``pos`` is each block's slot in the flattened (n, m)
    grid, n * m for a block outside ``keep`` (a spare slot, dropped); None
    for ``index_add_``."""

    def __init__(self, idx: torch.Tensor, n: int, pos: Optional[torch.Tensor] = None,
                 m: int = 1):
        self.idx, self.n, self.pos, self.m = idx, n, pos, m

    def __call__(self, blocks: torch.Tensor) -> torch.Tensor:
        tail = blocks.shape[1:]
        if self.pos is None:
            return blocks.new_zeros((self.n,) + tail).index_add_(0, self.idx, blocks)
        slots = self.n * self.m
        grid = blocks.new_zeros((slots + 1,) + tail).index_copy_(0, self.pos, blocks)
        run = grid[:slots].view(self.n, self.m, -1).cumsum(1)
        return run[:, -1].reshape((self.n,) + tail)


def segment_sums(specs: Sequence[Tuple[torch.Tensor, int, Optional[torch.Tensor]]],
                 fixed_order: Optional[bool] = None) -> list:
    """One ``SegmentSum`` per (int64 index, rows, keep mask or None) of
    ``specs``.  ``fixed_order`` (default: on any device but the CPU) makes
    them sum through the slot grid; the grids' widths come back in one
    transfer."""
    if not specs:
        return []
    if fixed_order is None:
        fixed_order = specs[0][0].device.type != "cpu"
    if not fixed_order:
        return [SegmentSum(idx, n) for idx, n, _ in specs]
    # a dropped block counts under the spare row n
    keys = [idx if keep is None else torch.where(keep, idx, n) for idx, n, keep in specs]
    counts = [torch.bincount(k, minlength=n + 1) for k, (_, n, _) in zip(keys, specs)]
    widths = torch.stack([c[:-1].max() if c.numel() > 1 else c.new_zeros(())
                          for c in counts]).tolist()
    out = []
    for (idx, n, _), key, c, m in zip(specs, keys, counts, widths):
        m = max(int(m), 1)
        # rank of each block among those of its index, in block order
        order = torch.argsort(key, stable=True)
        first = torch.cumsum(c, 0) - c
        ranked = key[order]
        slot = ranked * m + torch.arange(key.numel(), device=key.device) - first[ranked]
        pos = torch.empty_like(key)
        pos[order] = torch.where(ranked < n, slot, n * m)
        out.append(SegmentSum(idx, n, pos, m))
    return out
