"""Fixed-order f32 prefix sums and sums of the split search.

Floating-point sums depend on their order. The port fixes the order of the
two reductions that feed split selection to the one the reference's XLA CPU
backend compiles, so the port's split search agrees with the reference bit
for bit on the same histograms, and gives the same bits on the card as on
the CPU:

- ``blocked_cumsum``: XLA rewrites a cumulative sum into 16-wide blocks,
  each scanned left to right, plus an exclusive scan of the block totals
  (applied recursively) added to every element of the block;
- ``tree_sum``: XLA rewrites a long reduction into 32-element windows,
  each summed left to right, and reduces the window sums the same way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SCAN_BLOCK = 16
SUM_WINDOW = 32


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last dimension in XLA's block order."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _seq_cumsum(x)
    pad = (-n) % SCAN_BLOCK
    xp = F.pad(x, (0, pad)) if pad else x
    blk = xp.reshape(*x.shape[:-1], -1, SCAN_BLOCK)
    inner = _seq_cumsum(blk)
    outer = blocked_cumsum(inner[..., -1])
    excl = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]],
                     dim=-1)
    out = inner + excl[..., None]
    return out.reshape(*x.shape[:-1], -1)[..., :n]


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last dimension in XLA's windowed order (exact for
    lengths that are multiples of 32, which every padded bin axis is)."""
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        return _seq_sum(x)
    pad = (-n) % SUM_WINDOW
    xp = F.pad(x, (0, pad)) if pad else x
    parts = _seq_sum(xp.reshape(*x.shape[:-1], -1, SUM_WINDOW))
    return tree_sum(parts)
