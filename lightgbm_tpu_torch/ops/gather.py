"""Small-table gather: the per-tree score update.

Port of ``lightgbm_tpu/ops/gather.py``: ``table[idx]`` for a small [L] f32
table and [N] row indices, out-of-range indices giving 0.0 (reference:
ScoreUpdater::AddScore's leaf-value add). It always goes through the
``take_small`` kernel wrapper (``hist_kernels.py``), whose plain version
serves CPU tensors.
"""
from __future__ import annotations

import torch

from . import hist_kernels as K


def take_small(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [L] f32, idx [N] int -> [N] f32 (out-of-range -> 0)."""
    return K.take_small(table.to(torch.float32).contiguous(),
                        idx.to(torch.int32).contiguous())
