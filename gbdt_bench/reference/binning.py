"""Equal-frequency bins of numeric columns, by the rule the program
documents (its package's ``binning.py``: LightGBM's greedy equal-frequency
bins, with zero kept in a bin of its own).

The bounds of a column come from a row sample (``bin_construct_sample_cnt``
rows drawn without replacement by ``numpy.random.RandomState(
data_random_seed).choice``, as LightGBM's Python package draws it). The
sample's distinct values, zero among them when the column has zeros (|v| <
1e-35), are cut into ``n_bins = min(budget, rows // min_data_in_bin)`` bins
of about equal count: a bin closes at the first value at which it holds
its share rows / n_bins, and the bound is the midpoint between that value
and the next. ``budget`` is ``max_bin``, less one for each side of zero
that holds values when the column has zeros; a column with at most
``budget`` distinct values gets a bin for each. With zeros, the bounds
-1e-35 and +1e-35 (for the sides that hold values) are added and any bound
between them dropped, so that zero sits alone; past ``max_bin`` bounds, the
largest finite ones other than those two go. The last bound is +inf. A
value's bin is the first bound not below it.

NaN is not covered: it raises, and the run then reports ``correct`` false.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def sample_rows(n: int, sample_cnt: int, seed: int) -> np.ndarray:
    """The row indices the bounds are found from (all rows when n is not
    above sample_cnt)."""
    if n <= sample_cnt:
        return np.arange(n)
    return np.random.RandomState(seed).choice(n, sample_cnt, replace=False)


ZERO = 1e-35


def _zero_alone(bounds: np.ndarray, has_neg: bool, has_pos: bool
                ) -> np.ndarray:
    extra = ([-ZERO] if has_neg else []) + ([ZERO] if has_pos else [])
    b = np.unique(np.concatenate([bounds, extra]))
    return b[~(np.abs(b) < ZERO)]


def column_bounds(values: np.ndarray, max_bin: int,
                  min_data_in_bin: int) -> np.ndarray:
    """The f64 upper bounds of one column's bins from its sampled values."""
    v = np.asarray(values, dtype=np.float64)
    if np.isnan(v).any():
        raise ValueError("the reference bins numeric columns without NaN")
    is_zero = np.abs(v) < ZERO
    zeros = int(is_zero.sum())
    distinct, counts = np.unique(v[~is_zero], return_counts=True)
    has_neg = bool(len(distinct)) and distinct[0] < -ZERO
    has_pos = bool(len(distinct)) and distinct[-1] > ZERO
    budget = max_bin
    if zeros:
        budget = max(1, max_bin - int(has_neg) - int(has_pos))
        at = np.searchsorted(distinct, 0.0)
        distinct = np.insert(distinct, at, 0.0)
        counts = np.insert(counts, at, zeros)
    if len(distinct) == 0:
        return np.array([np.inf])
    if len(distinct) <= budget:
        if len(distinct) == 1:
            return np.array([np.inf])
        bounds = np.append((distinct[:-1] + distinct[1:]) / 2.0, np.inf)
    else:
        total = int(counts.sum())
        n_bins = max(1, min(budget, total // max(1, min_data_in_bin)))
        per_bin = total / n_bins
        cum = np.cumsum(counts, dtype=np.float64)
        found: List[float] = []
        filled = 0.0
        for _ in range(n_bins - 1):
            # the first value at which this bin holds its share
            i = int(np.searchsorted(cum, filled + per_bin - 1e-9,
                                    side="left"))
            if i >= len(distinct) - 1:
                break
            found.append((distinct[i] + distinct[i + 1]) / 2.0)
            filled = cum[i]
        bounds = np.unique(np.array(found + [np.inf]))
    if zeros:
        bounds = _zero_alone(bounds, has_neg, has_pos)
    if len(bounds) > max_bin:
        free = np.where(~(np.isinf(bounds) | (np.abs(bounds) <= ZERO)))[0]
        bounds = np.delete(bounds, free[len(free) - (len(bounds) - max_bin):])
    return bounds


def find_bounds(x: torch.Tensor, max_bin: int, min_data_in_bin: int,
                sample_cnt: int, seed: int) -> List[np.ndarray]:
    """Every column's bounds; x [N, F] f32 on any device."""
    idx = torch.as_tensor(sample_rows(x.shape[0], sample_cnt, seed),
                          device=x.device)
    sample = x.index_select(0, idx).cpu().numpy()
    return [column_bounds(sample[:, j], max_bin, min_data_in_bin)
            for j in range(sample.shape[1])]


def bin_columns(x: torch.Tensor, bounds: List[np.ndarray],
                block: int = 1 << 22) -> torch.Tensor:
    """[F, N] uint8 bins of x [N, F]: the first bound >= the value, compared
    in f64, in blocks of rows."""
    n, f = x.shape
    out = torch.empty((f, n), dtype=torch.uint8, device=x.device)
    for j in range(f):
        b = torch.as_tensor(bounds[j], dtype=torch.float64, device=x.device)
        for r0 in range(0, n, block):
            col = x[r0:r0 + block, j].to(torch.float64)
            out[j, r0:r0 + block] = torch.searchsorted(b, col).to(torch.uint8)
    return out
