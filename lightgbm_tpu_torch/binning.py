"""Feature discretization for dense numeric data.

Port of ``lightgbm_tpu/binning.py``: ``BinMapper`` (numerical mappers found
from a row sample, with the reference's None / Zero / NaN missing modes),
``find_bin_mappers`` (the ``RandomState`` row sample of :557) and
``bin_data``. Bin finding is host numpy, exactly as in the reference; the
bulk encode runs ``torch.searchsorted`` on the target device with the same
f64 comparisons as the reference's ``values_to_bins``, so the uint8 bin
matrix is the reference's byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .log import LightGBMError, warning

K_ZERO_THRESHOLD = 1e-35

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1


@dataclass
class BinMapper:
    """Per-feature value->bin mapping (reference: BinMapper, bin.h:58)."""

    num_bins: int = 1
    bin_type: int = BIN_NUMERICAL
    missing_type: int = MISSING_NONE
    # upper bound of each bin (last +inf); with missing_type NaN the last
    # bin is the NaN bin and its bound is NaN
    upper_bounds: np.ndarray = field(default_factory=lambda: np.array([np.inf]))
    cat_values: np.ndarray = field(
        default_factory=lambda: np.array([], dtype=np.int64))
    default_bin: int = 0
    most_freq_bin: int = 0
    is_trivial: bool = False
    sparse_rate: float = 0.0
    min_value: float = 0.0
    max_value: float = 0.0

    @property
    def na_bin(self) -> int:
        """Index of the bin holding missing values, or -1 if none."""
        if self.bin_type == BIN_CATEGORICAL:
            return 0 if self.missing_type != MISSING_NONE else -1
        if self.missing_type == MISSING_NAN:
            return self.num_bins - 1
        if self.missing_type == MISSING_ZERO:
            return self.default_bin
        return -1

    @staticmethod
    def from_sample(values: np.ndarray, total_cnt: int, max_bin: int,
                    min_data_in_bin: int = 3, use_missing: bool = True,
                    zero_as_missing: bool = False) -> "BinMapper":
        """Numerical bins from the sampled raw values of one feature
        (``len(values) < total_cnt`` means the rest are implicit zeros)."""
        values = np.asarray(values, dtype=np.float64)
        na_cnt = int(np.isnan(values).sum())
        vals = values[~np.isnan(values)]
        implicit_zeros = max(0, total_cnt - len(values))
        zero_cnt = implicit_zeros + int((np.abs(vals) < K_ZERO_THRESHOLD).sum())
        nonzero = vals[np.abs(vals) >= K_ZERO_THRESHOLD]
        if zero_as_missing:
            missing_type = MISSING_ZERO
        elif use_missing and na_cnt > 0:
            missing_type = MISSING_NAN
        else:
            missing_type = MISSING_NONE
            zero_cnt += na_cnt
            na_cnt = 0
        n_avail = max_bin - (1 if missing_type == MISSING_NAN else 0)
        distinct, counts = np.unique(nonzero, return_counts=True)
        bounds = _find_weighted_bounds(distinct, counts.astype(np.int64),
                                       zero_cnt, n_avail, min_data_in_bin)
        num_bins = len(bounds)
        if missing_type == MISSING_NAN:
            bounds = np.append(bounds, np.nan)
            num_bins += 1
        m = BinMapper(num_bins=num_bins, missing_type=missing_type,
                      upper_bounds=bounds)
        m.default_bin = int(m.values_to_bins(np.array([0.0]))[0])
        m.is_trivial = num_bins <= 1
        m.sparse_rate = zero_cnt / max(1, total_cnt)
        m.most_freq_bin = m.default_bin if m.sparse_rate >= 0.5 else 0
        if len(nonzero) or zero_cnt:
            allv = nonzero if zero_cnt == 0 else np.append(nonzero, 0.0)
            m.min_value = float(allv.min())
            m.max_value = float(allv.max())
        return m

    def _numeric_bounds(self) -> Tuple[int, np.ndarray]:
        n_numeric = self.num_bins - (1 if self.missing_type == MISSING_NAN else 0)
        return n_numeric, np.asarray(self.upper_bounds[:n_numeric],
                                     dtype=np.float64)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (reference: BinMapper::ValueToBin)."""
        if self.bin_type == BIN_CATEGORICAL:
            raise NotImplementedError(
                "categorical features are ROADMAP queue A12, not yet ported")
        values = np.asarray(values, dtype=np.float64)
        n_numeric, bounds = self._numeric_bounds()
        na = np.isnan(values)
        v = np.where(na, 0.0, values)
        out = np.searchsorted(bounds[:-1], v, side="left").astype(np.int32)
        gt = v > np.take(bounds, np.minimum(out, len(bounds) - 1))
        out = np.where(gt, out + 1, out)
        out = np.minimum(out, n_numeric - 1)
        if self.missing_type == MISSING_NAN:
            out = np.where(na, self.num_bins - 1, out)
        return out.astype(np.int32)

    def values_to_bins_torch(self, v: torch.Tensor) -> torch.Tensor:
        """values_to_bins on a device f64 tensor -> int64 bins."""
        n_numeric, bounds_np = self._numeric_bounds()
        bounds = torch.as_tensor(bounds_np, dtype=torch.float64,
                                 device=v.device)
        na = torch.isnan(v)
        v = torch.where(na, torch.zeros_like(v), v)
        if len(bounds_np) > 1:
            out = torch.searchsorted(bounds[:-1].contiguous(), v)
        else:
            out = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
        gt = v > bounds[torch.clamp(out, max=len(bounds_np) - 1)]
        out = torch.where(gt, out + 1, out)
        out = torch.clamp(out, max=n_numeric - 1)
        if self.missing_type == MISSING_NAN:
            out = torch.where(na, torch.full_like(out, self.num_bins - 1), out)
        return out

    def bin_to_value(self, b: int) -> float:
        """Representative threshold value for bin b (its upper bound)."""
        n_numeric, _ = self._numeric_bounds()
        return float(self.upper_bounds[min(b, n_numeric - 1)])

    def to_feature_info(self) -> str:
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_CATEGORICAL:
            return ":".join(str(int(c)) for c in self.cat_values)
        return f"[{self.min_value}:{self.max_value}]"


def _find_weighted_bounds(distinct: np.ndarray, counts: np.ndarray,
                          zero_cnt: int, max_bin: int,
                          min_data_in_bin: int) -> np.ndarray:
    """Equal-frequency bin upper bounds over (sorted distinct nonzero values
    with multiplicities + zero_cnt zeros); strictly increasing, last +inf,
    zero kept separable (reference: binning.py _find_weighted_bounds)."""
    if len(distinct) == 0 and zero_cnt == 0:
        return np.array([np.inf])
    reserve = 0
    if zero_cnt > 0:
        reserve = int(np.any(distinct < -K_ZERO_THRESHOLD)) \
            + int(np.any(distinct > K_ZERO_THRESHOLD))
    budget = max(1, max_bin - reserve)
    if zero_cnt > 0:
        pos = np.searchsorted(distinct, 0.0)
        distinct = np.insert(distinct, pos, 0.0)
        counts = np.insert(counts, pos, zero_cnt)
    if len(distinct) <= max(1, budget):
        if len(distinct) == 1:
            return np.array([np.inf])
        mids = (distinct[:-1] + distinct[1:]) / 2.0
        bounds = _fix_zero_boundary(np.append(mids, np.inf), distinct)
    else:
        total = counts.sum()
        n_bins = max(1, min(budget, int(total // max(1, min_data_in_bin)) or 1))
        target = total / n_bins
        cum = np.cumsum(counts, dtype=np.float64)
        bounds_list: List[float] = []
        base = 0.0
        last = len(distinct) - 1
        for _ in range(n_bins - 1):
            i = int(np.searchsorted(cum, base + target - 1e-9, side="left"))
            if i >= last:
                break
            bounds_list.append((distinct[i] + distinct[i + 1]) / 2.0)
            base = cum[i]
        bounds = np.unique(np.array(bounds_list + [np.inf]))
        if zero_cnt > 0:
            bounds = _fix_zero_boundary(bounds, distinct)
    if len(bounds) > max_bin:
        drop_n = len(bounds) - max_bin
        protected = np.isinf(bounds) | (np.abs(bounds) <= K_ZERO_THRESHOLD)
        unprot = np.where(~protected)[0]
        keep = np.ones(len(bounds), dtype=bool)
        if len(unprot) >= drop_n:
            keep[unprot[-drop_n:]] = False
        else:
            keep[unprot] = False
            zero_prot = np.where(protected & ~np.isinf(bounds))[0]
            keep[zero_prot[: drop_n - len(unprot)]] = False
        bounds = bounds[keep]
    return bounds


def _fix_zero_boundary(bounds: np.ndarray, distinct: np.ndarray) -> np.ndarray:
    has_neg = distinct[0] < -K_ZERO_THRESHOLD
    has_pos = distinct[-1] > K_ZERO_THRESHOLD
    if not np.any(np.abs(distinct) < K_ZERO_THRESHOLD):
        return bounds
    add = []
    if has_neg:
        add.append(-K_ZERO_THRESHOLD)
    if has_pos:
        add.append(K_ZERO_THRESHOLD)
    if add:
        bounds = np.unique(np.concatenate([bounds, add]))
        bounds = bounds[~(np.abs(bounds) < K_ZERO_THRESHOLD)]
    return bounds


def check_max_bin_by_feature(max_bin_by_feature, num_features: int,
                             max_bin: int) -> List[int]:
    """Per-feature bin budgets (reference: config.h:502 max_bin_by_feature)."""
    if not max_bin_by_feature:
        return [max_bin] * num_features
    vals = [int(v) for v in max_bin_by_feature]
    if len(vals) != num_features:
        raise LightGBMError(f"max_bin_by_feature has {len(vals)} entries but "
                            f"the data has {num_features} features")
    if min(vals) <= 1:
        raise LightGBMError("every entry of max_bin_by_feature must be > 1")
    if max(vals) > 256:
        warning("max_bin_by_feature entries > 256 not supported (uint8 "
                "bins); clamping to 256")
        vals = [min(v, 256) for v in vals]
    return vals


def find_bin_mappers(data: np.ndarray, max_bin: int, min_data_in_bin: int = 3,
                     sample_cnt: int = 200000, use_missing: bool = True,
                     zero_as_missing: bool = False, seed: int = 1,
                     max_bin_by_feature: Optional[Sequence[int]] = None
                     ) -> List[BinMapper]:
    """Per-feature mappers from a row sample of ``data`` [N, F]."""
    n, f = data.shape
    rng = np.random.RandomState(seed)
    if n > sample_cnt:
        sample = data[rng.choice(n, sample_cnt, replace=False)]
    else:
        sample = data
    per_feat = check_max_bin_by_feature(max_bin_by_feature, f, max_bin)
    return [BinMapper.from_sample(sample[:, j], len(sample), per_feat[j],
                                  min_data_in_bin=min_data_in_bin,
                                  use_missing=use_missing,
                                  zero_as_missing=zero_as_missing)
            for j in range(f)]


def used_features(mappers: Sequence[BinMapper]) -> List[int]:
    """Columns that carry information (the reference drops trivial ones)."""
    used = [j for j, m in enumerate(mappers) if not m.is_trivial]
    return used or ([0] if mappers else [])


def bin_data(data: np.ndarray, mappers: Sequence[BinMapper],
             columns: Sequence[int], device: torch.device) -> torch.Tensor:
    """Encode the raw columns ``columns`` of ``data`` [N, F] with their
    mappers into a uint8 [N, len(columns)] matrix on ``device``."""
    n = data.shape[0]
    out = torch.empty((n, len(columns)), dtype=torch.uint8, device=device)
    for k, j in enumerate(columns):
        m = mappers[k]
        if m.num_bins > 256:
            raise LightGBMError(f"feature {j}: {m.num_bins} bins > 256 "
                                "unsupported")
        col = torch.as_tensor(np.ascontiguousarray(data[:, j]), device=device)
        out[:, k] = m.values_to_bins_torch(col.to(torch.float64)).to(torch.uint8)
    return out
