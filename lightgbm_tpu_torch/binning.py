"""Feature discretization for dense and scipy-sparse data.

Port of ``lightgbm_tpu/binning.py``: ``BinMapper`` (numerical mappers found
from a row sample, with the reference's None / Zero / NaN missing modes;
categorical mappers with count-ordered category bins, :323-370),
``find_bin_mappers`` (the ``RandomState`` row sample of :557, with the
``categorical`` columns of :543) and ``bin_data``, and for CSC input
``find_bin_mappers_sparse`` (:598; only stored values are sampled, the
rest of the sample counts as zeros), ``bin_sparse_column`` (:644) and
``bin_data_sparse`` (:657; an absent entry takes the bin of 0.0), the
exact mergeable sketches of the process-spanning bin finding
(``FeatureSketch``, ``sketch_feature``, ``merge_sketches``,
``BinMapper.from_sketch``; :134, :421-520); the
forced bin bounds of ``forcedbins_filename`` (``forced_bins``: a
feature's bounds used verbatim, at most max_bin - 1 of them, then +inf;
:234-239, :552-573, :607-639). Bin
finding is host numpy, exactly as in the reference; the bulk encode runs
``torch.searchsorted`` on the target device with the same f64 comparisons
as the reference's ``values_to_bins``, so the uint8 bin matrix is the
reference's byte for byte. A categorical column is encoded by a lookup
(the categories sorted, ``searchsorted``, then each one's count-order
bin) where the reference compares every row with each category in turn;
the bins are the same. A valid set binned with its reference's mappers
is the reference's frozen re-binning (``rebin_frozen``, :755): unseen
categories land in bin 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

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
                    zero_as_missing: bool = False,
                    bin_type: int = BIN_NUMERICAL,
                    forced_bounds: Optional[Sequence[float]] = None
                    ) -> "BinMapper":
        """Bins from the sampled raw values of one feature
        (``len(values) < total_cnt`` means the rest are implicit zeros);
        ``forced_bounds`` replace the found upper bounds."""
        values = np.asarray(values, dtype=np.float64)
        if bin_type == BIN_CATEGORICAL:
            return BinMapper._categorical_from_sample(
                values, total_cnt, max_bin, min_data_in_bin, use_missing)
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
                                       zero_cnt, n_avail, min_data_in_bin,
                                       forced_bounds)
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

    @staticmethod
    def from_sketch(sketch: "FeatureSketch", max_bin: int,
                    min_data_in_bin: int = 3, use_missing: bool = True,
                    zero_as_missing: bool = False,
                    forced_bounds: Optional[Sequence[float]] = None
                    ) -> "BinMapper":
        """Bins from a (possibly merged) ``FeatureSketch`` (reference:
        :134): ``from_sample(values)`` equals
        ``from_sketch(sketch_feature(values))`` bit for bit, and a merge of
        per-process sketches changes nothing, since a sketch is exact."""
        if sketch.bin_type == BIN_CATEGORICAL:
            return BinMapper._categorical_from_weighted(
                sketch.distinct, sketch.counts, max_bin, min_data_in_bin,
                use_missing)
        na_cnt = int(sketch.na_cnt)
        zero_cnt = int(sketch.zero_cnt)
        if zero_as_missing:
            missing_type = MISSING_ZERO
        elif use_missing and na_cnt > 0:
            missing_type = MISSING_NAN
        else:
            missing_type = MISSING_NONE
            zero_cnt += na_cnt
        distinct = np.asarray(sketch.distinct, dtype=np.float64)
        counts = np.asarray(sketch.counts, dtype=np.int64)
        n_avail = max_bin - (1 if missing_type == MISSING_NAN else 0)
        bounds = _find_weighted_bounds(distinct, counts, zero_cnt, n_avail,
                                       min_data_in_bin, forced_bounds)
        num_bins = len(bounds)
        if missing_type == MISSING_NAN:
            bounds = np.append(bounds, np.nan)
            num_bins += 1
        m = BinMapper(num_bins=num_bins, missing_type=missing_type,
                      upper_bounds=bounds)
        m.default_bin = int(m.values_to_bins(np.array([0.0]))[0])
        m.is_trivial = num_bins <= 1
        m.sparse_rate = zero_cnt / max(1, sketch.total_cnt)
        m.most_freq_bin = m.default_bin if m.sparse_rate >= 0.5 else 0
        if len(distinct) or zero_cnt:
            lo = float(distinct[0]) if len(distinct) else 0.0
            hi = float(distinct[-1]) if len(distinct) else 0.0
            if zero_cnt:
                lo, hi = min(lo, 0.0), max(hi, 0.0)
            m.min_value, m.max_value = lo, hi
        return m

    @staticmethod
    def _categorical_from_sample(values: np.ndarray, total_cnt: int,
                                 max_bin: int, min_data_in_bin: int,
                                 use_missing: bool) -> "BinMapper":
        """Categorical bins (reference: :323): NaN and negative values are
        missing; the sample's implicit zeros count as category 0."""
        na_mask = np.isnan(values) | (values < 0)
        if np.any(values < 0):
            warning("negative categorical value found; treated as missing")
        cats = values[~na_mask].astype(np.int64)
        implicit_zeros = max(0, total_cnt - len(values))
        if implicit_zeros:
            cats = np.concatenate([cats, np.zeros(implicit_zeros,
                                                  dtype=np.int64)])
        distinct, counts = np.unique(cats, return_counts=True)
        return BinMapper._categorical_from_weighted(
            distinct, counts.astype(np.int64), max_bin, min_data_in_bin,
            use_missing)

    @staticmethod
    def _categorical_from_weighted(distinct: np.ndarray, counts: np.ndarray,
                                   max_bin: int, min_data_in_bin: int,
                                   use_missing: bool) -> "BinMapper":
        """Bin 0 is other/missing; bins 1..keep hold the categories by
        descending count, ties by ascending category (a stable sort of the
        sorted distinct values). At most max_bin - 1 are kept, and the rare
        tail (fewer than min_data_in_bin rows past 99% of the mass) is cut
        into bin 0 (reference: :340)."""
        distinct = np.asarray(distinct, dtype=np.int64)
        counts = np.asarray(counts, dtype=np.int64)
        n_distinct_all = len(distinct)
        order = np.argsort(-counts, kind="stable")
        distinct, counts = distinct[order], counts[order]
        keep = min(len(distinct), max_bin - 1)
        cum = np.cumsum(counts)
        total = cum[-1] if len(cum) else 0
        while (keep > 1 and counts[keep - 1] < min_data_in_bin
               and cum[keep - 1] > 0.99 * total):
            keep -= 1
        m = BinMapper(num_bins=max(1, keep + 1), bin_type=BIN_CATEGORICAL,
                      missing_type=MISSING_NAN if use_missing
                      else MISSING_NONE,
                      cat_values=distinct[:keep])
        m.is_trivial = keep <= 1 and n_distinct_all <= 1
        return m

    def _category_lookup(self) -> Tuple[np.ndarray, np.ndarray]:
        """(the categories sorted, the bin of each): bin b holds
        cat_values[b - 1]."""
        order = np.argsort(self.cat_values, kind="stable")
        return (np.asarray(self.cat_values, dtype=np.int64)[order],
                (order + 1).astype(np.int64))

    def _numeric_bounds(self) -> Tuple[int, np.ndarray]:
        n_numeric = self.num_bins - (1 if self.missing_type == MISSING_NAN else 0)
        return n_numeric, np.asarray(self.upper_bounds[:n_numeric],
                                     dtype=np.float64)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (reference: BinMapper::ValueToBin). A
        categorical value is truncated to its integer category; NaN,
        negative and unseen categories give bin 0."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_CATEGORICAL:
            cats, cat_bins = self._category_lookup()
            ok = ~np.isnan(values) & (values >= 0) & (values < 2.0 ** 63)
            iv = np.where(ok, values, -1.0).astype(np.int64)
            if not len(cats):
                return np.zeros(len(values), dtype=np.int32)
            pos = np.minimum(np.searchsorted(cats, iv), len(cats) - 1)
            hit = ok & (cats[pos] == iv)
            return np.where(hit, cat_bins[pos], 0).astype(np.int32)
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
        if self.bin_type == BIN_CATEGORICAL:
            cats_np, bins_np = self._category_lookup()
            if not len(cats_np):
                return torch.zeros(v.shape, dtype=torch.int64,
                                   device=v.device)
            cats = torch.as_tensor(cats_np, device=v.device)
            cat_bins = torch.as_tensor(bins_np, device=v.device)
            ok = ~torch.isnan(v) & (v >= 0) & (v < 2.0 ** 63)
            iv = torch.where(ok, v, torch.full_like(v, -1.0)).to(torch.int64)
            pos = torch.searchsorted(cats, iv).clamp(max=len(cats_np) - 1)
            hit = ok & (cats[pos] == iv)
            return torch.where(hit, cat_bins[pos], torch.zeros_like(pos))
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
        """Representative threshold value for bin b: its upper bound, or
        for a categorical mapper its category (-1 for bin 0)."""
        if self.bin_type == BIN_CATEGORICAL:
            return (float(self.cat_values[b - 1])
                    if 1 <= b <= len(self.cat_values) else -1.0)
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
                          min_data_in_bin: int,
                          forced_bounds: Optional[Sequence[float]] = None
                          ) -> np.ndarray:
    """Equal-frequency bin upper bounds over (sorted distinct nonzero values
    with multiplicities + zero_cnt zeros); strictly increasing, last +inf,
    zero kept separable (reference: binning.py _find_weighted_bounds).
    Forced bounds are used verbatim instead: sorted, unique, at most
    max_bin - 1 of them, then +inf."""
    if len(distinct) == 0 and zero_cnt == 0:
        return np.array([np.inf])
    if forced_bounds is not None and len(forced_bounds):
        fb = np.unique(np.asarray(sorted(forced_bounds), dtype=np.float64))
        return np.append(fb[: max(1, max_bin - 1)], np.inf)
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


@dataclass
class FeatureSketch:
    """Exact mergeable sketch of one feature over one process's sample
    (reference: :421): the sorted distinct nonzero values with their
    multiplicities and the zero, NaN and row tallies. A categorical
    sketch holds the categories (implicit zeros included) as f64 and
    ``zero_cnt`` 0. A merge is the union of the distinct values with
    summed counts: commutative and associative, so a merge in any order
    is the sketch of the concatenated sample."""
    bin_type: int = BIN_NUMERICAL
    distinct: np.ndarray = field(
        default_factory=lambda: np.array([], dtype=np.float64))
    counts: np.ndarray = field(
        default_factory=lambda: np.array([], dtype=np.int64))
    zero_cnt: int = 0
    na_cnt: int = 0
    total_cnt: int = 0


def sketch_feature(values: np.ndarray, total_cnt: int,
                   bin_type: int = BIN_NUMERICAL) -> FeatureSketch:
    """Sketch one feature's sampled values (reference: :447), with
    ``from_sample``'s conventions: NaN allowed, ``total_cnt >
    len(values)`` means the rest are implicit zeros."""
    values = np.asarray(values, dtype=np.float64)
    implicit_zeros = max(0, total_cnt - len(values))
    if bin_type == BIN_CATEGORICAL:
        na_mask = np.isnan(values) | (values < 0)
        cats = values[~na_mask].astype(np.int64)
        if implicit_zeros:
            cats = np.concatenate([cats, np.zeros(implicit_zeros,
                                                  dtype=np.int64)])
        distinct, counts = np.unique(cats, return_counts=True)
        return FeatureSketch(BIN_CATEGORICAL, distinct.astype(np.float64),
                             counts.astype(np.int64), 0,
                             int(na_mask.sum()), int(total_cnt))
    na_cnt = int(np.isnan(values).sum())
    vals = values[~np.isnan(values)]
    zero_cnt = implicit_zeros + int((np.abs(vals) < K_ZERO_THRESHOLD).sum())
    distinct, counts = np.unique(vals[np.abs(vals) >= K_ZERO_THRESHOLD],
                                 return_counts=True)
    return FeatureSketch(BIN_NUMERICAL, distinct, counts.astype(np.int64),
                         int(zero_cnt), na_cnt, int(total_cnt))


def merge_sketches(sketches: Sequence[FeatureSketch]) -> FeatureSketch:
    """Merge the sketches of one feature (reference: :488): the union of
    the distinct values with summed counts, in any order the same."""
    sketches = list(sketches)
    if not sketches:
        return FeatureSketch()
    bt = sketches[0].bin_type
    if any(s.bin_type != bt for s in sketches):
        raise ValueError("merge_sketches: mixed bin_type sketches")
    alld = np.concatenate([np.asarray(s.distinct, dtype=np.float64)
                           for s in sketches])
    allc = np.concatenate([np.asarray(s.counts, dtype=np.int64)
                           for s in sketches])
    distinct, inverse = np.unique(alld, return_inverse=True)
    counts = np.zeros(len(distinct), dtype=np.int64)
    np.add.at(counts, np.asarray(inverse).ravel(), allc)
    return FeatureSketch(bt, distinct, counts,
                         int(sum(s.zero_cnt for s in sketches)),
                         int(sum(s.na_cnt for s in sketches)),
                         int(sum(s.total_cnt for s in sketches)))


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
                     max_bin_by_feature: Optional[Sequence[int]] = None,
                     categorical: Optional[Sequence[int]] = None,
                     forced_bins: Optional[Dict[int, Sequence[float]]] = None
                     ) -> List[BinMapper]:
    """Per-feature mappers from a row sample of ``data`` [N, F]; the
    columns ``categorical`` get categorical mappers, the columns of
    ``forced_bins`` its bounds."""
    n, f = data.shape
    rng = np.random.RandomState(seed)
    if n > sample_cnt:
        sample = data[rng.choice(n, sample_cnt, replace=False)]
    else:
        sample = data
    per_feat = check_max_bin_by_feature(max_bin_by_feature, f, max_bin)
    cats = set(categorical or ())
    return [BinMapper.from_sample(sample[:, j], len(sample), per_feat[j],
                                  min_data_in_bin=min_data_in_bin,
                                  use_missing=use_missing,
                                  zero_as_missing=zero_as_missing,
                                  bin_type=BIN_CATEGORICAL if j in cats
                                  else BIN_NUMERICAL,
                                  forced_bounds=(forced_bins or {}).get(j))
            for j in range(f)]


def find_bin_mappers_sparse(csc, max_bin: int, min_data_in_bin: int = 3,
                            sample_cnt: int = 200000,
                            use_missing: bool = True,
                            zero_as_missing: bool = False, seed: int = 1,
                            max_bin_by_feature: Optional[Sequence[int]] = None,
                            categorical: Optional[Sequence[int]] = None,
                            forced_bins: Optional[
                                Dict[int, Sequence[float]]] = None
                            ) -> List[BinMapper]:
    """Per-feature mappers of a scipy CSC matrix without densifying it
    (reference: find_bin_mappers_sparse, binning.py:598): the same row
    sample as ``find_bin_mappers``, of which only each column's stored
    values are handed to ``from_sample``; the rest of the sample counts as
    implicit zeros through its ``total_cnt``."""
    n, f = csc.shape
    if n > sample_cnt:
        idx = np.sort(np.random.RandomState(seed).choice(n, sample_cnt,
                                                         replace=False))
        sub, total = csc[idx].tocsc(), sample_cnt
    else:
        sub, total = csc.tocsc(), n
    per_feat = check_max_bin_by_feature(max_bin_by_feature, f, max_bin)
    cats = set(categorical or ())
    return [BinMapper.from_sample(
        sub.data[sub.indptr[j]:sub.indptr[j + 1]], total, per_feat[j],
        min_data_in_bin=min_data_in_bin, use_missing=use_missing,
        zero_as_missing=zero_as_missing,
        bin_type=BIN_CATEGORICAL if j in cats else BIN_NUMERICAL,
        forced_bounds=(forced_bins or {}).get(j))
        for j in range(f)]


def sparse_column_bins(mapper: BinMapper, csc, col: int,
                       device: torch.device
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One CSC column binned on ``device``: (the rows of its stored values
    [nnz] i64, their bins [nnz] i64, the bin of an absent entry, i.e. of
    0.0)."""
    lo, hi = int(csc.indptr[col]), int(csc.indptr[col + 1])
    rows = torch.as_tensor(csc.indices[lo:hi], device=device).to(torch.int64)
    vals = torch.as_tensor(csc.data[lo:hi], device=device)
    zero_bin = int(mapper.values_to_bins(np.zeros(1))[0])
    return rows, mapper.values_to_bins_torch(vals.to(torch.float64)), zero_bin


def bin_sparse_column(mapper: BinMapper, csc, col: int,
                      out_col: np.ndarray) -> None:
    """Bin one CSC column into ``out_col`` [N] uint8 on the host: absent
    entries take the bin of 0.0, stored values their own (reference:
    bin_sparse_column, binning.py:644)."""
    lo, hi = csc.indptr[col], csc.indptr[col + 1]
    out_col[:] = np.uint8(mapper.values_to_bins(np.zeros(1))[0])
    if hi > lo:
        out_col[csc.indices[lo:hi]] = mapper.values_to_bins(
            csc.data[lo:hi]).astype(np.uint8)


def bin_data_sparse(csc, mappers: Sequence[BinMapper],
                    columns: Sequence[int],
                    device: torch.device) -> torch.Tensor:
    """Encode the raw columns ``columns`` of a scipy CSC matrix with their
    mappers into a uint8 [N, len(columns)] matrix on ``device`` (reference:
    bin_data_sparse, binning.py:657), one column's stored values at a
    time."""
    out = torch.empty((csc.shape[0], len(columns)), dtype=torch.uint8,
                      device=device)
    for k, j in enumerate(columns):
        if mappers[k].num_bins > 256:
            raise LightGBMError(f"feature {j}: {mappers[k].num_bins} bins > "
                                "256 unsupported")
        rows, bins, zero_bin = sparse_column_bins(mappers[k], csc, int(j),
                                                  device)
        out[:, k] = zero_bin
        out[rows, k] = bins.to(torch.uint8)
    return out


def used_features(mappers: Sequence[BinMapper]) -> List[int]:
    """Columns that carry information (the reference drops trivial ones)."""
    used = [j for j, m in enumerate(mappers) if not m.is_trivial]
    return used or ([0] if mappers else [])


def bin_data(data: np.ndarray, mappers: Sequence[BinMapper],
             columns: Sequence[int], device: torch.device) -> torch.Tensor:
    """Encode the raw columns ``columns`` of ``data`` [N, F] with their
    mappers into a uint8 [N, len(columns)] matrix on ``device``, a column
    at a time: the plain version of ``ingest.py``'s pipeline."""
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
