"""Distributed data loading and distributed bin finding.

Port of ``lightgbm_tpu/parallel/dist_data.py`` (reference analogs:
round-robin rows when ``pre_partition=false``, dataset_loader.cpp:505-541;
bin finding split by feature blocks, each rank's mappers from its own
rows, then an Allgather of the serialized mappers,
dataset_loader.cpp:957-1040). Mappers cross as a fixed-width f64 matrix
through the raw-uint8 wire codec (``multihost.wire_allgather``), so every
rank decodes the same list, bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..binning import (BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper,
                       find_bin_mappers)
from ..log import fatal
from ..utils import faults
from ..utils.retry import call_with_backoff
from . import multihost


def round_robin_rows(n_rows: int, rank: int, num_machines: int) -> np.ndarray:
    """The row indices this rank keeps (dataset_loader.cpp:505-541)."""
    return np.arange(rank, n_rows, num_machines)


def feature_slice(num_features: int, rank: int, num_machines: int):
    """The contiguous feature block ``[lo, hi)`` of ``rank``
    (dataset_loader.cpp:957: step = ceil(total / num_machines))."""
    step = (num_features + num_machines - 1) // num_machines
    lo = min(step * rank, num_features)
    return lo, min(lo + step, num_features)


# one mapper a row: [bin_type, missing_type, num_bins, default_bin,
# most_freq_bin, is_trivial, sparse_rate, min_value, max_value, n_payload,
# payload...]; the payload is the upper bounds (numerical, NaN for the NaN
# bin) or the categories
_HDR = 10


def _encode_mapper(m: BinMapper, width: int) -> np.ndarray:
    row = np.zeros(width, dtype=np.float64)
    payload = (m.cat_values.astype(np.float64)
               if m.bin_type == BIN_CATEGORICAL else
               np.asarray(m.upper_bounds, dtype=np.float64))
    if _HDR + len(payload) > width:
        fatal(f"mapper payload {len(payload)} exceeds codec width {width}")
    row[:_HDR] = (m.bin_type, m.missing_type, m.num_bins, m.default_bin,
                  m.most_freq_bin, 1.0 if m.is_trivial else 0.0,
                  m.sparse_rate, m.min_value, m.max_value, len(payload))
    row[_HDR:_HDR + len(payload)] = payload
    return row


def _decode_mapper(row: np.ndarray) -> BinMapper:
    payload = row[_HDR:_HDR + int(row[9])]
    bin_type = int(row[0])
    m = BinMapper(
        num_bins=int(row[2]), bin_type=bin_type, missing_type=int(row[1]),
        upper_bounds=(payload.copy() if bin_type == BIN_NUMERICAL
                      else np.array([np.inf])),
        cat_values=(payload.astype(np.int64) if bin_type == BIN_CATEGORICAL
                    else np.array([], dtype=np.int64)))
    m.default_bin = int(row[3])
    m.most_freq_bin = int(row[4])
    m.is_trivial = bool(row[5] > 0.5)
    m.sparse_rate = float(row[6])
    m.min_value = float(row[7])
    m.max_value = float(row[8])
    return m


def _slice_mbf(max_bin_by_feature, f: int, lo: int, hi: int):
    """max_bin_by_feature checked against the whole feature count, then
    cut to this rank's block (a wrong length would pass unseen on the
    block, dataset.cpp:408)."""
    if not max_bin_by_feature:
        return None
    vals = list(max_bin_by_feature)
    if len(vals) != f:
        fatal(f"max_bin_by_feature has {len(vals)} entries but the data "
              f"has {f} features")
    return vals[lo:hi]


def find_bin_mappers_distributed(
        raw_local: np.ndarray, max_bin: int, min_data_in_bin: int = 3,
        sample_cnt: int = 200000,
        categorical: Optional[Sequence[int]] = None,
        use_missing: bool = True, zero_as_missing: bool = False,
        seed: int = 1, forced_bins=None, max_bin_by_feature=None,
        retries: int = 3) -> List[BinMapper]:
    """The same mappers on every rank: each rank finds the bins of its
    feature block from its own rows (seed + rank), and one allgather of
    the encoded mappers (zeros outside each block, so the rank sum is
    exact) gives every rank the full list. The ``mapper_allgather`` fault
    point and transient failures retry with backoff."""
    nm, rank = multihost.process_count(), multihost.process_index()
    f = raw_local.shape[1]
    lo, hi = feature_slice(f, rank, nm)
    local = find_bin_mappers(
        raw_local[:, lo:hi], max_bin=max_bin,
        min_data_in_bin=min_data_in_bin, sample_cnt=sample_cnt,
        categorical=[c - lo for c in (categorical or ()) if lo <= c < hi],
        use_missing=use_missing, zero_as_missing=zero_as_missing,
        seed=seed + rank,
        forced_bins={k - lo: v for k, v in (forced_bins or {}).items()
                     if lo <= k < hi},
        max_bin_by_feature=_slice_mbf(max_bin_by_feature, f, lo, hi))
    width = _HDR + max(max_bin, *(max_bin_by_feature or [0])) + 2
    enc = np.zeros((f, width), dtype=np.float64)
    for j, m in enumerate(local):
        enc[lo + j] = _encode_mapper(m, width)

    def _gather():
        faults.fault_point("mapper_allgather")
        return np.stack(multihost.wire_allgather(enc, uniform=True))

    full = call_with_backoff(_gather, attempts=max(1, retries),
                             base_delay=0.2,
                             name="bin-mapper allgather").sum(axis=0)
    return [_decode_mapper(full[j]) for j in range(f)]
