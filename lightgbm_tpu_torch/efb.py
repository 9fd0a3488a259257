"""Whether the reference would bundle a dataset's features (EFB).

The port has no Exclusive Feature Bundling yet (ROADMAP.md queue A12b).
The reference plans bundles at construct time (``lightgbm_tpu/efb.py``
``plan_bundles``, called from ``basic.py`` with a 50,000-row sample drawn
by ``RandomState(data_random_seed)``); when that plan bundles anything, its
model is grown on bundle columns and the port's would differ. This module
replays the plan's decision — candidate sparse features (never a
categorical one), pairwise conflict counts, the greedy first-fit — so the
port can refuse exactly the datasets the reference would bundle and train
every other one.
"""
from typing import List, Sequence

import numpy as np

from .binning import BIN_CATEGORICAL, MISSING_NONE, BinMapper

PLAN_SAMPLE = 50_000       # the reference's EFB plan sample (basic.py:506)
MAX_BUNDLE_BINS = 256


def plan_sample_index(n_rows: int, seed: int):
    """Row indices of the plan sample (None: every row)."""
    if n_rows <= PLAN_SAMPLE:
        return None
    return np.random.RandomState(seed).choice(n_rows, PLAN_SAMPLE,
                                              replace=False)


def would_bundle(sample_bins: np.ndarray, mappers: Sequence[BinMapper],
                 max_conflict_rate: float, sparse_threshold: float) -> bool:
    """True when the reference's greedy plan forms a bundle of two or more
    features on these sample bins [n, F] (used features)."""
    n, f = sample_bins.shape
    if f < 3:
        return False
    cand = []
    default_bin = np.zeros(f, dtype=np.int64)
    for j, m in enumerate(mappers):
        # categorical features are never bundled (reference: efb.py:112)
        if (m.bin_type == BIN_CATEGORICAL or m.missing_type != MISSING_NONE
                or m.num_bins < 2):
            continue
        counts = np.bincount(sample_bins[:, j], minlength=m.num_bins)
        db = int(counts.argmax())
        if counts[db] / max(float(n), 1.0) < sparse_threshold:
            continue
        default_bin[j] = db
        cand.append((j, float(n - counts[db])))
    if len(cand) < 2:
        return False
    cj = [j for j, _ in cand]
    nz = (sample_bins[:, cj] != default_bin[cj][None, :]).astype(np.int64)
    conf = nz.T @ nz
    cidx = {j: k for k, j in enumerate(cj)}
    max_conflicts = max_conflict_rate * float(n)
    cand.sort(key=lambda t: (-t[1], t[0]))
    bundles: List[List[int]] = []
    conflict: List[float] = []
    nbins: List[int] = []
    for j, _ in cand:
        extra = mappers[j].num_bins - 1
        for bi, members in enumerate(bundles):
            if nbins[bi] + extra > MAX_BUNDLE_BINS - 1:
                continue
            inter = float(sum(conf[cidx[i], cidx[j]] for i in members))
            if conflict[bi] + inter <= max_conflicts:
                members.append(j)
                conflict[bi] += inter
                nbins[bi] += extra
                break
        else:
            bundles.append([j])
            conflict.append(0.0)
            nbins.append(extra)
    return any(len(b) >= 2 for b in bundles)
