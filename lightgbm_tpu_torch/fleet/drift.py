"""Streaming prediction-distribution comparison: PSI + KS over two windows.

Port of ``lightgbm_tpu/fleet/drift.py`` (host numpy, copied: the PSI and
KS values are the reference's bit for bit on the same streams).

The rollout manager needs to answer one question continuously: *is the
candidate scoring traffic like the incumbent does?* — without labels, on
the serve path, at O(1) per observation. Both sides keep a bounded rolling
window of recent scores (oldest evicted first, so a long canary tracks the
*current* traffic mix, not launch-time traffic); the two classic
drift statistics are computed on demand from the windows:

- **PSI** (population stability index): histogram the candidate window
  against bin edges taken from the incumbent window's quantiles, with
  epsilon smoothing so an empty bin can't blow up the log. The usual
  operating points apply: < 0.1 stable, 0.1–0.25 drifting, > 0.25 act.
- **KS**: the max ECDF gap between the two windows — sensitive to location
  shifts PSI's coarse bins can smear out.

Everything is host-side numpy on <= ``window`` floats per side; evaluation
is throttled by the caller (rollout evaluates every N observations), so
none of this shows up on the request fast path.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Iterable, Tuple

import numpy as np

INCUMBENT = "incumbent"
CANDIDATE = "candidate"

_EPS = 1e-4


class StreamingComparator:
    """Two bounded score windows + PSI/KS on demand (thread-safe)."""

    def __init__(self, window: int = 512, bins: int = 10):
        if window < 2:
            raise ValueError("comparator window must be >= 2")
        self.window = int(window)
        self.bins = max(int(bins), 2)
        self._ref: collections.deque = collections.deque(maxlen=self.window)
        self._cand: collections.deque = collections.deque(maxlen=self.window)
        self._lock = threading.Lock()
        self.observed = {INCUMBENT: 0, CANDIDATE: 0}

    def observe(self, side: str, values: Iterable[float]) -> None:
        """Fold a batch of scores into one side's window. ``values`` is any
        array-like; multiclass rows fold in per-class (the comparison is over
        the score distribution, not per-row tuples)."""
        vals = np.asarray(values, dtype=np.float64).reshape(-1)
        if vals.size == 0:
            return
        dq = self._ref if side == INCUMBENT else self._cand
        with self._lock:
            dq.extend(vals.tolist())
            self.observed[side if side == INCUMBENT else CANDIDATE] += \
                int(vals.size)

    def counts(self) -> Tuple[int, int]:
        with self._lock:
            return len(self._ref), len(self._cand)

    def _windows(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            return (np.asarray(self._ref, dtype=np.float64),
                    np.asarray(self._cand, dtype=np.float64))

    def psi(self) -> float:
        """PSI of the candidate window vs incumbent-quantile bin edges.
        Returns 0.0 until both windows have at least ``bins`` samples."""
        ref, cand = self._windows()
        if ref.size < self.bins or cand.size < self.bins:
            return 0.0
        # interior edges from incumbent quantiles -> equal-mass reference
        # bins; degenerate (constant-score) windows collapse to one bin and
        # compare by mass, which still catches a shifted constant
        edges = np.quantile(ref, np.linspace(0.0, 1.0, self.bins + 1)[1:-1])
        p = np.bincount(np.searchsorted(edges, ref, side="right"),
                        minlength=self.bins).astype(np.float64)
        q = np.bincount(np.searchsorted(edges, cand, side="right"),
                        minlength=self.bins).astype(np.float64)
        p = (p + _EPS) / (p.sum() + _EPS * self.bins)
        q = (q + _EPS) / (q.sum() + _EPS * self.bins)
        return float(np.sum((q - p) * np.log(q / p)))

    def ks(self) -> float:
        """Two-sample KS statistic (max ECDF gap) between the windows."""
        ref, cand = self._windows()
        if ref.size < 2 or cand.size < 2:
            return 0.0
        ref = np.sort(ref)
        cand = np.sort(cand)
        grid = np.concatenate([ref, cand])
        cdf_r = np.searchsorted(ref, grid, side="right") / ref.size
        cdf_c = np.searchsorted(cand, grid, side="right") / cand.size
        return float(np.max(np.abs(cdf_r - cdf_c)))

    def snapshot(self) -> Dict:
        n_ref, n_cand = self.counts()
        return {"window": self.window, "bins": self.bins,
                "n_incumbent": n_ref, "n_candidate": n_cand,
                "observed": dict(self.observed),
                "psi": round(self.psi(), 6), "ks": round(self.ks(), 6)}
