"""Exact prediction routing via pseudo-bins.

Port of ``lightgbm_tpu/io/pseudo_bins.py`` (host numpy, copied; its tables
are the reference's array for array). The LightGBM reference keeps f64
thresholds end-to-end at predict time (tree.h:240 NumericalDecision on
double). A device walk over f32 values
against f32-cast thresholds can mis-route rows near a bin boundary — and
categorical bitset decisions (tree.h:279) have no float-compare form at
all. This module keeps the exact semantics with integer compares on the
device:

1. On the host (f64), collect per-feature the sorted unique thresholds used
   by the model and the union of categorical bitset values.
2. Map each input column to an integer *pseudo-bin*: for numerical features
   ``searchsorted`` against the f64 thresholds (v <= thr  <=>  pb(v) <= idx(thr),
   exactly); for categorical features a dense id per known category (unknown /
   NaN / negative -> id 0, which no subset contains -> routed right, matching
   the reference).
3. Route on device with pure integer compares + bitset lookups
   (serving.py's walk of every tree at once) — bit-exact with the host
   model, f32-free.

This is the predict path for every Booster — in-session and loaded models run
the same code, so save/load cannot change predictions. The reference's
signed-path tables for its matmul predictor (``dense_tables``) exist for
the TPU's MXU and are not ported: the card walks the stack.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..models.tree import Tree

_ZERO_EPS = 1e-35


class PseudoRouter:
    """Per-feature value -> pseudo-bin mapping + stacked per-node tables."""

    def __init__(self, trees: List[Tree], n_features: int):
        thr_vals: List[List[float]] = [[] for _ in range(n_features)]
        cat_vals: List[set] = [set() for _ in range(n_features)]
        self.mt = np.zeros(n_features, dtype=np.int32)
        self.is_cat_feat = np.zeros(n_features, dtype=bool)
        for t in trees:
            for i in range(max(t.num_leaves - 1, 0)):
                f = int(t.split_feature[i])
                self.mt[f] = t.missing_type[i]
                if t.is_cat_node[i]:
                    self.is_cat_feat[f] = True
                    cat_vals[f].update(int(v) for v in t.cat_sets[i])
                else:
                    thr_vals[f].append(float(t.threshold_real[i]))

        self.thr_sorted = [np.unique(np.asarray(v, dtype=np.float64))
                           for v in thr_vals]
        self.cat_ids: List[Dict[int, int]] = [
            {v: j + 1 for j, v in enumerate(sorted(cv))} for cv in cat_vals]
        # numerical feature f: ids 0..len(thr); missing id = len(thr)+1
        self.na_id = np.array(
            [len(t) + 1 if not c else 1 << 30
             for t, c in zip(self.thr_sorted, self.is_cat_feat)],
            dtype=np.int32)
        self.max_cat_id = max((len(m) + 1 for m in self.cat_ids), default=1)

        # stacked per-node tables in pseudo space
        T = len(trees)
        max_l = max((t.num_leaves for t in trees), default=1)
        max_i = max(max_l - 1, 1)
        self.stack = {
            "split_feature": np.zeros((T, max_i), dtype=np.int32),
            "threshold_bin": np.zeros((T, max_i), dtype=np.int32),
            "default_left": np.zeros((T, max_i), dtype=bool),
            "left_child": np.full((T, max_i), -1, dtype=np.int32),
            "right_child": np.full((T, max_i), -1, dtype=np.int32),
            "leaf_value": np.zeros((T, max_l), dtype=np.float32),
            "num_leaves": np.zeros((T,), dtype=np.int32),
        }
        any_cat = any(t.num_cat > 0 for t in trees)
        if any_cat:
            self.stack["is_cat"] = np.zeros((T, max_i), dtype=bool)
            self.stack["cat_mask"] = np.zeros((T, max_i, self.max_cat_id),
                                              dtype=bool)
        for ti, t in enumerate(trees):
            n_int = max(t.num_leaves - 1, 0)
            self.stack["split_feature"][ti, :n_int] = t.split_feature
            self.stack["default_left"][ti, :n_int] = t.default_left
            self.stack["left_child"][ti, :n_int] = t.left_child
            self.stack["right_child"][ti, :n_int] = t.right_child
            self.stack["leaf_value"][ti, :t.num_leaves] = t.leaf_value
            self.stack["num_leaves"][ti] = t.num_leaves
            for i in range(n_int):
                f = int(t.split_feature[i])
                if t.is_cat_node[i]:
                    self.stack["is_cat"][ti, i] = True
                    ids = [self.cat_ids[f][int(v)] for v in t.cat_sets[i]]
                    self.stack["cat_mask"][ti, i, ids] = True
                    self.stack["threshold_bin"][ti, i] = -1
                else:
                    # exact: the threshold was collected into thr_sorted
                    idx = int(np.searchsorted(self.thr_sorted[f],
                                              t.threshold_real[i]))
                    self.stack["threshold_bin"][ti, i] = idx
        from ..models.tree import ensemble_max_depth
        self.max_steps = ensemble_max_depth(self.stack)

    def bin_matrix(self, x: np.ndarray,
                   out: "np.ndarray | None" = None) -> np.ndarray:
        """[N, F] f64 raw features -> [N, F] i32 pseudo-bins (host, exact).

        ``out`` reuses a caller-owned [N, F] i32 buffer (serve staging path);
        every column is fully overwritten, so a dirty buffer is fine."""
        n, f = x.shape
        if out is None:
            out = np.zeros((n, f), dtype=np.int32)
        elif out.shape != (n, f) or out.dtype != np.int32:
            raise ValueError(f"out must be [{n}, {f}] int32, got "
                             f"{out.shape} {out.dtype}")
        for j in range(f):
            v = np.asarray(x[:, j], dtype=np.float64)
            if self.is_cat_feat[j]:
                cats_sorted = np.asarray(sorted(self.cat_ids[j]), dtype=np.int64)
                finite = np.isfinite(v) & (v >= 0)
                iv = np.where(finite, v, 0).astype(np.int64)
                pos = np.searchsorted(cats_sorted, iv)
                pos_c = np.minimum(pos, max(len(cats_sorted) - 1, 0))
                match = finite & (pos < len(cats_sorted)) \
                    & (len(cats_sorted) > 0)
                if len(cats_sorted):
                    match &= cats_sorted[pos_c] == iv
                out[:, j] = np.where(match, pos_c + 1, 0).astype(np.int32)
            else:
                mt = self.mt[j]
                isnan = np.isnan(v)
                v0 = np.where(isnan & (mt == MISSING_NONE), 0.0, v)
                missing = np.where(
                    mt == MISSING_NAN, isnan,
                    (np.abs(v0) < _ZERO_EPS) | isnan
                    if mt == MISSING_ZERO else np.zeros(n, bool))
                pb = np.searchsorted(self.thr_sorted[j], v0,
                                     side="left").astype(np.int32)
                out[:, j] = np.where(missing, self.na_id[j], pb)
        return out
