"""Host-side tree model.

Port of ``lightgbm_tpu/models/tree.py`` ``Tree`` (:22): the finalized
flat-array tree (trimmed to its real leaf count, bin thresholds mapped to
real-valued thresholds through the BinMappers) and its block of the
reference model-text format (gbdt_model_text.cpp:271, tree.cpp:209-246).
Categorical nodes are parsed and written so that model files with
categorical splits load and predict; the port does not train them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..binning import BinMapper, MISSING_NAN, MISSING_NONE, MISSING_ZERO

_MISSING_TYPE_MASK = {MISSING_NONE: 0, MISSING_ZERO: 4, MISSING_NAN: 8}


class Tree:
    """One decision tree, host-side numpy arrays (reference: tree.h:25)."""

    def __init__(self, num_leaves: int, split_feature, threshold_bin,
                 default_left, left_child, right_child, split_gain,
                 leaf_value, leaf_weight, leaf_count, internal_value,
                 internal_weight, internal_count,
                 threshold_real=None, missing_type=None, shrinkage: float = 1.0,
                 is_cat_node=None,
                 cat_sets: Optional[List[np.ndarray]] = None):
        self.num_leaves = int(num_leaves)
        n_int = max(self.num_leaves - 1, 0)
        self.split_feature = np.asarray(split_feature[:n_int], dtype=np.int32)
        self.threshold_bin = np.asarray(threshold_bin[:n_int], dtype=np.int32)
        self.default_left = np.asarray(default_left[:n_int], dtype=bool)
        self.left_child = np.asarray(left_child[:n_int], dtype=np.int32)
        self.right_child = np.asarray(right_child[:n_int], dtype=np.int32)
        self.split_gain = np.asarray(split_gain[:n_int], dtype=np.float64)
        self.leaf_value = np.asarray(leaf_value[:self.num_leaves],
                                     dtype=np.float64)
        self.leaf_weight = np.asarray(leaf_weight[:self.num_leaves],
                                      dtype=np.float64)
        self.leaf_count = np.asarray(leaf_count[:self.num_leaves],
                                     dtype=np.int64)
        self.internal_value = np.asarray(internal_value[:n_int],
                                         dtype=np.float64)
        self.internal_weight = np.asarray(internal_weight[:n_int],
                                          dtype=np.float64)
        self.internal_count = np.asarray(internal_count[:n_int],
                                         dtype=np.int64)
        self.threshold_real = (np.asarray(threshold_real[:n_int],
                                          dtype=np.float64)
                               if threshold_real is not None
                               else np.zeros(n_int))
        self.missing_type = (np.asarray(missing_type[:n_int], dtype=np.int32)
                             if missing_type is not None
                             else np.zeros(n_int, dtype=np.int32))
        self.shrinkage = shrinkage
        self.is_cat_node = (np.asarray(is_cat_node[:n_int], dtype=bool)
                            if is_cat_node is not None
                            else np.zeros(n_int, dtype=bool))
        self.cat_sets = (list(cat_sets) if cat_sets is not None
                         else [np.empty(0, dtype=np.int64)] * n_int)

    @staticmethod
    def from_device(arrays: Dict[str, np.ndarray], num_leaves: int,
                    mappers: Sequence[BinMapper],
                    feature_map: Optional[np.ndarray]) -> "Tree":
        """From host copies of a TreeArrays' fields; maps bin thresholds to
        real values (numerical nodes only on the ported path)."""
        nl = int(num_leaves)
        n_int = max(nl - 1, 0)
        sf = np.asarray(arrays["split_feature"])[:n_int]
        tb = np.asarray(arrays["threshold_bin"])[:n_int]
        thr_real = np.array([mappers[int(sf[i])].bin_to_value(int(tb[i]))
                             for i in range(n_int)], dtype=np.float64)
        mtypes = np.array([mappers[int(sf[i])].missing_type
                           for i in range(n_int)], dtype=np.int32)
        sf_orig = (np.asarray(feature_map)[sf] if feature_map is not None
                   else sf)
        return Tree(
            num_leaves=nl, split_feature=sf_orig, threshold_bin=tb,
            default_left=arrays["default_left"],
            left_child=arrays["left_child"], right_child=arrays["right_child"],
            split_gain=arrays["split_gain"], leaf_value=arrays["leaf_value"],
            leaf_weight=arrays["leaf_weight"], leaf_count=arrays["leaf_count"],
            internal_value=arrays["internal_value"],
            internal_weight=arrays["internal_weight"],
            internal_count=arrays["internal_count"],
            threshold_real=thr_real, missing_type=mtypes)

    # ---- serialization (reference: gbdt_model_text.cpp:271 per-tree blocks) ----
    def to_string(self, tree_idx: int) -> str:
        def arr(a, fmt="%g"):
            return " ".join(fmt % v for v in a)

        n_int = self.num_leaves - 1
        decision_type = np.zeros(max(n_int, 0), dtype=np.int32)
        thr_out = self.threshold_real.copy()
        cat_boundaries = [0]
        cat_words: List[int] = []
        cat_idx = 0
        for i in range(n_int):
            dt = 0  # bit0 categorical, bit1 default_left, bits2-3 missing type
            if self.is_cat_node[i]:
                dt |= 1
                thr_out[i] = cat_idx
                vals = self.cat_sets[i]
                n_words = (int(vals.max()) // 32 + 1) if len(vals) else 1
                words = [0] * n_words
                for v in vals:
                    words[int(v) // 32] |= 1 << (int(v) % 32)
                cat_words.extend(words)
                cat_boundaries.append(cat_boundaries[-1] + n_words)
                cat_idx += 1
            elif self.default_left[i]:
                dt |= 2
            dt |= _MISSING_TYPE_MASK.get(int(self.missing_type[i]), 0)
            decision_type[i] = dt
        lines = [f"Tree={tree_idx}",
                 f"num_leaves={self.num_leaves}",
                 f"num_cat={cat_idx}",
                 f"split_feature={arr(self.split_feature, '%d')}",
                 f"split_gain={arr(self.split_gain)}",
                 f"threshold={arr(thr_out, '%.17g')}",
                 f"decision_type={arr(decision_type, '%d')}",
                 f"left_child={arr(self.left_child, '%d')}",
                 f"right_child={arr(self.right_child, '%d')}",
                 f"leaf_value={arr(self.leaf_value, '%.17g')}",
                 f"leaf_weight={arr(self.leaf_weight, '%.17g')}",
                 f"leaf_count={arr(self.leaf_count, '%d')}",
                 f"internal_value={arr(self.internal_value, '%.17g')}",
                 f"internal_weight={arr(self.internal_weight, '%g')}",
                 f"internal_count={arr(self.internal_count, '%d')}",
                 f"shrinkage={self.shrinkage:g}",
                 "", ""]
        if cat_idx > 0:
            pos = next(i for i, ln in enumerate(lines)
                       if ln.startswith("shrinkage="))
            lines[pos:pos] = [f"cat_boundaries={arr(cat_boundaries, '%d')}",
                              f"cat_threshold={arr(cat_words, '%d')}"]
        return "\n".join(lines)

    @staticmethod
    def from_string(block: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in block.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        nl = int(kv["num_leaves"])
        n_int = max(nl - 1, 0)

        def arr(key, dtype, size):
            s = kv.get(key, "")
            if not s:
                return np.zeros(size, dtype=dtype)
            return np.array(s.split(" "), dtype=dtype)

        dt = arr("decision_type", np.int32, n_int)
        mt = np.where((dt & 12) == 8, MISSING_NAN,
                      np.where((dt & 12) == 4, MISSING_ZERO, MISSING_NONE))
        is_cat = (dt & 1) > 0
        thr = arr("threshold", np.float64, n_int)
        cat_sets: List[np.ndarray] = [np.empty(0, dtype=np.int64)] * n_int
        num_cat = int(kv.get("num_cat", 0))
        if num_cat > 0:
            bounds = arr("cat_boundaries", np.int64, num_cat + 1)
            words = arr("cat_threshold", np.uint64,
                        int(bounds[-1])).astype(np.uint32)
            for i in np.nonzero(is_cat)[0]:
                ci = int(thr[i])
                vals = []
                for w_i in range(int(bounds[ci]), int(bounds[ci + 1])):
                    w = int(words[w_i])
                    base = (w_i - int(bounds[ci])) * 32
                    vals.extend(base + bit for bit in range(32)
                                if w & (1 << bit))
                cat_sets[i] = np.asarray(vals, dtype=np.int64)
        return Tree(
            num_leaves=nl,
            split_feature=arr("split_feature", np.int32, n_int),
            threshold_bin=np.zeros(n_int, dtype=np.int32),
            default_left=(dt & 2) > 0,
            left_child=arr("left_child", np.int32, n_int),
            right_child=arr("right_child", np.int32, n_int),
            split_gain=arr("split_gain", np.float64, n_int),
            leaf_value=arr("leaf_value", np.float64, nl),
            leaf_weight=arr("leaf_weight", np.float64, nl),
            leaf_count=arr("leaf_count", np.int64, nl),
            internal_value=arr("internal_value", np.float64, n_int),
            internal_weight=arr("internal_weight", np.float64, n_int),
            internal_count=arr("internal_count", np.int64, n_int),
            threshold_real=thr, missing_type=mt,
            shrinkage=float(kv.get("shrinkage", 1.0)),
            is_cat_node=is_cat, cat_sets=cat_sets)
