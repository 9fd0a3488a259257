"""Host-side tree model.

Port of ``lightgbm_tpu/models/tree.py`` ``Tree`` (:22): the finalized
flat-array tree (trimmed to its real leaf count, bin thresholds mapped to
real-valued thresholds through the BinMappers) and its block of the
reference model-text format (gbdt_model_text.cpp:271, tree.cpp:209-246),
categorical nodes included: a trained categorical node's member bins
become its raw categories, written as LightGBM's ``cat_threshold``
bitsets; a node on an EFB bundle column becomes the numerical node on
its original feature, so a bundled model reads as if trained unbundled.
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
                    feature_map: Optional[np.ndarray],
                    bundle_meta=None) -> "Tree":
        """From host copies of a TreeArrays' fields (reference:
        tree.py:82-138): a numerical node's bin threshold becomes its real
        threshold; a categorical node's member bins become its sorted raw
        categories (bin b holds cat_values[b - 1]; bin 0 and bins past the
        categories are dropped) and its threshold 0 (the category index is
        written at serialization). With an EFB plan (``bundle_meta``) node
        features are bundle columns: a bundle-subset node at position p of
        column c becomes a numerical node on pos_feat[c, p] at bin
        pos_bin[c, p], and a node on a single column one on its
        feature."""
        nl = int(num_leaves)
        n_int = max(nl - 1, 0)
        sf = np.array(arrays["split_feature"][:n_int], dtype=np.int64)
        tb = np.array(arrays["threshold_bin"][:n_int], dtype=np.int32)
        is_cat = np.array(arrays["is_cat"][:n_int], dtype=bool)
        cat_mask = np.asarray(arrays["cat_mask"])
        if bundle_meta is not None:
            for i in range(n_int):
                c = int(sf[i])
                if bundle_meta.is_bundle[c] and is_cat[i]:
                    p = int(tb[i])
                    sf[i] = bundle_meta.pos_feat[c, p]
                    tb[i] = bundle_meta.pos_bin[c, p]
                    is_cat[i] = False
                else:
                    sf[i] = bundle_meta.members[c][0][0]
        thr_real = np.zeros(n_int, dtype=np.float64)
        cat_sets: List[np.ndarray] = []
        for i in range(n_int):
            m = mappers[int(sf[i])]
            if is_cat[i]:
                bins = np.nonzero(cat_mask[i])[0]
                bins = bins[(bins >= 1) & (bins <= len(m.cat_values))]
                cat_sets.append(np.sort(m.cat_values[bins - 1]).astype(
                    np.int64))
            else:
                cat_sets.append(np.empty(0, dtype=np.int64))
                thr_real[i] = m.bin_to_value(int(tb[i]))
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
            threshold_real=thr_real, missing_type=mtypes,
            is_cat_node=is_cat, cat_sets=cat_sets)

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

    @property
    def num_cat(self) -> int:
        return int(self.is_cat_node.sum())

    def to_json(self, tree_idx: int) -> Dict:
        """The tree as the nested dict of ``Booster.dump_model`` (reference:
        tree.py:336-377): a categorical node's threshold is its categories
        joined by "||" and its decision "==", a numerical node's its real
        threshold and "<="."""
        def node_json(ptr: int) -> Dict:
            if ptr < 0:
                leaf = ~ptr
                return {"leaf_index": int(leaf),
                        "leaf_value": float(self.leaf_value[leaf]),
                        "leaf_weight": float(self.leaf_weight[leaf]),
                        "leaf_count": int(self.leaf_count[leaf])}
            cat = bool(self.is_cat_node[ptr])
            return {
                "split_index": int(ptr),
                "split_feature": int(self.split_feature[ptr]),
                "split_gain": float(self.split_gain[ptr]),
                "threshold": ("||".join(str(int(v))
                                        for v in self.cat_sets[ptr]) if cat
                              else float(self.threshold_real[ptr])),
                "decision_type": "==" if cat else "<=",
                "default_left": False if cat
                else bool(self.default_left[ptr]),
                "missing_type": ["None", "Zero", "NaN"][
                    int(self.missing_type[ptr])],
                "internal_value": float(self.internal_value[ptr]),
                "internal_weight": float(self.internal_weight[ptr]),
                "internal_count": int(self.internal_count[ptr]),
                "left_child": node_json(int(self.left_child[ptr])),
                "right_child": node_json(int(self.right_child[ptr])),
            }
        root = 0 if self.num_leaves > 1 else ~0
        return {"tree_index": tree_idx, "num_leaves": self.num_leaves,
                "num_cat": self.num_cat, "shrinkage": self.shrinkage,
                "tree_structure": node_json(root)}

    def _cat_lookup(self, node: int) -> frozenset:
        """The categories a categorical node sends left."""
        lut = getattr(self, "_cat_lut", None)
        if lut is None:
            lut = self._cat_lut = {
                i: frozenset(int(v) for v in self.cat_sets[i])
                for i in np.nonzero(self.is_cat_node)[0]}
        return lut.get(node, frozenset())

    def to_if_else(self, index: int) -> str:
        """The tree as a C++ function of if-else branches (reference:
        Tree::ToIfElse, tree.h:200; tree.py:379-403)."""
        def rec(ptr: int, indent: str) -> str:
            if ptr < 0:
                return f"{indent}return {float(self.leaf_value[~ptr]):.17g};\n"
            f_ = int(self.split_feature[ptr])
            if self.is_cat_node[ptr]:
                vals = ", ".join(str(int(v)) for v in self.cat_sets[ptr])
                cond = f"IsCatLeft(arr[{f_}], {{{vals}}})"
            else:
                dl = "true" if self.default_left[ptr] else "false"
                cond = (f"IsLeft(arr[{f_}], "
                        f"{float(self.threshold_real[ptr]):.17g}, {dl})")
            return (f"{indent}if ({cond}) {{\n"
                    + rec(int(self.left_child[ptr]), indent + "  ")
                    + f"{indent}}} else {{\n"
                    + rec(int(self.right_child[ptr]), indent + "  ")
                    + f"{indent}}}\n")
        body = rec(0 if self.num_leaves > 1 else ~0, "  ")
        return f"double PredictTree{index}(const double* arr) {{\n{body}}}\n"

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


def ensemble_max_depth(stack: Dict[str, np.ndarray]) -> int:
    """Longest root->leaf DECISION count across stacked trees (host-side).

    The serving walk (serving.py) runs this many steps, every tree at once,
    with no host sync inside; num_leaves - 1 (254 at L=255) instead of the
    actual depth (~10 for depthwise trees) would run ~25x the steps.
    Children always carry larger node ids than their parents (both growers
    assign ids split- or level-ordered), so one forward pass over nodes
    computes exact depths. (Reference: models/tree.py:510.)"""
    lc = np.asarray(stack["left_child"])
    rc = np.asarray(stack["right_child"])
    nl = np.asarray(stack["num_leaves"])
    t_cnt, m = lc.shape
    if t_cnt == 0:
        return 1
    node_iota = np.arange(m)[None, :]
    if (((lc >= 0) & (lc <= node_iota)) | ((rc >= 0) & (rc <= node_iota))).any():
        # non-monotone node ordering (foreign model file): conservative bound
        return int(max(1, nl.max() - 1))
    depth = np.zeros((t_cnt, m), dtype=np.int32)
    depth[:, 0] = (nl > 1).astype(np.int32)
    best = depth[:, 0].copy()
    rows = np.arange(t_cnt)
    for t in range(m):
        d = depth[:, t]
        active = d > 0
        if not active.any():
            continue
        best = np.maximum(best, d)
        for ch in (lc[:, t], rc[:, t]):
            valid = active & (ch > t) & (ch < m)
            idx = np.where(valid, ch, 0)
            nd = np.where(valid, d + 1, 0)
            np.maximum.at(depth, (rows, idx), nd)
    return int(max(1, best.max()))
