"""SHAP feature contributions (TreeSHAP).

Port of ``lightgbm_tpu/io/shap.py``, copied as it stands (reference
analog: PredictContrib, boosting.h:167, the exact TreeSHAP algorithm over
each tree's coverage counts): the polynomial-time EXPVALUE recursion
(Lundberg et al.) on the host in numpy, one row and one tree at a time.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..models.tree import Tree


def _tree_shap_single(tree: Tree, x: np.ndarray, phi: np.ndarray) -> None:
    """Exact TreeSHAP for one tree and one row; accumulates into phi [F+1]."""
    if tree.num_leaves <= 1:
        phi[-1] += tree.leaf_value[0]
        return

    lc, rc = tree.left_child, tree.right_child
    counts = tree.internal_count.astype(np.float64)
    leaf_counts = tree.leaf_count.astype(np.float64)

    def node_count(ptr):
        return leaf_counts[~ptr] if ptr < 0 else counts[ptr]

    def node_value(ptr):
        """Expected value of subtree."""
        if ptr < 0:
            return tree.leaf_value[~ptr]
        return tree.internal_value[ptr]

    # PATH is a list of (feature, zero_fraction, one_fraction, pweight)
    def extend(path, pzf, pof, pfi):
        # rows must be DEEP-copied: the hot-branch recursion would otherwise
        # mutate pweights aliased into the caller's path before the cold branch
        # reads them (matches shap's extendPath on a copied buffer)
        path = [row[:] for row in path] + [[pfi, pzf, pof,
                                            1.0 if len(path) == 0 else 0.0]]
        l = len(path) - 1
        for i in range(l - 1, -1, -1):
            path[i + 1][3] += pof * path[i][3] * (i + 1) / (l + 1)
            path[i][3] = pzf * path[i][3] * (l - i) / (l + 1)
        return path

    def unwind(path, i):
        # remove element i: pweights are recomputed IN PLACE for positions
        # 0..l-1 while (feature, zero_fraction, one_fraction) shift down from
        # i+1 — shifting pweights too (e.g. `del path[i]`) corrupts the
        # distribution (matches shap's unwindPath, tree_shap.h)
        l = len(path) - 1
        one_fraction = path[i][2]
        zero_fraction = path[i][1]
        n = path[l][3]
        path = [row[:] for row in path]
        for j in range(l - 1, -1, -1):
            if one_fraction != 0.0:
                t = path[j][3]
                path[j][3] = n * (l + 1) / ((j + 1) * one_fraction)
                n = t - path[j][3] * zero_fraction * (l - j) / (l + 1)
            else:
                path[j][3] = path[j][3] * (l + 1) / (zero_fraction * (l - j))
        for j in range(i, l):
            path[j][0] = path[j + 1][0]
            path[j][1] = path[j + 1][1]
            path[j][2] = path[j + 1][2]
        path.pop()
        return path

    def unwound_sum(path, i):
        l = len(path) - 1
        one_fraction = path[i][2]
        zero_fraction = path[i][1]
        total = 0.0
        n = path[l][3]
        for j in range(l - 1, -1, -1):
            if one_fraction != 0.0:
                t = n * (l + 1) / ((j + 1) * one_fraction)
                total += t
                n = path[j][3] - t * zero_fraction * (l - j) / (l + 1)
            else:
                total += path[j][3] / (zero_fraction * (l - j) / (l + 1))
        return total

    def recurse(ptr, path, pzf, pof, pfi):
        path = extend(path, pzf, pof, pfi)
        if ptr < 0:
            for i in range(1, len(path)):
                w = unwound_sum(path, i)
                row = path[i]
                phi[row[0]] += w * (row[2] - row[1]) * tree.leaf_value[~ptr]
            return
        feat = int(tree.split_feature[ptr])
        v = x[feat]
        if tree.is_cat_node[ptr]:
            # categorical node: left = membership in the cat set (the numeric
            # threshold is meaningless here — Tree.predict_raw routing)
            go_left = (not np.isnan(v) and v >= 0
                       and int(v) in tree._cat_lookup(ptr))
        else:
            thr = tree.threshold_real[ptr]
            mt = tree.missing_type[ptr]
            isnan = np.isnan(v)
            if mt == 0 and isnan:
                v, isnan = 0.0, False
            if mt == 2:
                miss = isnan
            elif mt == 1:
                miss = isnan or abs(v) < 1e-35
            else:
                miss = False
            go_left = tree.default_left[ptr] if miss \
                else (False if isnan else v <= thr)
        hot = lc[ptr] if go_left else rc[ptr]
        cold = rc[ptr] if go_left else lc[ptr]
        pc = node_count(ptr)
        hzf = node_count(hot) / pc if pc > 0 else 0.0
        czf = node_count(cold) / pc if pc > 0 else 0.0
        # if this feature already on path, undo it
        path_idx = next((i for i in range(1, len(path)) if path[i][0] == feat), -1)
        izf, iof = 1.0, 1.0
        if path_idx >= 0:
            izf, iof = path[path_idx][1], path[path_idx][2]
            path = unwind(path, path_idx)
        recurse(hot, path, hzf * izf, iof, feat)
        recurse(cold, path, czf * izf, 0.0, feat)

    # base value: coverage-weighted expectation of the tree output (reference:
    # Tree::ExpectedValue = sum(leaf_count*leaf_value)/count, tree.h — NOT the
    # root's regularized output, which diverges under lambda_l2/leaf renewal)
    nl = tree.num_leaves
    cnt = leaf_counts[:nl]
    tot = cnt.sum()
    phi[-1] += (float(np.dot(cnt, tree.leaf_value[:nl])) / tot
                if tot > 0 else tree.leaf_value[0])
    recurse(0, [], 1.0, 1.0, -1)


def tree_shap_ensemble(x: np.ndarray, trees: List[Tree], num_class: int,
                       base_score: np.ndarray) -> np.ndarray:
    """x: [N, F] -> contributions [N, (F+1)] or [N, num_class*(F+1)]."""
    n, f = x.shape
    if num_class <= 1:
        out = np.zeros((n, f + 1))
        for i in range(n):
            phi = np.zeros(f + 1)
            for t in trees:
                _tree_shap_single(t, x[i], phi)
            out[i] = phi
        return out
    out = np.zeros((n, num_class * (f + 1)))
    for i in range(n):
        for cls in range(num_class):
            phi = np.zeros(f + 1)
            for ti in range(cls, len(trees), num_class):
                _tree_shap_single(trees[ti], x[i], phi)
            out[i, cls * (f + 1): (cls + 1) * (f + 1)] = phi
    return out
