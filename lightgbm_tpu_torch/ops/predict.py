"""Prediction: route rows through trees, as plain PyTorch.

Port of ``lightgbm_tpu/ops/predict.py``: ``route_bins`` walks binned rows
through a device tree (valid-set score updates during training), and
``predict_raw`` / ``predict_leaf`` walk raw f64 feature rows through the
host trees of a model (``Booster.predict``), with the reference's
per-node missing handling (tree.h:240 NumericalDecision) and categorical
bitsets for loaded models. Every row advances one level per step; the
walk stops when all rows sit on a leaf. No kernel of the TPU package is
involved, so none is ported here.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..models.tree import Tree
from .grow import TreeArrays


def route_bins(tree: TreeArrays, bins: torch.Tensor,
               na_bin: torch.Tensor) -> torch.Tensor:
    """Leaf index [N] i64 of each row of a binned matrix [N, F] u8."""
    n = bins.shape[0]
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int64, device=bins.device)
    ptr = torch.zeros(n, dtype=torch.int64, device=bins.device)
    na = na_bin.to(torch.int64)
    sf = tree.split_feature.to(torch.int64)
    thr = tree.threshold_bin.to(torch.int64)
    lc = tree.left_child.to(torch.int64)
    rc = tree.right_child.to(torch.int64)
    for _ in range(tree.num_leaves - 1):
        node = ptr.clamp(min=0)
        feat = sf[node]
        col = bins.gather(1, feat[:, None])[:, 0].to(torch.int64)
        go_left = torch.where(col == na[feat], tree.default_left[node],
                              col <= thr[node])
        nxt = torch.where(go_left, lc[node], rc[node])
        ptr = torch.where(ptr >= 0, nxt, ptr)
        if not bool((ptr >= 0).any()):
            break
    return ~ptr


def _tree_tensors(t: Tree, device: torch.device):
    n_int = max(t.num_leaves - 1, 1)

    def pad(a, dtype):
        out = np.zeros(n_int, dtype=dtype)
        out[: len(a)] = a
        return torch.as_tensor(out, device=device)

    cat_w = 1 + max((int(s.max()) for s in t.cat_sets if len(s)), default=0)
    lut = np.zeros((n_int, cat_w), dtype=bool)
    for i in np.nonzero(t.is_cat_node)[0]:
        lut[i, t.cat_sets[i]] = True
    return dict(
        feat=pad(t.split_feature, np.int64), thr=pad(t.threshold_real,
                                                     np.float64),
        dleft=pad(t.default_left, bool), lc=pad(t.left_child, np.int64),
        rc=pad(t.right_child, np.int64), mt=pad(t.missing_type, np.int64),
        is_cat=pad(t.is_cat_node, bool),
        lut=torch.as_tensor(lut, device=device))


def route_raw(t: Tree, x: torch.Tensor) -> torch.Tensor:
    """Leaf index [N] i64 of each raw feature row x [N, F] f64."""
    n = x.shape[0]
    if t.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int64, device=x.device)
    tt = _tree_tensors(t, x.device)
    ptr = torch.zeros(n, dtype=torch.int64, device=x.device)
    cat_w = tt["lut"].shape[1]
    for _ in range(t.num_leaves - 1):
        node = ptr.clamp(min=0)
        v = x.gather(1, tt["feat"][node][:, None])[:, 0]
        mt = tt["mt"][node]
        isnan = torch.isnan(v)
        v0 = torch.where(isnan & (mt == MISSING_NONE), torch.zeros_like(v), v)
        is_missing = torch.where(
            mt == MISSING_NAN, isnan,
            (mt == MISSING_ZERO) & ((v0.abs() < 1e-35) | isnan))
        go_left = torch.where(is_missing, tt["dleft"][node],
                              v0 <= tt["thr"][node])
        iv = torch.where(isnan | (v < 0), torch.full_like(v, -1.0),
                         v.clamp(max=float(cat_w))).to(torch.int64)
        in_set = (iv >= 0) & (iv < cat_w) & \
            tt["lut"][node, iv.clamp(0, cat_w - 1)]
        go_left = torch.where(tt["is_cat"][node], in_set, go_left)
        nxt = torch.where(go_left, tt["lc"][node], tt["rc"][node])
        ptr = torch.where(ptr >= 0, nxt, ptr)
        if not bool((ptr >= 0).any()):
            break
    return ~ptr


def predict_raw(trees: Sequence[Tree], x: torch.Tensor) -> torch.Tensor:
    """Raw scores [N] f64: the sum of every tree's leaf value."""
    out = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    for t in trees:
        out += torch.as_tensor(t.leaf_value, dtype=torch.float64,
                               device=x.device)[route_raw(t, x)]
    return out


def predict_leaf(trees: Sequence[Tree], x: torch.Tensor) -> torch.Tensor:
    """Per-tree leaf indices [N, T] i64."""
    cols: List[torch.Tensor] = [route_raw(t, x) for t in trees]
    if not cols:
        return torch.zeros((x.shape[0], 0), dtype=torch.int64,
                           device=x.device)
    return torch.stack(cols, dim=1)
