"""Prediction: route rows through trees, as plain PyTorch.

Port of ``lightgbm_tpu/ops/predict.py``: ``route_bins`` walks binned rows
through a device tree (valid-set score updates during training, DART's
drops, the replay of a model on a Dataset), ``bin_tree`` puts a host
tree's real thresholds into a Dataset's bin space, and
``predict_raw`` / ``predict_leaf`` walk raw f64 feature rows through the
host trees of a model (``Booster.predict``), with the reference's
per-node missing handling (tree.h:240 NumericalDecision) and categorical
bitsets (tree.h:279 CategoricalDecision). Every row advances one level
per step; the walk stops when all rows sit on a leaf. No kernel of the TPU package is
involved, so none is ported here.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..models.tree import Tree
from ..obs.tracing import span
from .grow import TreeArrays


def route_bins(tree: TreeArrays, bins: torch.Tensor,
               na_bin: torch.Tensor, categorical: bool = False
               ) -> torch.Tensor:
    """Leaf index [N] i64 of each row of a binned matrix [N, F] u8; with
    ``categorical`` (data with a categorical feature or an EFB bundle), a
    node with is_cat set sends the bins of its cat_mask left."""
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
        if categorical:
            go_left = torch.where(tree.is_cat[node],
                                  tree.cat_mask[node, col], go_left)
        nxt = torch.where(go_left, lc[node], rc[node])
        ptr = torch.where(ptr >= 0, nxt, ptr)
        # the walk's one host read a level: stop once every row is on a leaf
        with span("sync.route"):
            done = not bool((ptr >= 0).any())
        if done:
            break
    return ~ptr


def bin_tree(t: Tree, mappers, feature_map, device: torch.device,
             bundle_meta=None) -> TreeArrays:
    """A host tree as device TreeArrays on a Dataset's bins (reference:
    engine._predict_via_trees, :354-387): each node's real threshold mapped
    to its bin by the node feature's mapper (a feature the Dataset does not
    use maps to used feature 0, as there), a categorical node's categories
    to the bins that hold them, f32 leaf values.

    With an EFB plan (``bundle_meta``) a node goes to its feature's column,
    and a numerical node on a bundled feature j at bin t becomes a
    membership node on j's bundle column (the inverse of
    ``Tree.from_device``): j's positions whose original bin is <= t go
    left, and every bin outside j's range (the rows where j is at its
    default) too when its default bin is <= t. The reference replays such
    a node by threshold on the bundle column (ROADMAP caveats)."""
    inv = ({int(orig): used for used, orig in enumerate(feature_map)}
           if feature_map is not None else None)
    n_int = max(t.num_leaves - 1, 1)
    sf = np.zeros(n_int, dtype=np.int32)
    tb = np.zeros(n_int, dtype=np.int32)
    is_cat = np.zeros(n_int, dtype=bool)
    is_cat[:t.num_leaves - 1] = t.is_cat_node
    column = {j: (j, 0) for j in range(len(mappers))}
    if bundle_meta is not None:
        column = {j: (c, off) for c, mem in enumerate(bundle_meta.members)
                  for j, off, _ in mem}
    width = (int(np.max(bundle_meta.num_bins)) if bundle_meta is not None
             else max((m.num_bins for m in mappers), default=1))
    cat_mask = np.zeros((n_int, width), dtype=bool)
    for i in range(t.num_leaves - 1):
        orig = int(t.split_feature[i])
        used = inv.get(orig, 0) if inv is not None else orig
        c, off = column[used]
        sf[i] = c
        m = mappers[used]
        if t.is_cat_node[i]:
            cat_mask[i, 1:m.num_bins] = np.isin(
                m.cat_values[:m.num_bins - 1], t.cat_sets[i])
            continue
        tb[i] = int(m.values_to_bins(np.array([t.threshold_real[i]]))[0])
        if bundle_meta is not None and bundle_meta.is_bundle[c]:
            db = int(bundle_meta.default_bin[used])
            ob = np.array([b for b in range(m.num_bins) if b != db])
            cat_mask[i] = db <= tb[i]
            cat_mask[i, off:off + len(ob)] = ob <= tb[i]
            is_cat[i] = True

    def dev(a, dtype, size=n_int):
        out = np.zeros(size, dtype=dtype)
        out[: len(a)] = a
        return torch.as_tensor(out, device=device)

    nl = t.num_leaves
    zf = dev([], np.float32)
    return TreeArrays(
        split_feature=dev(sf, np.int32), threshold_bin=dev(tb, np.int32),
        default_left=dev(t.default_left, bool),
        left_child=dev(t.left_child, np.int32),
        right_child=dev(t.right_child, np.int32), split_gain=zf,
        leaf_value=dev(t.leaf_value, np.float32, nl),
        leaf_weight=dev([], np.float32, nl),
        leaf_count=dev([], np.float32, nl),
        internal_value=zf, internal_weight=zf, internal_count=zf,
        is_cat=torch.as_tensor(is_cat, device=device),
        cat_mask=torch.as_tensor(cat_mask, device=device), num_leaves=nl)


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


def predict_raw(trees: Sequence[Tree], x: torch.Tensor,
                k: int = 1) -> torch.Tensor:
    """Raw scores f64: [N], the sum of every tree's leaf value, or with k
    trees an iteration [N, k], tree t adding to column t mod k."""
    out = torch.zeros((x.shape[0], k), dtype=torch.float64, device=x.device)
    for i, t in enumerate(trees):
        out[:, i % k] += torch.as_tensor(t.leaf_value, dtype=torch.float64,
                                         device=x.device)[route_raw(t, x)]
    return out[:, 0] if k == 1 else out


def predict_leaf(trees: Sequence[Tree], x: torch.Tensor) -> torch.Tensor:
    """Per-tree leaf indices [N, T] i64."""
    cols: List[torch.Tensor] = [route_raw(t, x) for t in trees]
    if not cols:
        return torch.zeros((x.shape[0], 0), dtype=torch.int64,
                           device=x.device)
    return torch.stack(cols, dim=1)
