"""Tree-growing parameters, the flat device-side tree layout and the
leaf-wise (lossguide) grower.

Port of ``GrowParams`` (:32), ``TreeArrays`` (:129), ``_empty_tree``
(:173) and the serial, unpooled path of ``grow_tree`` (:195) of
``lightgbm_tpu/ops/grow.py``, numerical and categorical splits. Internal
node ``i`` is created by split ``i``; child pointers use the reference
encoding: >= 0 an internal node, < 0 ``~leaf``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import threefry
from . import hist_kernels as K
from . import histogram as H
from .scan import tree_sum
from .split import (NEG_INF, BundleArrays, SplitParams, SplitResult,
                    best_split, leaf_output)


@dataclass(frozen=True)
class GrowParams:
    num_leaves: int = 31
    max_depth: int = -1
    max_bin: int = 255            # padded bin axis length B
    split: SplitParams = field(default_factory=SplitParams)
    # int8 quantized-gradient histograms (depthwise grower only): leaf
    # values are renewed from exact sums; off, the histograms sum the f32
    # rows and the leaf values come from the split records
    quant: bool = False
    # constant-hessian channel elision (h = h_const * bag01): the level
    # passes carry (g, count) only and rebuild h = count * scale_h / 127
    const_hess: bool = False
    # fused_grad_spec of the objective: ("l2",) or
    # ("logloss", sigmoid, lw_pos, lw_neg)
    fused_obj: Optional[tuple] = None
    # feature_fraction_bynode: the share of usable features each node
    # searches (node_feature_mask)
    ff_bynode: float = 1.0


class TreeArrays(NamedTuple):
    """Flat-array tree on the device (reference analog: Tree, tree.h:25)."""
    split_feature: torch.Tensor   # [L-1] i32
    threshold_bin: torch.Tensor   # [L-1] i32
    default_left: torch.Tensor    # [L-1] bool
    left_child: torch.Tensor      # [L-1] i32
    right_child: torch.Tensor     # [L-1] i32
    split_gain: torch.Tensor      # [L-1] f32
    leaf_value: torch.Tensor      # [L] f32
    leaf_weight: torch.Tensor     # [L] f32 (sum_hess)
    leaf_count: torch.Tensor      # [L] f32
    internal_value: torch.Tensor  # [L-1] f32
    internal_weight: torch.Tensor  # [L-1] f32
    internal_count: torch.Tensor  # [L-1] f32
    is_cat: torch.Tensor          # [L-1] bool: categorical subset split
    cat_mask: torch.Tensor        # [L-1, B] bool: bins routed left (is_cat)
    num_leaves: int


def empty_tree(L: int, B: int, device: torch.device) -> TreeArrays:
    m = max(L - 1, 1)

    def zi():
        return torch.zeros(m, dtype=torch.int32, device=device)

    def zf(k):
        return torch.zeros(k, dtype=torch.float32, device=device)

    return TreeArrays(
        split_feature=zi(), threshold_bin=zi(),
        default_left=torch.zeros(m, dtype=torch.bool, device=device),
        left_child=zi(), right_child=zi(), split_gain=zf(m),
        leaf_value=zf(L), leaf_weight=zf(L), leaf_count=zf(L),
        internal_value=zf(m), internal_weight=zf(m), internal_count=zf(m),
        is_cat=torch.zeros(m, dtype=torch.bool, device=device),
        cat_mask=torch.zeros((m, B), dtype=torch.bool, device=device),
        num_leaves=1)


def node_feature_mask(base_mask: torch.Tensor, gp: GrowParams,
                      qseed: Optional[int], tag: int) -> torch.Tensor:
    """feature_fraction_bynode (reference: ``_node_mask``, grow.py:220-234,
    and the depthwise level's draw, grow_depthwise.py:350-367): each node
    (a row of base_mask) keeps a usable feature when its uniform, keyed on
    fold_in(PRNGKey(qseed), tag), is below ff_bynode, and always keeps its
    best-u usable feature, so no node searches nothing. base_mask [F] or
    [nodes, F] bool."""
    if gp.ff_bynode >= 1.0:
        return base_mask
    key = threefry.fold_in(threefry.prng_key(qseed or 0), tag)
    u = threefry.uniform(key, tuple(base_mask.shape), base_mask.device)
    u_allowed = torch.where(base_mask, u, torch.full_like(u, -1.0))
    best = u_allowed >= u_allowed.max(dim=-1, keepdim=True).values
    # the reference compares f32 uniforms with the f32 fraction
    return base_mask & ((u < float(np.float32(gp.ff_bynode))) | best)


def grow_tree(bins_T: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor, num_bins: torch.Tensor, na_bin: torch.Tensor,
              feature_mask: torch.Tensor, gp: GrowParams,
              bins: Optional[torch.Tensor] = None,
              qseed: Optional[int] = None,
              bundle: Optional[BundleArrays] = None
              ) -> Tuple[TreeArrays, torch.Tensor, int]:
    """Grow one tree leaf-wise (best-first), unquantized.

    bins_T [F, N] u8 on the device; g/h/c [N] f32 grad/hess/in-bag count
    rows (already masked by the bag); num_bins / na_bin [F] i32 (na_bin >=
    B means no missing bin); feature_mask [F] bool; bins the row-major
    [N, F] copy of bins_T, which the split passes' slot histogram needs on
    the card; ``bundle`` the EFB arrays when ``gp.split.has_bundles``.
    Returns (TreeArrays, leaf_id [N] i32, number of split passes).

    Each split step t takes the leaf with the best gain (the first on
    ties, as ``jnp.argmax``), partitions its rows with a vectorized
    ``where`` on the leaf ids (by threshold, or by membership for a
    categorical or bundle split), builds the smaller child's histogram
    with one ``hist_f32`` pass over a slot vector (the smaller child's
    rows in slot 0, every other row dropped: the reference's masked
    full-width pass) and the sibling's by subtraction from the parent,
    then searches both children's best splits at once. Node t is created by step t and its right child is
    leaf t + 1. The reference runs the L - 1 steps in one ``lax.scan``;
    here the step loop runs on the host and reads the chosen leaf and its
    "can split" flag once a step, the one host sync of
    a step."""
    f, n = bins_T.shape
    dev = bins_T.device
    L, B = gp.num_leaves, gp.max_bin
    sp = gp.split
    hist0 = H.hist_leaf(bins_T, B, rows=(g, h, c))
    g0, h0, c0 = tree_sum(hist0[0, 0]), tree_sum(hist0[1, 0]), \
        tree_sum(hist0[2, 0])
    ones = torch.ones(2, dtype=torch.bool, device=dev)
    best0 = best_split(hist0[None], num_bins, na_bin, g0[None], h0[None],
                       c0[None], node_feature_mask(feature_mask, gp, qseed, L),
                       sp, ones[:1], bundle)

    def tile(x: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((L,), fill, dtype=x.dtype, device=dev)
        out[0] = x[0]
        return out

    member0 = torch.zeros((L, B), dtype=torch.bool, device=dev)
    member0[0] = best0.cat_member[0]
    best = SplitResult(
        gain=tile(best0.gain, NEG_INF), feature=tile(best0.feature, 0),
        bin=tile(best0.bin, 0), default_left=tile(best0.default_left, False),
        left_g=tile(best0.left_g, 0.0), left_h=tile(best0.left_h, 0.0),
        left_cnt=tile(best0.left_cnt, 0.0),
        is_cat=tile(best0.is_cat, False), cat_member=member0)
    hist = torch.zeros((L, 3, f, B), dtype=torch.float32, device=dev)
    hist[0] = hist0
    leaf_g, leaf_h, leaf_c = (torch.zeros(L, dtype=torch.float32, device=dev)
                              for _ in range(3))
    leaf_g[0], leaf_h[0], leaf_c[0] = g0, h0, c0
    tree = empty_tree(L, B, dev)
    leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
    # host-side bookkeeping: every entry follows from the chosen leaves
    depth = [0] * L
    parent_node = [-1] * L
    parent_right = [False] * L
    num_leaves = 1

    for t in range(L - 1):
        lt = torch.argmax(best.gain)
        ok = best.gain[lt] > NEG_INF / 2
        l, can_split = torch.stack([lt, ok.to(lt.dtype)]).tolist()
        if not can_split:
            break
        new_leaf = t + 1
        feat = best.feature[l]

        # ---- partition rows (DataPartition::Split: a where on leaf_id) ----
        col = bins_T.index_select(0, feat.view(1))[0].to(torch.int32)
        is_na = col == na_bin.index_select(0, feat.view(1))
        go_right = torch.where(is_na, ~best.default_left[l],
                               col > best.bin[l])
        if sp.cat_features or sp.has_bundles:
            # a categorical or bundle split sends its member bins left
            # (reference: grow.py:355-358)
            go_right = torch.where(best.is_cat[l],
                                   ~best.cat_member[l][col.long()], go_right)
        leaf_id = torch.where((leaf_id == l) & go_right, new_leaf, leaf_id)

        # ---- child stats ----
        lg, lh, lc = best.left_g[l], best.left_h[l], best.left_cnt[l]
        pg, ph, pc = leaf_g[l], leaf_h[l], leaf_c[l]
        rg, rh, rc = pg - lg, ph - lh, pc - lc

        # ---- smaller-child histogram + sibling by subtraction ----
        small_is_left = lc <= rc
        small_leaf = torch.where(small_is_left, l, new_leaf)
        slot = (leaf_id != small_leaf).to(torch.int32)   # 1: dropped
        hist_small = K.hist_f32(bins_T, g, h, c, slot, 1, B, bins)[0]
        hist_large = hist[l] - hist_small
        hist_left = torch.where(small_is_left, hist_small, hist_large)
        hist_right = torch.where(small_is_left, hist_large, hist_small)
        hist[l] = hist_left
        hist[new_leaf] = hist_right

        # ---- tree arrays (node t) ----
        par = parent_node[l]
        if par >= 0:
            (tree.right_child if parent_right[l] else tree.left_child)[par] = t
        tree.left_child[t] = ~l
        tree.right_child[t] = ~new_leaf
        tree.split_feature[t] = feat
        tree.threshold_bin[t] = best.bin[l]
        tree.default_left[t] = best.default_left[l]
        tree.split_gain[t] = best.gain[l]
        tree.is_cat[t] = best.is_cat[l]
        tree.cat_mask[t] = best.cat_member[l]
        # (pg, ph, pc are views of the leaf stats rewritten below)
        tree.internal_value[t] = leaf_output(pg, ph, sp)
        tree.internal_weight[t] = ph
        tree.internal_count[t] = pc
        for arr, left, right in ((tree.leaf_value, leaf_output(lg, lh, sp),
                                  leaf_output(rg, rh, sp)),
                                 (tree.leaf_weight, lh, rh),
                                 (tree.leaf_count, lc, rc),
                                 (leaf_g, lg, rg), (leaf_h, lh, rh),
                                 (leaf_c, lc, rc)):
            arr[l] = left
            arr[new_leaf] = right

        # ---- best splits of the two children (batched) ----
        d = depth[l] + 1
        allow = ones if gp.max_depth <= 0 or d < gp.max_depth else ~ones
        ch_mask = node_feature_mask(feature_mask.expand(2, f), gp, qseed, t)
        bs = best_split(torch.stack([hist_left, hist_right]), num_bins,
                        na_bin, torch.stack([lg, rg]), torch.stack([lh, rh]),
                        torch.stack([lc, rc]), ch_mask, sp, allow, bundle)
        for arr, vals in zip(best, bs):
            arr[l] = vals[0]
            arr[new_leaf] = vals[1]
        depth[l] = depth[new_leaf] = d
        parent_node[l] = parent_node[new_leaf] = t
        parent_right[l], parent_right[new_leaf] = False, True
        num_leaves += 1

    if num_leaves == 1:
        # single-leaf tree: constant output
        tree.leaf_value[0] = leaf_output(g0, h0, sp)
        tree.leaf_weight[0] = h0
        tree.leaf_count[0] = c0
    return tree._replace(num_leaves=num_leaves), leaf_id, num_leaves - 1
