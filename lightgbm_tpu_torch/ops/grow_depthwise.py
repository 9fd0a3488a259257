"""Depthwise (level-wise) tree growing: the serial path.

Port of ``lightgbm_tpu/ops/grow_depthwise.py`` ``grow_tree_depthwise``
(:238) for the serial path, quantized or not: the fused gradient +
quantization + root histogram front (:281-294) or the unfused one from
materialized rows (:295-308), the level function with budgeted top-gain
selection and sibling subtraction (:349-632), the level schedule (:167,
:634-657) and, under quantization, leaf renewal from exact sums
(:659-692).

Per tree the kernels run, on the fused quantized path (F * B <= 2048):
``grad_quant_hist0`` once, ``hist_routed_fused`` once per level that
selects at least one split, ``leaf_sums_grad`` once; on the unfused
quantized path: ``hist_q8`` once for the root, ``route_level`` and
``hist_q8`` once per such level, ``leaf_sums`` once; unquantized
(``gp.quant`` off): ``hist_f32`` once for the root, ``route_level`` and
``hist_f32`` once per such level, and no leaf renewal (the leaf values
are those of the split records, which the f32 histograms give).
The reference builds the whole tree inside one jitted program with
fixed-width masked scatters; here the level schedule is a Python loop that
reads the level's split count to the host once per level, and the level
pass is launched with exactly that many histogram slots (the reference's
wider padded slot axis only ever holds zeros past it). The schedule's slot
widths still bound the per-level selection exactly as in the reference.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from . import hist_kernels as K
from . import histogram as H
from .grow import GrowParams, TreeArrays, empty_tree
from .scan import tree_sum
from .split import NEG_INF, best_split, leaf_output

# the reference's master slot widths and slot floor on its kernel path
# (pallas_hist.MASTER_SLOT_WIDTHS, grow_depthwise._SLOT_FLOOR)
MASTER_SLOT_WIDTHS = (32, 128, 512)
SLOT_FLOOR = 32


def floor_slot_width(needed: int, max_slots: int) -> int:
    """Smallest master width >= needed, capped at max_slots."""
    for w in MASTER_SLOT_WIDTHS:
        if w >= needed:
            return min(w, max_slots)
    return max_slots


def level_widths(num_leaves: int, max_levels: int) -> List[int]:
    """Per-level selection cap (the reference's bucketed schedule)."""
    max_slots = max(1, num_leaves // 2)
    n_unroll = min(max_levels,
                   max(1, math.ceil(math.log2(max(num_leaves - 1, 2)))) + 1)
    widths = [floor_slot_width(max(min(2 ** k, max_slots), SLOT_FLOOR),
                               max_slots) for k in range(n_unroll)]
    return widths + [max_slots] * (max_levels - n_unroll)


def grow_tree_depthwise(bins_T: torch.Tensor, g: Optional[torch.Tensor],
                        h: Optional[torch.Tensor], c: Optional[torch.Tensor],
                        num_bins: torch.Tensor, na_bin: torch.Tensor,
                        feature_mask: torch.Tensor, gp: GrowParams, qseed: int,
                        fused: Optional[Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]] = None,
                        bins: Optional[torch.Tensor] = None
                        ) -> Tuple[TreeArrays, torch.Tensor, int]:
    """Grow one tree level-wise.

    bins_T [F, N] u8 on the device; g/h/c [N] f32 grad/hess/in-bag count
    rows (already masked by the bag); num_bins / na_bin [F] i32 (na_bin >= B
    means no missing bin); feature_mask [F] bool. ``qseed`` varies the
    stochastic-rounding dither (under gp.quant). ``fused``: (score, aux,
    bag) rows for the fused front, valid only with gp.quant and
    gp.fused_obj set; g/h/c are then unused (None) and the gradients are
    recomputed in the kernels. ``bins``: the row-major [N, F] copy of
    bins_T, which the level passes' slot histograms need on the card.
    Returns (TreeArrays, leaf_id [N] i32, number of level passes)."""
    f, n = bins_T.shape
    dev = bins_T.device
    L, B = gp.num_leaves, gp.max_bin
    sp = gp.split
    spec = gp.fused_obj
    max_levels = gp.max_depth if gp.max_depth > 0 else max(1, L - 1)

    rows = (g, h, c)
    if fused is not None:
        if spec is None or not gp.quant:
            raise ValueError("the fused front needs gp.quant and "
                             "gp.fused_obj")
        score, aux, bag = fused
        quant, hist0 = H.grad_quant_hist0(bins_T, score, aux, bag, qseed,
                                          spec, B, const_hess=gp.const_hess)
    elif gp.quant:
        # int8 quantized channels of the materialized rows, built once per
        # tree, then the root histogram
        quant = H.make_quant(g, h, c, qseed, const_hess=gp.const_hess)
        hist0 = H.hist_leaf(bins_T, B, quant)
    else:
        quant = None
        hist0 = H.hist_leaf(bins_T, B, rows=rows)
    g0, h0, c0 = tree_sum(hist0[0, 0]), tree_sum(hist0[1, 0]), \
        tree_sum(hist0[2, 0])

    f32 = dict(dtype=torch.float32, device=dev)
    hist = torch.zeros((L, 3, f, B), **f32)
    hist[0] = hist0
    leaf_g, leaf_h, leaf_c = (torch.zeros(L, **f32) for _ in range(3))
    leaf_g[0], leaf_h[0], leaf_c[0] = g0, h0, c0
    active = torch.zeros(L, dtype=torch.bool, device=dev)
    active[0] = True
    parent_node = torch.full((L,), -1, dtype=torch.int64, device=dev)
    parent_right = torch.zeros(L, dtype=torch.bool, device=dev)
    tree = empty_tree(L, dev)
    tree.leaf_value[0] = leaf_output(g0, h0, sp)
    tree.leaf_weight[0] = h0
    tree.leaf_count[0] = c0
    num_leaves = 1
    leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
    leaves_iota = torch.arange(L, device=dev)
    gain_gate = float(max(sp.min_gain_to_split, 0.0))
    passes = 0

    for slots in level_widths(L, max_levels):
        if num_leaves >= L:
            break
        res = best_split(hist, num_bins, na_bin, leaf_g, leaf_h, leaf_c,
                         feature_mask, sp, active)
        # budgeted selection: top-gain candidates win, ties by leaf index
        cand = active & (res.gain > gain_gate) & (res.gain > NEG_INF / 2)
        key = torch.where(cand, res.gain,
                          torch.full_like(res.gain, -math.inf))
        kj, ki = key[None, :], key[:, None]
        better = (kj > ki) | ((kj == ki)
                              & (leaves_iota[None, :] < leaves_iota[:, None]))
        rank = better.sum(dim=1)
        sel = cand & (rank < min(L - num_leaves, slots))
        si = sel.nonzero().squeeze(1)            # selected leaves, ascending
        num_sel = int(si.shape[0])
        if num_sel == 0:
            break
        idx_in_lvl = torch.cumsum(sel.to(torch.int64), 0) - 1
        node_id = num_leaves - 1 + idx_in_lvl
        new_leaf = num_leaves + idx_in_lvl
        lg, lh, lc = res.left_g, res.left_h, res.left_cnt
        rg, rh, rc = leaf_g - lg, leaf_h - lh, leaf_c - lc
        w_l = leaf_output(lg, lh, sp)
        w_r = leaf_output(rg, rh, sp)
        w_p = leaf_output(leaf_g, leaf_h, sp)

        # ---- tree arrays ----
        nid, nl = node_id[si], new_leaf[si]
        par = parent_node[si]
        has_par = par >= 0
        pr = parent_right[si]
        tree.left_child[par[has_par & ~pr]] = nid[has_par & ~pr].to(torch.int32)
        tree.right_child[par[has_par & pr]] = nid[has_par & pr].to(torch.int32)
        tree.split_feature[nid] = res.feature[si].to(torch.int32)
        tree.threshold_bin[nid] = res.bin[si].to(torch.int32)
        tree.default_left[nid] = res.default_left[si]
        tree.left_child[nid] = (~si).to(torch.int32)
        tree.right_child[nid] = (~nl).to(torch.int32)
        tree.split_gain[nid] = res.gain[si]
        tree.leaf_value[si] = w_l[si]
        tree.leaf_value[nl] = w_r[si]
        tree.leaf_weight[si] = lh[si]
        tree.leaf_weight[nl] = rh[si]
        tree.leaf_count[si] = lc[si]
        tree.leaf_count[nl] = rc[si]
        tree.internal_value[nid] = w_p[si]
        tree.internal_weight[nid] = (lh + rh)[si]
        tree.internal_count[nid] = (lc + rc)[si]

        # ---- route + smaller-child histogram pass: one slot per selected
        # leaf (in leaf order); the larger child is the parent minus the
        # smaller ----
        small_is_left = lc <= rc
        sentinel = torch.full_like(idx_in_lvl, num_sel)
        tables = H.RouteTables(
            feat=torch.where(sel, res.feature, torch.full_like(res.feature, -1)),
            thr=res.bin, dleft=res.default_left.to(torch.int32),
            new_leaf=new_leaf,
            slot_left=torch.where(sel & small_is_left, idx_in_lvl, sentinel),
            slot_right=torch.where(sel & ~small_is_left, idx_in_lvl, sentinel))
        hist_pass, leaf_id = H.hist_routed(bins_T, leaf_id, tables, na_bin,
                                           num_sel, B, quant, rows, bins)
        passes += 1
        parent_hist = hist[si]
        hist_sib = parent_hist - hist_pass
        sl = small_is_left[si][:, None, None, None]
        hist[si] = torch.where(sl, hist_pass, hist_sib)
        hist[nl] = torch.where(sl, hist_sib, hist_pass)

        # ---- per-leaf stats / frontier ----
        for arr, left, right in ((leaf_g, lg, rg), (leaf_h, lh, rh),
                                 (leaf_c, lc, rc)):
            arr[si] = left[si]
            arr[nl] = right[si]
        active = sel.clone()
        active[nl] = True
        parent_node[si] = nid
        parent_node[nl] = nid
        parent_right[si] = False
        parent_right[nl] = True
        num_leaves += num_sel

    if not gp.quant:
        return tree._replace(num_leaves=num_leaves), leaf_id, passes
    # ---- leaf renewal from exact sums (quantized-training: splits
    # tolerate int8 gains, leaf outputs use exact sums) ----
    if fused is not None:
        sums = K.leaf_sums_grad(score, aux, bag, leaf_id, spec, L)
    else:
        sums = K.leaf_sums(g, h, c, leaf_id, L)
    eg, eh, ec = sums[0], sums[1], sums[2]
    w = leaf_output(eg, eh, sp)
    live = leaves_iota < num_leaves
    tree = tree._replace(
        leaf_value=torch.where(live, w, tree.leaf_value),
        leaf_weight=torch.where(live, eh, tree.leaf_weight),
        leaf_count=torch.where(live, ec, tree.leaf_count),
        num_leaves=num_leaves)
    return tree, leaf_id, passes
