"""Depthwise (level-wise) tree growing.

Port of ``lightgbm_tpu/ops/grow_depthwise.py`` ``grow_tree_depthwise``
(:238), serial or over row shards (``ShardedRows``: the data-parallel and
voting learners) or feature tiles (the feature-parallel learner),
quantized or not: the fused gradient +
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
are those of the split records, which the f32 histograms give). A level
with a categorical or an EFB bundle split hands the routing each leaf's
membership bitset (one more host read of the level, only with categorical
features or bundles).
The split constraints (A12c) ride on the level function: per-leaf
monotone output bounds clamp the split records' outputs (:464-472) and
the renewed leaves (:685-686) and propagate to the children
(``grow.monotone_child_bounds``, :143-163); the CEGB penalty plane is
recomputed each level from the ``CEGBState`` bookkeeping (:369-390),
which the selected splits update (:478-490); extra_trees draws its
thresholds from ``fold_in(fold_in(PRNGKey(extra_seed), qseed), level)``
(:392-400, ``grow.extra_trees_key``); ``grow.ForcedSplits`` override the
search at the leaves that hold a forced-node pointer, with left stats
from the leaf histogram's prefix sums, the missing bin excluded
(:406-428), and the pointers move to the children (:613-622).
The reference builds the whole tree inside one jitted program with
fixed-width masked scatters; here the level schedule is a Python loop that
reads the level's split count to the host once per level, and the level
pass is launched with exactly that many histogram slots (the reference's
wider padded slot axis only ever holds zeros past it). The schedule's slot
widths still bound the per-level selection exactly as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch

from . import hist_kernels as K
from . import histogram as H
from .grow import (ForcedSplits, GrowParams, ShardedRows, TreeArrays,
                   _hist_allreduce, _psum, as_sharded, empty_tree,
                   extra_trees_key, forced_override, monotone_child_bounds,
                   node_feature_mask)
from .scan import tree_sum
from .split import (NEG_INF, BundleArrays, SplitParams, SplitResult,
                    best_split, leaf_output, per_feature_gains)

# the reference's master slot widths and slot floor on its kernel path
# (pallas_hist.MASTER_SLOT_WIDTHS, grow_depthwise._SLOT_FLOOR)
MASTER_SLOT_WIDTHS = (32, 128, 512)
SLOT_FLOOR = 32


@dataclass
class CEGBState:
    """CEGB bookkeeping that lives across trees (reference: CEGBState,
    grow_depthwise.py:52-62), in the grower's column space: whether each
    column was ever split on (the coupled penalty's), which (row, column)
    pairs paid the lazy penalty already (``data_used`` [N, F], None when
    the lazy penalty is off), the two penalty vectors and the columns
    whose lazy penalty is not 0. The grower updates the first two in
    place."""
    feature_used: torch.Tensor   # [F] bool
    data_used: Optional[torch.Tensor]
    coupled_pen: torch.Tensor    # [F] f32 (zeros when off)
    lazy_pen: torch.Tensor       # [F] f32 (zeros when off)
    lazy_cols: Optional[torch.Tensor] = None   # [K] i64


def cegb_penalty(sp: SplitParams, cegb: CEGBState, leaf_c: torch.Tensor,
                 sh: ShardedRows, leaf_ids: list,
                 gp: GrowParams) -> torch.Tensor:
    """The CEGB penalty plane [L, F] of a frontier (reference:
    grow_depthwise.py:369-390): tradeoff * (penalty_split * the leaf's
    rows + the coupled penalty of a column never split on + the lazy
    penalty of each in-bag row of the leaf that has not paid for the
    column yet). The lazy sums run over the columns of a nonzero lazy
    penalty only: every other column's sum is of zeros; each shard sums
    its own rows against its block of the bitset, and the shards' sums
    are summed."""
    L, f = leaf_c.shape[0], cegb.feature_used.shape[0]
    pen = (torch.tensor(sp.cegb_tradeoff * sp.cegb_penalty_split,
                        dtype=torch.float32, device=leaf_c.device)
           * leaf_c[:, None]).expand(L, f)
    zero = torch.zeros((), dtype=torch.float32, device=leaf_c.device)
    if sp.cegb_coupled:
        pen = pen + sp.cegb_tradeoff * torch.where(
            cegb.feature_used, zero, cegb.coupled_pen)[None, :]
    if sp.cegb_lazy:
        parts = []
        for s, lid in zip(sh.shards, leaf_ids):
            d = s.device
            cols = cegb.lazy_cols.to(d)
            fresh = torch.where(s.data_used[:, cols], zero.to(d),
                                cegb.lazy_pen.to(d)[cols][None, :])
            fresh = fresh * (s.c > 0)[:, None]
            sums = torch.zeros((L, cols.numel()), dtype=torch.float32,
                               device=d)
            sums.index_add_(0, lid.to(torch.int64), fresh)
            parts.append(sums)
        lazy_cost = torch.zeros((L, f), dtype=torch.float32,
                                device=leaf_c.device)
        lazy_cost[:, cegb.lazy_cols] = _psum(parts, gp)
        pen = pen + sp.cegb_tradeoff * lazy_cost
    return pen


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


def apply_level_to_tree(tree: TreeArrays, parent_node: torch.Tensor,
                        parent_right: torch.Tensor, res: SplitResult,
                        si: torch.Tensor, nid: torch.Tensor, nl: torch.Tensor,
                        left, right, outputs, sp: SplitParams) -> None:
    """Write one level's selected splits into the tree arrays, in place
    (reference: ``_apply_level_to_tree``, grow_depthwise.py:103-141): the
    selected leaves ``si`` (ascending) become nodes ``nid`` whose right
    children are the new leaves ``nl``; each parent's child pointer moves
    to its node; ``left`` / ``right`` the (g, h, count) stats and
    ``outputs`` the (left, right, parent) outputs of every leaf [L]."""
    (lg, lh, lc), (rg, rh, rc), (w_l, w_r, w_p) = left, right, outputs
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
    if sp.cat_features or sp.has_bundles:
        tree.is_cat[nid] = res.is_cat[si]
        tree.cat_mask[nid] = res.cat_member[si]


def split_outputs(res: SplitResult, leaf_g, leaf_h, leaf_c, leaf_min,
                  leaf_max, sp: SplitParams):
    """Every leaf's split as ((left g, h, count), (right g, h, count),
    (left, right, parent output)), the outputs clamped to the leaf's
    monotone bounds under monotone constraints."""
    lg, lh, lc = res.left_g, res.left_h, res.left_cnt
    rg, rh, rc = leaf_g - lg, leaf_h - lh, leaf_c - lc
    w = [leaf_output(lg, lh, sp), leaf_output(rg, rh, sp),
         leaf_output(leaf_g, leaf_h, sp)]
    if sp.has_monotone:
        w = [torch.clamp(x, leaf_min, leaf_max) for x in w]
    return (lg, lh, lc), (rg, rh, rc), tuple(w)


def _membership_leaves(res: SplitResult, sel: torch.Tensor,
                       sp: SplitParams) -> Optional[torch.Tensor]:
    """The selected leaves whose split routes by membership (categorical
    or bundle), or None on a level without one (a host read, only with
    categorical features or bundles)."""
    if not (sp.cat_features or sp.has_bundles):
        return None
    cat_sel = res.is_cat & sel
    return cat_sel if bool(cat_sel.any()) else None


def select_level(res: SplitResult, active: torch.Tensor, sp: SplitParams,
                 budget: int, slots: int):
    """The level's budgeted selection (reference: grow_depthwise.py
    :446-458, :859-868): leaves whose record gains pass the gate, ranked by
    gain with ties to the lower leaf index, the first min(budget, slots).
    Returns (sel [L] bool, si the selected leaves ascending, idx_in_lvl
    [L] i64: each selected leaf's place among them)."""
    # under feature_contri the records hold the penalized improvement,
    # min_gain_to_split taken off already
    gain_gate = 0.0 if sp.has_contri else float(max(sp.min_gain_to_split,
                                                    0.0))
    iota = torch.arange(active.shape[0], device=active.device)
    cand = active & (res.gain > gain_gate) & (res.gain > NEG_INF / 2)
    key = torch.where(cand, res.gain, torch.full_like(res.gain, -math.inf))
    kj, ki = key[None, :], key[:, None]
    better = (kj > ki) | ((kj == ki) & (iota[None, :] < iota[:, None]))
    rank = better.sum(dim=1)
    sel = cand & (rank < min(budget, slots))
    return sel, sel.nonzero().squeeze(1), torch.cumsum(sel.to(torch.int64),
                                                       0) - 1


def _tables_on(tables: H.RouteTables, device: torch.device
               ) -> H.RouteTables:
    """A level's route tables on a shard's device."""
    return H.RouteTables(*[None if x is None else x.to(device)
                           for x in tables])


def _on_devices(x: torch.Tensor, sh: ShardedRows) -> list:
    """``x`` on each shard's device (the same tensor where it lies)."""
    return [x.to(s.device) for s in sh.shards]


def _stable_top(key: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries, the lower index first on a
    tie (``jax.lax.top_k``)."""
    return torch.sort(key, descending=True, stable=True).indices[:k]


def voting_exchange(parts: list, sh: ShardedRows, num_bins: torch.Tensor,
                    na_bin: torch.Tensor, sp: SplitParams, gp: GrowParams
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The voting-parallel histogram exchange of one level (PV-Tree;
    reference: grow_depthwise.py:493-560, VotingParallelTreeLearner
    GlobalVoting + CopyLocalHistogram): each shard scores every feature by
    the sum over its level slots of the feature's best local gain and
    votes for its top 2k; the votes and the scores are summed over the
    shards, the k features of the most votes (then score) are elected, and
    only their histograms are summed. Returns (the summed [S, 3, F, B]
    histograms, zero off the elected features; the [F] elected mask), on
    the first shard's device."""
    f = parts[0].shape[2]
    k = min(gp.voting_top_k, f)
    k2 = min(2 * k, f)
    scores, votes = [], []
    for hp, nb, na in zip(parts, _on_devices(num_bins, sh),
                          _on_devices(na_bin, sh)):
        lg = per_feature_gains(hp, nb, na, tree_sum(hp[:, 0, 0]),
                               tree_sum(hp[:, 1, 0]), tree_sum(hp[:, 2, 0]),
                               sp)                               # [S, F]
        score = torch.where(lg > NEG_INF / 2, lg,
                            torch.zeros_like(lg)).sum(0)
        thresh2 = torch.sort(score, descending=True).values[k2 - 1]
        scores.append(score)
        votes.append((score >= thresh2).to(torch.float32))
    elect_key = _psum(votes, gp) * 1e12 + _psum(scores, gp)
    elected = _stable_top(elect_key, k)
    sub = _hist_allreduce([hp.index_select(2, elected.to(hp.device))
                           for hp in parts], gp, 2)
    out = torch.zeros_like(parts[0], device=sh.home)
    out[:, :, elected] = sub
    mask = torch.zeros(f, dtype=torch.bool, device=sh.home)
    mask[elected] = True
    return out, mask


def grow_tree_depthwise(bins_T: torch.Tensor, g: Optional[torch.Tensor],
                        h: Optional[torch.Tensor], c: Optional[torch.Tensor],
                        num_bins: torch.Tensor, na_bin: torch.Tensor,
                        feature_mask: torch.Tensor, gp: GrowParams, qseed: int,
                        fused: Optional[Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]] = None,
                        bins: Optional[torch.Tensor] = None,
                        bundle: Optional[BundleArrays] = None,
                        forced: Optional[ForcedSplits] = None,
                        cegb: Optional[CEGBState] = None,
                        shards: Optional[ShardedRows] = None,
                        fp_tiles=None
                        ) -> Tuple[TreeArrays, torch.Tensor, int]:
    """Grow one tree level-wise.

    bins_T [F, N] u8 on the device; g/h/c [N] f32 grad/hess/in-bag count
    rows (already masked by the bag); num_bins / na_bin [F] i32 (na_bin >= B
    means no missing bin); feature_mask [F] bool. ``qseed`` varies the
    stochastic-rounding dither (under gp.quant). ``fused``: (score, aux,
    bag) rows for the fused front, valid only with gp.quant and
    gp.fused_obj set; g/h/c are then unused (None) and the gradients are
    recomputed in the kernels. ``bins``: the row-major [N, F] copy of
    bins_T, which the level passes' slot histograms need on the card;
    ``bundle`` the EFB arrays when ``gp.split.has_bundles``; ``forced``
    the forced-splits tree; ``cegb`` the CEGB bookkeeping, updated in
    place (needs the materialized rows). Returns (TreeArrays, leaf_id [N]
    i32, number of level passes).

    ``shards`` (data-parallel, reference: :284-309, :570, :668-681): the
    rows as ``ShardedRows`` (the row arguments are then unused, and the
    CEGB lazy bitset comes as each shard's ``data_used`` block). Each
    shard runs the kernels on its own rows: its front (B1, or make_quant
    and B5, or B8), each level's pass and its leaf sums, with its own
    quantization scales and dither (the row index within the shard), as
    each shard of the reference's shard_map does; the dequantized f32
    histograms and the sums are summed over the shards and the split
    search runs once. Under ``gp.voting_top_k`` both children of a split
    are measured (2 slots a split) and only the elected features'
    histograms are summed (``voting_exchange``). The leaf ids come back as
    a list, one [n_s] i32 tensor a shard.

    ``fp_tiles`` (feature-parallel, ``parallel/feature_parallel.py``
    ``FeatureTiles``, unquantized only): the root and each level's
    histograms are built tile by tile on the tiles' devices and gathered
    before the search."""
    if fp_tiles is not None and (gp.quant or shards is not None):
        raise ValueError("feature tiles take the unquantized serial rows")
    sh = as_sharded(shards, bins_T, bins, g, h, c, fused,
                    None if cegb is None else cegb.data_used)
    f = sh.shards[0].bins_T.shape[0]
    dev = sh.home
    fdev = sh.feature_devices
    L, B = gp.num_leaves, gp.max_bin
    sp = gp.split
    spec = gp.fused_obj
    use_fused = sh.shards[0].fused is not None
    voting = bool(gp.axis_name) and gp.voting_top_k > 0
    max_levels = gp.max_depth if gp.max_depth > 0 else max(1, L - 1)

    if use_fused and (spec is None or not gp.quant or cegb is not None):
        raise ValueError("the fused front needs gp.quant and gp.fused_obj, "
                         "and no CEGB")
    quants, parts = [], []
    for s in sh.shards:
        if use_fused:
            q, h0 = H.grad_quant_hist0(s.bins_T, *s.fused, qseed, spec, B,
                                       const_hess=gp.const_hess)
        elif gp.quant:
            # int8 quantized channels of the materialized rows, built once
            # per tree, then the root histogram
            q = H.make_quant(s.g, s.h, s.c, qseed, const_hess=gp.const_hess)
            h0 = H.hist_leaf(s.bins_T, B, q)
        elif fp_tiles is not None:
            q, h0 = None, fp_tiles.root(B)
        else:
            q, h0 = None, H.hist_leaf(s.bins_T, B, rows=s.rows)
        quants.append(q)
        parts.append(h0)
    hist0 = _hist_allreduce(parts, gp, 1, fdev)
    g0, h0, c0 = tree_sum(hist0[0, 0]), tree_sum(hist0[1, 0]), \
        tree_sum(hist0[2, 0])
    na_of = _on_devices(na_bin, sh)

    f32 = dict(dtype=torch.float32, device=dev)
    hist = torch.zeros((L, 3, f, B), **f32)
    hist[0] = hist0
    leaf_g, leaf_h, leaf_c = (torch.zeros(L, **f32) for _ in range(3))
    leaf_g[0], leaf_h[0], leaf_c[0] = g0, h0, c0
    active = torch.zeros(L, dtype=torch.bool, device=dev)
    active[0] = True
    parent_node = torch.full((L,), -1, dtype=torch.int64, device=dev)
    parent_right = torch.zeros(L, dtype=torch.bool, device=dev)
    tree = empty_tree(L, B, dev)
    tree.leaf_value[0] = leaf_output(g0, h0, sp)
    tree.leaf_weight[0] = h0
    tree.leaf_count[0] = c0
    num_leaves = 1
    leaf_ids = [torch.zeros(s.bins_T.shape[1], dtype=torch.int32,
                            device=s.device) for s in sh.shards]
    leaves_iota = torch.arange(L, device=dev)
    passes = 0
    leaf_min = torch.full((L,), -math.inf, **f32)
    leaf_max = torch.full((L,), math.inf, **f32)
    forced_ptr = torch.full((L,), -1, dtype=torch.int64, device=dev)
    if forced is not None:
        forced_ptr[0] = 0
    # voting: the features each leaf's stored histograms were elected
    # under (reference: _DWState.vote_mask)
    vote_mask = (torch.ones((L, f), dtype=torch.bool, device=dev)
                 if voting else None)

    for lvl, slots in enumerate(level_widths(L, max_levels)):
        if num_leaves >= L:
            break
        base_mask = (feature_mask.expand(L, f) if vote_mask is None
                     else feature_mask & vote_mask)
        search_mask = node_feature_mask(base_mask, gp, qseed, lvl)
        pen = (cegb_penalty(sp, cegb, leaf_c, sh, leaf_ids, gp)
               if cegb is not None else None)
        res = best_split(hist, num_bins, na_bin, leaf_g, leaf_h, leaf_c,
                         search_mask, sp, active, bundle,
                         leaf_min=leaf_min, leaf_max=leaf_max,
                         gain_penalty=pen,
                         rand_key=extra_trees_key(sp, qseed, lvl))
        if forced is not None:
            res, okf = forced_override(res, forced, forced_ptr,
                                       (forced_ptr >= 0) & active, hist,
                                       na_bin, leaf_c)
        # budgeted selection: top-gain candidates win, ties by leaf index
        sel, si, idx_in_lvl = select_level(res, active, sp, L - num_leaves,
                                           slots)
        num_sel = int(si.shape[0])
        if num_sel == 0:
            break
        new_leaf = num_leaves + idx_in_lvl
        nid, nl = (num_leaves - 1 + idx_in_lvl)[si], new_leaf[si]
        (lg, lh, lc), (rg, rh, rc), (w_l, w_r, w_p) = split_outputs(
            res, leaf_g, leaf_h, leaf_c, leaf_min, leaf_max, sp)
        apply_level_to_tree(tree, parent_node, parent_right, res, si, nid,
                            nl, (lg, lh, lc), (rg, rh, rc), (w_l, w_r, w_p),
                            sp)
        cat_sel = _membership_leaves(res, sel, sp)

        # ---- CEGB bookkeeping: a split marks its column used, and every
        # in-bag row of the split leaf paid for it ----
        if cegb is not None and sp.cegb_coupled:
            cegb.feature_used[res.feature[si]] = True
        if cegb is not None and sp.cegb_lazy:
            f_leaf = torch.where(sel, res.feature,
                                 torch.full_like(res.feature, -1))
            for s, lid in zip(sh.shards, leaf_ids):
                f_row = f_leaf.to(s.device)[lid.to(torch.int64)]
                pay = (f_row >= 0) & (s.c > 0)
                s.data_used[pay.nonzero().squeeze(1), f_row[pay]] = True

        # ---- route + child histogram pass, each shard its own rows: one
        # slot per selected leaf (in leaf order) for the smaller child,
        # the larger child the parent minus the smaller; under voting both
        # children, in slots 2i and 2i + 1 ----
        small_is_left = lc <= rc
        if voting:
            s_pass = 2 * num_sel
            none = torch.full_like(idx_in_lvl, s_pass)
            slot_l = torch.where(sel, 2 * idx_in_lvl, none)
            slot_r = torch.where(sel, 2 * idx_in_lvl + 1, none)
        else:
            s_pass = num_sel
            sentinel = torch.full_like(idx_in_lvl, num_sel)
            slot_l = torch.where(sel & small_is_left, idx_in_lvl, sentinel)
            slot_r = torch.where(sel & ~small_is_left, idx_in_lvl, sentinel)
        tables = H.RouteTables(
            feat=torch.where(sel, res.feature, torch.full_like(res.feature, -1)),
            thr=res.bin, dleft=res.default_left.to(torch.int32),
            new_leaf=new_leaf, slot_left=slot_l, slot_right=slot_r,
            # a level with a categorical or bundle split routes by
            # membership (reference: grow_depthwise.py:521-524); others
            # pass no bitset
            is_cat=cat_sel,
            member=(None if cat_sel is None
                    else res.cat_member & sel[:, None]))
        parts = []
        for i, s in enumerate(sh.shards):
            if fp_tiles is not None:
                hp, leaf_ids[i] = fp_tiles.routed(leaf_ids[i], tables,
                                                  na_of[i], s_pass, B)
                parts.append(hp)
                continue
            hp, leaf_ids[i] = H.hist_routed(
                s.bins_T, leaf_ids[i], _tables_on(tables, s.device), na_of[i],
                s_pass, B, quants[i], s.rows, s.bins)
            parts.append(hp)
        passes += 1
        if voting:
            hist_pass, elected = voting_exchange(parts, sh, num_bins, na_bin,
                                                 sp, gp)
            hist[si] = hist_pass[0::2]
            hist[nl] = hist_pass[1::2]
            # only the leaves whose histograms were replaced narrow to the
            # new election
            vote_mask[si] = elected
            vote_mask[nl] = elected
        else:
            hist_pass = _hist_allreduce(parts, gp, 2, fdev)
            parent_hist = hist[si]
            hist_sib = parent_hist - hist_pass
            sl = small_is_left[si][:, None, None, None]
            hist[si] = torch.where(sl, hist_pass, hist_sib)
            hist[nl] = torch.where(sl, hist_sib, hist_pass)

        # ---- monotone bounds and forced pointers of the children ----
        if sp.has_monotone:
            lo_l, hi_l, lo_r, hi_r = monotone_child_bounds(
                sp, f, res.is_cat[si], res.feature[si], w_l[si], w_r[si],
                leaf_min[si], leaf_max[si])
            leaf_min[si], leaf_max[si] = lo_l, hi_l
            leaf_min[nl], leaf_max[nl] = lo_r, hi_r
        if forced is not None:
            fp = torch.clamp(forced_ptr, min=0)
            none = torch.full_like(forced_ptr, -1)
            nxt_l = torch.where(okf, forced.left[fp], none)[si]
            nxt_r = torch.where(okf, forced.right[fp], none)[si]
            forced_ptr[si] = nxt_l
            forced_ptr[nl] = nxt_r

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

    out_ids = leaf_ids if shards is not None else leaf_ids[0]
    if not gp.quant:
        return tree._replace(num_leaves=num_leaves), out_ids, passes
    # ---- leaf renewal from exact sums (quantized-training: splits
    # tolerate int8 gains, leaf outputs use exact sums), each shard's rows
    # summed ----
    sums = _psum([K.leaf_sums_grad(*s.fused, lid, spec, L) if use_fused
                  else K.leaf_sums(s.g, s.h, s.c, lid, L)
                  for s, lid in zip(sh.shards, leaf_ids)], gp)
    eg, eh, ec = sums[0], sums[1], sums[2]
    w = leaf_output(eg, eh, sp)
    if sp.has_monotone:
        w = torch.clamp(w, leaf_min, leaf_max)
    live = leaves_iota < num_leaves
    tree = tree._replace(
        leaf_value=torch.where(live, w, tree.leaf_value),
        leaf_weight=torch.where(live, eh, tree.leaf_weight),
        leaf_count=torch.where(live, ec, tree.leaf_count),
        num_leaves=num_leaves)
    return tree, out_ids, passes


# ---------------------------------------------------------------------------
# the lean depthwise grower: histogram_pool_size for the level-wise path
# ---------------------------------------------------------------------------

def tile_split_params(sp: SplitParams, lo: int, hi: int) -> SplitParams:
    """The split parameters of the feature tile [lo, hi) (reference:
    ``_tile_split_params``, grow_depthwise.py:715-737): categorical
    indices, monotone constraints and feature_contri re-indexed to the
    tile. The clamp to the leaf's output bounds and the contri rewrite stay
    on in a tile whose own slice is trivial (``monotone_clamp``,
    ``contri_active``): a leaf's bounds hold for a split on any column, and
    the tiles' winners are compared on one gain scale."""
    kw = {}
    if sp.cat_features:
        kw["cat_features"] = tuple(c - lo for c in sp.cat_features
                                   if lo <= c < hi)
    if sp.monotone_constraints:
        mc = list(sp.monotone_constraints)
        kw["monotone_constraints"] = tuple((mc + [0] * hi)[lo:hi])
        kw["monotone_clamp"] = sp.has_monotone
    if sp.feature_contri:
        fc = list(sp.feature_contri)
        kw["feature_contri"] = tuple((fc + [1.0] * hi)[lo:hi])
        kw["contri_active"] = sp.has_contri
    return replace(sp, **kw) if kw else sp


def fold_best(a: SplitResult, b: SplitResult) -> SplitResult:
    """Per leaf the record of higher gain, the earlier tile's on a tie
    (reference: ``_fold_best``, grow_depthwise.py:740-748: the whole
    search's first maximum in feature order)."""
    take = b.gain > a.gain
    return SplitResult(*[
        torch.where(take.reshape(take.shape + (1,) * (va.dim() - 1)), vb, va)
        for va, vb in zip(a, b)])


def slice_bundle(bundle: Optional[BundleArrays], lo: int,
                 hi: int) -> Optional[BundleArrays]:
    """The EFB arrays of the columns [lo, hi)."""
    return None if bundle is None else BundleArrays(
        *[v[lo:hi] for v in bundle])


def lean_tiles(f: int, lean_ft: int) -> List[Tuple[int, int]]:
    """The feature tiles [t * ft, min(F, (t + 1) * ft)) of the lean grower
    (reference: grow_depthwise.py:784-786, :821-822)."""
    ft = max(1, min(lean_ft or f, f))
    return [(lo, min(f, lo + ft)) for lo in range(0, f, ft)]


def grow_tree_depthwise_lean(bins_T: torch.Tensor, g: torch.Tensor,
                             h: torch.Tensor, c: torch.Tensor,
                             num_bins: torch.Tensor, na_bin: torch.Tensor,
                             feature_mask: torch.Tensor, gp: GrowParams,
                             qseed: int, bins: Optional[torch.Tensor] = None,
                             bundle: Optional[BundleArrays] = None,
                             shards: Optional[ShardedRows] = None
                             ) -> Tuple[TreeArrays, torch.Tensor, int]:
    """Grow one tree level-wise under a histogram-memory budget (reference:
    ``grow_tree_depthwise_lean``, grow_depthwise.py:751-1022).

    The default grower keeps the [L, 3, F, B] histograms of the whole
    frontier for sibling subtraction and for leaves whose split waits for
    a later level. This grower keeps none: each active leaf caches its
    best split record (valid until it splits, since its rows do not
    change), each level measures both children of every selected split
    (slots 2i and 2i + 1), and the histogram pass and the split search run
    one feature tile [lo, hi) of width ``gp.lean_ft`` at a time, folding
    the tiles' winners (``fold_best``), so that the live histogram is one
    tile's [2S, 3, ft, B].

    Arguments as ``grow_tree_depthwise`` (materialized g/h/c rows; bins
    the row-major [N, F] matrix, which each tile's slot histogram reads in
    place at the tile's column offset). Per tree the kernels run:
    ``leaf_sums`` once for the root's stats (and once more for the leaf
    renewal under ``gp.quant``); at the root and after each level's
    ``route_level`` (one a level, full width, 2S slots, its counts handed
    to every tile), ``hist_q8`` (``gp.quant``) or ``hist_f32`` once a
    tile. One host sync a level, the selection's count. Not combined with
    CEGB, forced splits, feature_fraction_bynode or extra_trees (GBDT keeps
    the default grower then). Returns (TreeArrays, leaf_id [N] i32, number
    of level passes).

    ``shards`` (data-parallel, reference: :811-852, :1010): the rows as
    ``ShardedRows``; each shard routes, measures each tile and sums its
    leaves on its own rows, with its own quantization, and each tile's
    histograms and the sums are summed over the shards. The leaf ids come
    back as a list, one a shard."""
    shd = as_sharded(shards, bins_T, bins, g, h, c)
    f = shd.shards[0].bins_T.shape[0]
    dev = shd.home
    L, B = gp.num_leaves, gp.max_bin
    sp = gp.split
    max_levels = gp.max_depth if gp.max_depth > 0 else max(1, L - 1)
    tiles = [(lo, hi, tile_split_params(sp, lo, hi),
              slice_bundle(bundle, lo, hi)) for lo, hi in
             lean_tiles(f, gp.lean_ft)]
    quants = [H.make_quant(s.g, s.h, s.c, qseed, const_hess=gp.const_hess)
              if gp.quant else None for s in shd.shards]
    na_of = _on_devices(na_bin, shd)

    def measure_tile(s, quant, slot, counts, n_slots, lo, hi):
        """[S, 3, hi - lo, B] f32 histograms of one tile of one shard's
        rows, read in place."""
        if quant is None:
            return K.hist_f32(s.bins_T[lo:hi], s.g, s.h, s.c, slot, n_slots,
                              B, s.bins, counts, col0=lo)
        acc = K.hist_q8(s.bins_T[lo:hi], quant.gq, quant.hq, quant.cq, slot,
                        n_slots, B, s.bins, counts, col0=lo)
        return H.dequant(acc, quant.hq is None, quant.scale_g, quant.scale_h)

    def tiled_search(routed, n_slots, sg, sh, sc, lmin, lmax):
        """Each slot's best split from the tiles' passes and searches;
        ``routed`` each shard's (slot, counts)."""
        best = None
        allow = torch.ones(n_slots, dtype=torch.bool, device=dev)
        for lo, hi, sp_t, bun_t in tiles:
            hist_t = _hist_allreduce(
                [measure_tile(s, q, slot, counts, n_slots, lo, hi)
                 for s, q, (slot, counts) in zip(shd.shards, quants, routed)],
                gp, 2, shd.feature_devices)
            res_t = best_split(hist_t, num_bins[lo:hi], na_bin[lo:hi], sg, sh,
                               sc, feature_mask[lo:hi], sp_t, allow, bun_t,
                               leaf_min=lmin, leaf_max=lmax)
            res_t = res_t._replace(feature=res_t.feature + lo)
            best = res_t if best is None else fold_best(best, res_t)
        return best

    # ---- root: exact stats from one leaf sum, its record from the tiles'
    # natural-order passes ----
    leaf_ids = [torch.zeros(s.bins_T.shape[1], dtype=torch.int32,
                            device=s.device) for s in shd.shards]
    sums0 = _psum([K.leaf_sums(s.g, s.h, s.c, lid, 1)
                   for s, lid in zip(shd.shards, leaf_ids)], gp)
    g0, h0, c0 = sums0[0, 0], sums0[1, 0], sums0[2, 0]
    f32 = dict(dtype=torch.float32, device=dev)
    inf = torch.full((1,), math.inf, **f32)
    rec0 = tiled_search([(None, None)] * len(shd.shards), 1, g0[None],
                        h0[None], c0[None], -inf, inf)
    rec = SplitResult(*[
        torch.cat([v, torch.full((L - 1,) + v.shape[1:],
                                 NEG_INF if v.is_floating_point() else 0,
                                 dtype=v.dtype, device=dev)])
        for v in rec0])
    leaf_g, leaf_h, leaf_c = (torch.zeros(L, **f32) for _ in range(3))
    leaf_g[0], leaf_h[0], leaf_c[0] = g0, h0, c0
    active = torch.zeros(L, dtype=torch.bool, device=dev)
    active[0] = True
    parent_node = torch.full((L,), -1, dtype=torch.int64, device=dev)
    parent_right = torch.zeros(L, dtype=torch.bool, device=dev)
    leaf_min = torch.full((L,), -math.inf, **f32)
    leaf_max = torch.full((L,), math.inf, **f32)
    tree = empty_tree(L, B, dev)
    tree.leaf_value[0] = leaf_output(g0, h0, sp)
    tree.leaf_weight[0] = h0
    tree.leaf_count[0] = c0
    num_leaves, passes = 1, 0

    for slots in level_widths(L, max_levels):
        if num_leaves >= L:
            break
        sel, si, idx_in_lvl = select_level(rec, active, sp, L - num_leaves,
                                           slots)
        num_sel = int(si.shape[0])
        if num_sel == 0:
            break
        new_leaf = num_leaves + idx_in_lvl
        nid, nl = (num_leaves - 1 + idx_in_lvl)[si], new_leaf[si]
        (lg, lh, lc), (rg, rh, rc), (w_l, w_r, w_p) = split_outputs(
            rec, leaf_g, leaf_h, leaf_c, leaf_min, leaf_max, sp)
        apply_level_to_tree(tree, parent_node, parent_right, rec, si, nid,
                            nl, (lg, lh, lc), (rg, rh, rc), (w_l, w_r, w_p),
                            sp)
        cat_sel = _membership_leaves(rec, sel, sp)

        # ---- route: both children measured, split i's in slots 2i and
        # 2i + 1 ----
        s_pass = 2 * num_sel
        none = torch.full_like(idx_in_lvl, s_pass)
        tables = H.RouteTables(
            feat=torch.where(sel, rec.feature, torch.full_like(rec.feature,
                                                               -1)),
            thr=rec.bin, dleft=rec.default_left.to(torch.int32),
            new_leaf=new_leaf,
            slot_left=torch.where(sel, 2 * idx_in_lvl, none),
            slot_right=torch.where(sel, 2 * idx_in_lvl + 1, none),
            is_cat=cat_sel,
            member=(None if cat_sel is None
                    else rec.cat_member & sel[:, None]))
        routed = []
        for i, s in enumerate(shd.shards):
            t_d = _tables_on(tables, s.device)
            slot, leaf_ids[i], counts = K.route_level(
                s.bins_T, leaf_ids[i], t_d.stacked(), na_of[i], s_pass,
                t_d.bitset())
            routed.append((slot, counts))
        passes += 1

        # ---- monotone bounds, per-leaf stats, frontier ----
        if sp.has_monotone:
            lo_l, hi_l, lo_r, hi_r = monotone_child_bounds(
                sp, f, rec.is_cat[si], rec.feature[si], w_l[si], w_r[si],
                leaf_min[si], leaf_max[si])
            leaf_min[si], leaf_max[si] = lo_l, hi_l
            leaf_min[nl], leaf_max[nl] = lo_r, hi_r
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

        # ---- fresh records of the 2S children from the tiled search ----
        slot_leaf = torch.stack([si, nl], dim=1).reshape(s_pass)
        child = tiled_search(routed, s_pass, leaf_g[slot_leaf],
                             leaf_h[slot_leaf], leaf_c[slot_leaf],
                             leaf_min[slot_leaf], leaf_max[slot_leaf])
        for arr, vals in zip(rec, child):
            arr[slot_leaf] = vals

    out_ids = leaf_ids if shards is not None else leaf_ids[0]
    if not gp.quant:
        return tree._replace(num_leaves=num_leaves), out_ids, passes
    # ---- leaf renewal from exact sums, as the default grower ----
    sums = _psum([K.leaf_sums(s.g, s.h, s.c, lid, L)
                  for s, lid in zip(shd.shards, leaf_ids)], gp)
    w = leaf_output(sums[0], sums[1], sp)
    if sp.has_monotone:
        w = torch.clamp(w, leaf_min, leaf_max)
    live = torch.arange(L, device=dev) < num_leaves
    tree = tree._replace(
        leaf_value=torch.where(live, w, tree.leaf_value),
        leaf_weight=torch.where(live, sums[1], tree.leaf_weight),
        leaf_count=torch.where(live, sums[2], tree.leaf_count),
        num_leaves=num_leaves)
    return tree, out_ids, passes
