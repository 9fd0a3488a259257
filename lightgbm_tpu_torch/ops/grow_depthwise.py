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
fixed-width masked scatters. The port's level pass (``level_pass``) does
the same at the level's slot width from the schedule (32 or 127 at 255
leaves): the selected leaves in ascending order, then one trash row each
for the slots the level leaves empty, the route tables' sentinel the
width, and the budget, the leaf count and the selected count on the card.
A pass makes one host read, the next level's selected count
(``sync.select``), which stops the tree at 0; the parents' child pointers
and the frontier are scattered on the card. Where the rows live is
``LevelRows``: one shard, row shards whose histograms are summed (the
data-parallel learner, across processes too), the voting election, or
feature tiles; the pass runs the same on each. On one shard in one
process on the card the pass is captured as a CUDA graph, one per (width,
next width), and replayed for every later level of every tree of the
trainer (``LevelGraphs``, a ``pass.replay`` span in ``grow.pass``), where
``capture_engages``; CEGB, forced splits, feature_fraction_bynode,
extra_trees, categorical features, EFB bundles, monotone constraints and
feature_contri run the same pass eagerly, in its ``pass.*`` spans; each
host read sits in a ``sync.*`` span (``obs/tracing.py``).
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass, replace
from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..obs.tracing import span
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
    with span("sync.cegb"):
        per_row = torch.tensor(sp.cegb_tradeoff * sp.cegb_penalty_split,
                               dtype=torch.float32, device=leaf_c.device)
    pen = (per_row * leaf_c[:, None]).expand(L, f)
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


def apply_level_fixed(tree: TreeArrays, parent_node: torch.Tensor,
                      parent_right: torch.Tensor, res: SplitResult,
                      si: torch.Tensor, nid: torch.Tensor, nl: torch.Tensor,
                      valid: torch.Tensor, trash_node: torch.Tensor,
                      left, right, outputs, sp: SplitParams) -> None:
    """Write one level's splits into the tree arrays, in place and with no
    host read (reference: grow_depthwise.py:103-141): slot j's leaf
    ``si`` becomes node ``nid`` whose right child is the new leaf ``nl``,
    a slot past the level's count (``valid`` False) pointing at trash
    rows of its own; each parent's child pointer moves to its node, every
    other slot's write lands on its trash node ``trash_node``; ``left`` /
    ``right`` the (g, h, count) stats and ``outputs`` the (left, right,
    parent) outputs of every leaf."""
    par = parent_node[si]
    has_par = valid & (par >= 0)
    pr = parent_right[si]
    nid32 = nid.to(torch.int32)
    tree.left_child[torch.where(has_par & ~pr, par, trash_node)] = nid32
    tree.right_child[torch.where(has_par & pr, par, trash_node)] = nid32
    _write_level_nodes(tree, res, si, nid, nl, left, right, outputs, sp)


def _write_level_nodes(tree: TreeArrays, res: SplitResult, si, nid, nl,
                       left, right, outputs, sp: SplitParams) -> None:
    """The new nodes and both children's leaf values of the splits of
    leaves ``si`` (nodes ``nid``, right children ``nl``)."""
    (lg, lh, lc), (rg, rh, rc), (w_l, w_r, w_p) = left, right, outputs
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
    # a second read a level, only with categorical features or bundles:
    # route_level takes the membership tables only on a level that splits
    # on one
    with span("sync.membership"):
        # tpu-lint: disable=host-sync-in-jit
        any_cat = bool(cat_sel.any())
    return cat_sel if any_cat else None


def _select(gain: torch.Tensor, active: torch.Tensor, sp: SplitParams,
            cap) -> torch.Tensor:
    """sel [L] bool: the leaves whose record gains pass the gate, ranked
    by gain with ties to the lower leaf index, the first ``cap`` (an int,
    or a 0-d tensor on the card)."""
    # under feature_contri the records hold the penalized improvement,
    # min_gain_to_split taken off already
    gain_gate = 0.0 if sp.has_contri else float(max(sp.min_gain_to_split,
                                                    0.0))
    iota = torch.arange(active.shape[0], device=active.device)
    cand = active & (gain > gain_gate) & (gain > NEG_INF / 2)
    key = torch.where(cand, gain, torch.full_like(gain, -math.inf))
    kj, ki = key[None, :], key[:, None]
    better = (kj > ki) | ((kj == ki) & (iota[None, :] < iota[:, None]))
    return cand & (better.sum(dim=1) < cap)


def select_level(res: SplitResult, active: torch.Tensor, sp: SplitParams,
                 budget: int, slots: int):
    """The level's budgeted selection (reference: grow_depthwise.py
    :446-458, :859-868): leaves whose record gains pass the gate, ranked by
    gain with ties to the lower leaf index, the first min(budget, slots).
    Returns (sel [L] bool, si the selected leaves ascending, idx_in_lvl
    [L] i64: each selected leaf's place among them)."""
    sel = _select(res.gain, active, sp, min(budget, slots))
    # the one intended sync a level: the host sizes the level's route and
    # histogram launches by the number of leaves that split, and stops the
    # tree when none does
    with span("sync.select"):
        # tpu-lint: disable=host-sync-in-jit
        si = sel.nonzero().squeeze(1)
    return sel, si, torch.cumsum(sel.to(torch.int64), 0) - 1


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
    with span("sync.voting"):
        mask[elected] = True
    return out, mask


# ---------------------------------------------------------------------------
# the level pass: a fixed slot width, one host read, replayed as a CUDA
# graph on the card
# ---------------------------------------------------------------------------

_LEAF_FIELDS = ("leaf_value", "leaf_weight", "leaf_count")


def trim_tree(tree: TreeArrays, L: int, num_leaves: int) -> TreeArrays:
    """A tree's arrays without the trash rows of ``empty_tree(...,
    spare=)``, in tensors of their own."""
    m = max(L - 1, 1)
    return TreeArrays(num_leaves=num_leaves, **{
        k: v[:L if k in _LEAF_FIELDS else m].clone()
        for k, v in tree._asdict().items() if k != "num_leaves"})


class LevelRows:
    """Where a tree's rows live, for the level pass: one shard (the serial
    grower), row shards whose histograms and sums are summed over the
    shards and the processes (the data-parallel learner, reference:
    :284-309, :570, :668-681), the same under the voting election, or one
    shard whose histograms are built tile by tile (``fp_tiles``, the
    feature-parallel learner's ``FeatureTiles``). It holds each shard's
    row inputs (its quantized channels with their own scales and dither,
    or the f32 rows without quantization) and leaf ids, the summed root
    histogram and the column mask, and measures each pass's histograms.
    Under voting it keeps the features each leaf's stored histograms were
    elected under (reference: ``_DWState.vote_mask``), which narrow the
    leaf's column mask."""

    def __init__(self, sh: ShardedRows, fmask: torch.Tensor,
                 num_bins: torch.Tensor, na_bin: torch.Tensor,
                 gp: GrowParams, width: int, fp_tiles=None):
        self.sh, self.fmask, self.num_bins, self.gp = sh, fmask, num_bins, gp
        self.tiles = fp_tiles
        self.na_of = _on_devices(na_bin, sh)
        # zeroed by each tree's start (``begin_tree``)
        self.leaf_ids = [torch.empty(s.bins_T.shape[1], dtype=torch.int32,
                                     device=s.device) for s in sh.shards]
        self.summed = len(sh.shards) > 1 or gp.processes > 1
        self.voting = bool(gp.axis_name) and gp.voting_top_k > 0
        self.vote_mask = (torch.ones((gp.num_leaves + width, fmask.shape[0]),
                                     dtype=torch.bool, device=sh.home)
                          if self.voting else None)
        self.quants: list = []
        self.inputs: list = []
        self.hist0: Optional[torch.Tensor] = None

    @property
    def serial(self) -> bool:
        return not (self.summed or self.voting or self.tiles is not None)

    def front(self, qseed: int) -> None:
        """Each shard's row inputs and root histogram (B1; make_quant and
        B5; B8; or the tiles'), the histograms summed into ``hist0``."""
        gp, B = self.gp, self.gp.max_bin
        parts = []
        for s in self.sh.shards:
            if s.fused is not None:
                q, h0 = H.grad_quant_hist0(s.bins_T, *s.fused, qseed,
                                           gp.fused_obj, B,
                                           const_hess=gp.const_hess)
            elif gp.quant:
                q = H.make_quant(s.g, s.h, s.c, qseed,
                                 const_hess=gp.const_hess)
                h0 = H.hist_leaf(s.bins_T, B, q)
            elif self.tiles is not None:
                q, h0 = None, self.tiles.root(B)
            else:
                q, h0 = None, H.hist_leaf(s.bins_T, B, rows=s.rows)
            self.quants.append(q)
            self.inputs.append(s.rows if q is None else None)
            parts.append(h0)
        self.hist0 = _hist_allreduce(parts, gp, 1, self.sh.feature_devices)

    def pin(self, held: Optional[list]) -> list:
        """Move the one shard's leaf ids, root histogram, column mask and
        row inputs into buffers whose addresses a captured graph keeps:
        ``held``, the last tree's (its leaf ids as they are, the rest
        copied into), or the first time this tree's leaf ids and clones.
        Returns the buffers for the next tree."""
        q = self.quants[0]
        now = [self.hist0, self.fmask, *(self.inputs[0] if q is None else q)]
        if held is None:
            held = [self.leaf_ids[0]] + [None if t is None else t.clone()
                                         for t in now]
        else:
            for dst, src in zip(held[1:], now):
                if dst is not None:
                    dst.copy_(src)
        self.leaf_ids[0], self.hist0, self.fmask = held[:3]
        if q is None:
            self.inputs[0] = tuple(held[3:])
        else:
            self.quants[0] = H.QuantChannels(*held[3:])
        return held

    def column_mask(self, L: int) -> torch.Tensor:
        """[L, F] the columns each leaf's search may take."""
        if self.vote_mask is None:
            return self.fmask.expand(L, self.fmask.shape[0])
        return self.fmask & self.vote_mask[:L]

    def measure(self, tables: H.RouteTables, slots: int, used: int,
                si: torch.Tensor, nl: torch.Tensor) -> torch.Tensor:
        """Route each shard's rows through the level's splits and measure
        its [slots, 3, F, B] slot histograms; the shards' are summed over
        their first ``used`` slots, the ones the level fills, so that an
        exchange sends no empty slot. Under voting only the elected
        features' are summed (``voting_exchange``), and the leaves ``si``
        and ``nl`` whose histograms they become take the election's
        mask."""
        gp, B = self.gp, self.gp.max_bin
        parts = []
        for i, s in enumerate(self.sh.shards):
            if self.tiles is not None:
                hp, lid = self.tiles.routed(self.leaf_ids[i], tables,
                                            self.na_of[i], slots, B)
            else:
                hp, lid = H.hist_routed(
                    s.bins_T, self.leaf_ids[i], _tables_on(tables, s.device),
                    self.na_of[i], slots, B, self.quants[i], self.inputs[i],
                    s.bins)
            self.leaf_ids[i].copy_(lid)
            parts.append(hp)
        hp = parts[0]
        if self.voting:
            hp[:used], elected = voting_exchange(
                [p[:used] for p in parts], self.sh, self.num_bins,
                self.na_of[0], gp.split, gp)
            self.vote_mask[si] = elected
            self.vote_mask[nl] = elected
        elif self.summed:
            hp[:used] = _hist_allreduce([p[:used] for p in parts], gp, 2,
                                        self.sh.feature_devices)
        return hp

    def pay_lazy(self, f_leaf: torch.Tensor) -> None:
        """CEGB's lazy bookkeeping on every shard: each in-bag row of a
        leaf that splits (``f_leaf`` its column, -1 elsewhere) has paid for
        the column; each row's one cell OR-ed with its flag, no host read
        of how many rows paid."""
        for s, lid in zip(self.sh.shards, self.leaf_ids):
            f_row = f_leaf.to(s.device)[lid.to(torch.int64)]
            pay = (f_row >= 0) & (s.c > 0)
            rows = torch.arange(f_row.shape[0], device=s.device)
            col = f_row.clamp(min=0)
            s.data_used[rows, col] = s.data_used[rows, col] | pay

    def leaf_sums(self, lids: list, L: int) -> torch.Tensor:
        """[3, L] exact (g, h, count) sums of each leaf's rows, summed over
        the shards (B3, or B7)."""
        spec = self.gp.fused_obj
        return _psum([K.leaf_sums_grad(*s.fused, lid, spec, L)
                      if s.fused is not None
                      else K.leaf_sums(s.g, s.h, s.c, lid, L)
                      for s, lid in zip(self.sh.shards, lids)], self.gp)


class LevelState:
    """The frontier and the tree the level pass reads and writes. Every
    per-leaf array has ``L + W`` rows and every per-node array ``m + W``
    (``W`` the widest level, ``m`` the tree's L - 1 nodes): slot j of a
    level that selects fewer leaves than its width writes leaf row ``L +
    j`` and node row ``m + j``, trash rows that no search and no tree
    reads, so that no write repeats an index. The step is the last
    search's records and selection over the first L rows: ``sel``, each
    selected leaf's place ``idx``, and their ``count``, on the card like
    ``num_leaves``."""

    def __init__(self, L: int, f: int, B: int, W: int, dev: torch.device):
        T = L + W
        f32 = dict(dtype=torch.float32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        b8 = dict(dtype=torch.bool, device=dev)
        self.L, self.m = L, max(L - 1, 1)
        self.hist = torch.zeros((T, 3, f, B), **f32)
        self.leaf_g, self.leaf_h, self.leaf_c, self.leaf_min, \
            self.leaf_max = (torch.zeros(T, **f32) for _ in range(5))
        self.active, self.parent_right = (torch.zeros(T, **b8)
                                          for _ in range(2))
        self.parent_node, self.forced_ptr = (torch.zeros(T, **i64)
                                             for _ in range(2))
        self.num_leaves = torch.ones((), **i64)
        self.tree = empty_tree(L, B, dev, spare=W)
        self.res = SplitResult(
            gain=torch.zeros(T, **f32), feature=torch.zeros(T, **i64),
            bin=torch.zeros(T, **i64),
            default_left=torch.zeros(T, **b8), left_g=torch.zeros(T, **f32),
            left_h=torch.zeros(T, **f32), left_cnt=torch.zeros(T, **f32),
            is_cat=torch.zeros(T, **b8),
            cat_member=torch.zeros((T, B), **b8))
        self.okf, self.sel = (torch.zeros(T, **b8) for _ in range(2))
        self.idx = torch.zeros(T, **i64)
        self.count = torch.zeros((), **i64)
        self.slots = torch.arange(W, **i64)

    def begin(self, sp: SplitParams, forced, hist0: torch.Tensor) -> None:
        """A new tree from the root histogram ``hist0``: the root's sums
        and a tree of no split."""
        g0, h0, c0 = tree_sum(hist0[0, 0]), tree_sum(hist0[1, 0]), \
            tree_sum(hist0[2, 0])
        self.hist.zero_()
        self.hist[0] = hist0
        for arr, v in ((self.leaf_g, g0), (self.leaf_h, h0),
                       (self.leaf_c, c0)):
            arr.zero_()
            arr[0] = v
        self.leaf_min.fill_(-math.inf)
        self.leaf_max.fill_(math.inf)
        self.active.zero_()
        self.active[:1].fill_(True)
        self.parent_node.fill_(-1)
        self.parent_right.zero_()
        self.forced_ptr.fill_(-1)
        if forced is not None:
            self.forced_ptr[:1].fill_(0)
        self.num_leaves.fill_(1)
        for name, arr in self.tree._asdict().items():
            if name != "num_leaves":
                arr.zero_()
        self.tree.leaf_value[0] = leaf_output(g0, h0, sp)
        self.tree.leaf_weight[0] = h0
        self.tree.leaf_count[0] = c0


class PassIO(NamedTuple):
    """What a level pass reads besides its ``LevelState``: the bin
    tables, the per-tree inputs of the paths that run the pass eagerly,
    and the tree's rows."""
    gp: GrowParams
    num_bins: torch.Tensor
    na_bin: torch.Tensor
    bundle: Optional[BundleArrays]
    forced: Optional[ForcedSplits]
    cegb: Optional[CEGBState]
    qseed: int
    rows: LevelRows


def _no_phase(name: str):
    return nullcontext()


def _read_count(st: LevelState) -> int:
    """The last search's selected count, on the host: the one read of a
    level; the host stops the tree when it is 0."""
    with span("sync.select"):
        # the one intended read a level: the host stops the tree on 0
        # tpu-lint: disable=host-sync-in-jit
        return int(st.count.item())


def _search(st: LevelState, io: PassIO, lvl: int, slots: int) -> None:
    """Level ``lvl``'s split search over the first L rows and its budgeted
    selection of at most ``slots`` leaves (reference: grow_depthwise.py
    :446-458), into the step; the budget stays on the card."""
    gp, sp, L, rows = io.gp, io.gp.split, st.L, io.rows
    hist, leaf_c, active = st.hist[:L], st.leaf_c[:L], st.active[:L]
    mask = node_feature_mask(rows.column_mask(L), gp, io.qseed, lvl)
    pen = (cegb_penalty(sp, io.cegb, leaf_c, rows.sh, rows.leaf_ids, gp)
           if io.cegb is not None else None)
    res = best_split(hist, io.num_bins, io.na_bin, st.leaf_g[:L],
                     st.leaf_h[:L], leaf_c, mask, sp, active, io.bundle,
                     leaf_min=st.leaf_min[:L], leaf_max=st.leaf_max[:L],
                     gain_penalty=pen,
                     rand_key=extra_trees_key(sp, io.qseed, lvl))
    if io.forced is not None:
        fptr = st.forced_ptr[:L]
        res, okf = forced_override(res, io.forced, fptr,
                                   (fptr >= 0) & active, hist, io.na_bin,
                                   leaf_c)
        st.okf[:L] = okf
    sel = _select(res.gain, active, sp,
                  torch.clamp(L - st.num_leaves, max=slots))
    cum = torch.cumsum(sel.to(torch.int64), 0)
    for dst, src in zip(st.res, res):
        dst[:L] = src
    st.sel[:L] = sel
    st.idx[:L] = cum - 1
    st.count.copy_(cum[-1])


def begin_tree(st: LevelState, io: PassIO,
               width: Optional[int]) -> None:
    """A tree's start from its rows' root histogram, every row in leaf 0,
    then, unless ``width`` is None, the root's search and selection of at
    most ``width`` leaves."""
    st.begin(io.gp.split, io.forced, io.rows.hist0)
    for lid in io.rows.leaf_ids:
        lid.zero_()
    if width is not None:
        _search(st, io, 0, width)


def level_pass(st: LevelState, io: PassIO, lvl: int, width: int,
               next_width: Optional[int], count: int, phase=span,
               read: bool = True) -> int:
    """One level pass at slot width ``width``, from the step's selection
    of ``count`` leaves (reference: grow_depthwise.py :459-632, the same
    masked scatters): the selected leaves become nodes, their rows are
    routed and the smaller children measured in ``width`` slots, the
    larger by subtraction (under voting both, in slots 2j and 2j + 1),
    and the stats and frontier follow; then, unless ``next_width`` is
    None, level ``lvl`` + 1's search. Its one host read, when ``read`` is
    set, is the count of that search's selection, which it returns (else
    0); the paths that run it eagerly add their own (the categorical
    membership, CEGB's copies, the voting election). ``count``, read by
    the host before, sizes only the shards' exchange: the pass itself
    takes the count on the card, so that slot j past it writes only its
    trash rows and a level that selects nothing leaves the tree, the leaf
    ids and the live rows as they were. ``phase`` opens the pass's
    ``pass.*`` spans."""
    sp, L, rows = io.gp.split, st.L, io.rows
    res, sel, idx = st.res, st.sel, st.idx
    with phase("pass.apply"):
        j = st.slots[:width]
        valid = j < st.count
        # slot j: the (j + 1)-th selected leaf in leaf order, else trash
        si = torch.where(valid, torch.searchsorted(idx[:L] + 1, j,
                                                   right=True), L + j)
        nl = torch.where(valid, st.num_leaves + j, L + j)
        trash_node = st.m + j
        nid = torch.where(valid, st.num_leaves - 1 + j, trash_node)
        left, right, outs = split_outputs(res, st.leaf_g, st.leaf_h,
                                          st.leaf_c, st.leaf_min,
                                          st.leaf_max, sp)
        apply_level_fixed(st.tree, st.parent_node, st.parent_right, res, si,
                          nid, nl, valid, trash_node, left, right, outs, sp)
        cat_sel = _membership_leaves(res, sel, sp)
        # ---- CEGB bookkeeping: a split marks its column used, and every
        # in-bag row of the split leaf paid for it ----
        if io.cegb is not None and sp.cegb_coupled:
            cols = torch.arange(io.cegb.feature_used.shape[0],
                                device=sel.device)
            io.cegb.feature_used |= ((res.feature[:, None] == cols)
                                     & sel[:, None]).any(0)
        if io.cegb is not None and sp.cegb_lazy:
            rows.pay_lazy(torch.where(sel, res.feature,
                                      torch.full_like(res.feature, -1)))
        # ---- route tables: slot idx for the smaller child of each
        # selected leaf (under voting slots 2 idx and 2 idx + 1 for both),
        # the sentinel, the pass's slot count, elsewhere ----
        small_is_left = left[2] <= right[2]
        slots = 2 * width if rows.voting else width
        none = torch.full_like(idx, slots)
        if rows.voting:
            slot_l = torch.where(sel, 2 * idx, none)
            slot_r = torch.where(sel, 2 * idx + 1, none)
        else:
            slot_l = torch.where(sel & small_is_left, idx, none)
            slot_r = torch.where(sel & ~small_is_left, idx, none)
        tables = H.RouteTables(
            feat=torch.where(sel, res.feature,
                             torch.full_like(res.feature, -1))[:L],
            thr=res.bin[:L], dleft=res.default_left[:L].to(torch.int32),
            new_leaf=(st.num_leaves + idx)[:L],
            slot_left=slot_l[:L], slot_right=slot_r[:L],
            is_cat=None if cat_sel is None else cat_sel[:L],
            member=(None if cat_sel is None
                    else (res.cat_member & sel[:, None])[:L]))

    with phase("pass.hist"):
        hp = rows.measure(tables, slots,
                          2 * count if rows.voting else count, si, nl)
        if rows.voting:
            st.hist[si] = hp[0::2]
            st.hist[nl] = hp[1::2]
        else:
            sib = st.hist[si] - hp
            sl = small_is_left[si][:, None, None, None]
            st.hist[si] = torch.where(sl, hp, sib)
            st.hist[nl] = torch.where(sl, sib, hp)

    with phase("pass.apply"):
        (lg, lh, lc), (rg, rh, rc), (w_l, w_r, _) = left, right, outs
        if sp.has_monotone:
            lo_l, hi_l, lo_r, hi_r = monotone_child_bounds(
                sp, st.hist.shape[2], res.is_cat[si], res.feature[si],
                w_l[si], w_r[si], st.leaf_min[si], st.leaf_max[si])
            st.leaf_min[si], st.leaf_max[si] = lo_l, hi_l
            st.leaf_min[nl], st.leaf_max[nl] = lo_r, hi_r
        if io.forced is not None:
            fp = torch.clamp(st.forced_ptr, min=0)
            none = torch.full_like(st.forced_ptr, -1)
            nxt_l = torch.where(st.okf, io.forced.left[fp], none)[si]
            nxt_r = torch.where(st.okf, io.forced.right[fp], none)[si]
            st.forced_ptr[si] = nxt_l
            st.forced_ptr[nl] = nxt_r
        for arr, a, b in ((st.leaf_g, lg, rg), (st.leaf_h, lh, rh),
                          (st.leaf_c, lc, rc)):
            arr[si] = a[si]
            arr[nl] = b[si]
        # the frontier: the split leaves and their new siblings (a level
        # that selects nothing keeps the one it had)
        st.active.copy_(torch.where(st.count > 0, sel, st.active))
        st.active.index_fill_(0, nl, True)
        st.parent_node[si] = nid
        st.parent_node[nl] = nid
        st.parent_right.index_fill_(0, si, False)
        st.parent_right.index_fill_(0, nl, True)
        st.num_leaves += st.count

    if next_width is None:
        return 0
    with phase("pass.search"):
        _search(st, io, lvl + 1, next_width)
        return _read_count(st) if read else 0


def capture_engages(dev: torch.device, gp: GrowParams, cegb, forced) -> bool:
    """Whether the serial level pass runs as a captured CUDA graph: on the
    card, where the pass takes no host input that changes from level to
    level and copies nothing from the host. CEGB (its copies), forced
    splits, feature_fraction_bynode and extra_trees (draws keyed on the
    level's number), categorical features and EFB bundles (the membership
    read), monotone constraints and feature_contri (the search's copies of
    their arrays) run the same pass eagerly."""
    sp = gp.split
    return (dev.type == "cuda" and cegb is None and forced is None
            and gp.ff_bynode >= 1.0 and not sp.extra_trees
            and not sp.cat_features and not sp.has_bundles
            and not sp.has_monotone and not sp.has_contri)


class LevelGraphs:
    """A trainer's captured level passes: one CUDA graph per (slot width
    of the pass, slot width of the next search, or None where the pass
    ends the tree's searches), in one memory pool, over one
    ``LevelState`` and one set of pinned row buffers (``LevelRows.pin``).
    ``key`` names what the graphs were captured on (the grow parameters,
    the shapes, and the addresses of the bins and bin tables); another key
    drops them and captures anew. ``captures`` counts the graphs
    captured."""

    def __init__(self):
        self.key = None
        self.state: Optional[LevelState] = None
        self.held: Optional[list] = None
        self.graphs: dict = {}
        self.pool = None
        self.captures = 0

    def state_for(self, key, make, rows: LevelRows) -> LevelState:
        """The state of ``key``, made anew when the key changes, with
        ``rows`` pinned in the buffers the graphs read."""
        if key != self.key:
            self.graphs.clear()
            self.state = self.held = None
            self.key, self.state = key, make()
            self.pool = torch.cuda.graph_pool_handle()
        self.held = rows.pin(self.held)
        return self.state

    def replay(self, key) -> None:
        graph, ran = self.graphs[key]
        graph.replay()
        for k, v in ran.items():
            K.LAUNCHES[k] += v

    def run(self, key, eager, captured, replay_span: str = "") -> None:
        """Replay the graph of ``key``, in a ``replay_span`` span if one is
        named. The first time, run ``eager`` on a side stream (the warm-up
        torch.cuda.graphs documents, here the work itself), then capture
        ``captured``, the same work with no span and no host read. A
        capture records launches and runs none, so the launches the kernel
        wrappers counted during it are taken back, and each replay adds
        them."""
        if key in self.graphs:
            with span(replay_span) if replay_span else nullcontext():
                self.replay(key)
            return
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            eager()
        main.wait_stream(side)
        before = dict(K.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # other threads may use the card meanwhile (a server answering
            # on it while a model trains): only this thread's capture is
            # held to the capture's rules
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                captured()
            finally:
                graph.capture_end()
        main.wait_stream(side)
        self.graphs[key] = (graph, {k: K.LAUNCHES[k] - v
                                    for k, v in before.items()
                                    if K.LAUNCHES[k] != v})
        K.LAUNCHES.update(before)
        self.captures += 1


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
                        fp_tiles=None,
                        graphs: Optional[LevelGraphs] = None
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
    shard runs the kernels on its own rows: its front, each level's pass
    and its leaf sums, with its own quantization scales and dither (the
    row index within the shard), as each shard of the reference's
    shard_map does; the dequantized f32 histograms and the sums are
    summed over the shards and the split search runs once. Under
    ``gp.voting_top_k`` both children of a split are measured (2 slots a
    split) and only the elected features' histograms are summed
    (``voting_exchange``). The leaf ids come back as a list, one [n_s]
    i32 tensor a shard.

    ``fp_tiles`` (feature-parallel, ``parallel/feature_parallel.py``
    ``FeatureTiles``, unquantized only): the root and each level's
    histograms are built tile by tile on the tiles' devices and gathered
    before the search.

    Every case runs ``level_pass`` at each level's slot width
    (``LevelRows`` holds what differs); on one shard in one process
    ``graphs`` (the trainer's ``LevelGraphs``) keeps the passes captured as
    CUDA graphs across trees where ``capture_engages``."""
    if fp_tiles is not None and (gp.quant or shards is not None):
        raise ValueError("feature tiles take the unquantized serial rows")
    sh = as_sharded(shards, bins_T, bins, g, h, c, fused,
                    None if cegb is None else cegb.data_used)
    if sh.shards[0].fused is not None and (
            gp.fused_obj is None or not gp.quant or cegb is not None):
        raise ValueError("the fused front needs gp.quant and gp.fused_obj, "
                         "and no CEGB")
    f, n = sh.shards[0].bins_T.shape
    dev = sh.home
    L, B = gp.num_leaves, gp.max_bin
    sp = gp.split
    max_levels = gp.max_depth if gp.max_depth > 0 else max(1, L - 1)
    widths = level_widths(L, max_levels)
    W = max(widths, default=1)
    rows = LevelRows(sh, feature_mask, num_bins, na_bin, gp, W, fp_tiles)
    io = PassIO(gp, num_bins, na_bin, bundle, forced, cegb, qseed, rows)
    graphed = (graphs is not None and rows.serial
               and capture_engages(dev, gp, cegb, forced))
    with span("grow.front"):
        rows.front(qseed)
        make = partial(LevelState, L, f, B, W, dev)
        if graphed:
            q = rows.quants[0]
            st = graphs.state_for(
                (gp, n, f, dev, sh.shards[0].bins_T.data_ptr(),
                 0 if bins is None else bins.data_ptr(), num_bins.data_ptr(),
                 na_bin.data_ptr(), q is None or q.hq is None), make, rows)
        else:
            st = make()
        # the root's search is the front's, and each level pass ends with
        # the search of the level it made: a search that selects no split
        # opens no pass
        first = widths[0] if widths and L > 1 else None
        if graphed:
            root = partial(begin_tree, st, io, first)
            graphs.run(("root", first), root, root)
        else:
            begin_tree(st, io, first)
        count = _read_count(st) if first is not None else 0

    leaves, passes = 1, 0
    for lvl, width in enumerate(widths):
        if count == 0:
            break
        leaves += count
        nxt = (widths[lvl + 1] if lvl + 1 < len(widths) and leaves < L
               else None)
        with span("grow.pass"):
            passes += 1
            if not graphed:
                count = level_pass(st, io, lvl, width, nxt, count)
                continue
            graphs.run(
                (width, nxt),
                partial(level_pass, st, io, lvl, width, nxt, count,
                        read=False),
                partial(level_pass, st, io, lvl, width, nxt, count,
                        _no_phase, read=False), "pass.replay")
            count = _read_count(st) if nxt is not None else 0

    tree = trim_tree(st.tree, L, leaves)
    lids = [lid.clone() for lid in rows.leaf_ids]
    out_ids = lids if shards is not None else lids[0]
    if not gp.quant:
        return tree, out_ids, passes
    # ---- leaf renewal from exact sums (quantized-training: splits
    # tolerate int8 gains, leaf outputs use exact sums) ----
    with span("grow.leaf_renew"):
        sums = rows.leaf_sums(lids, L)
        w = leaf_output(sums[0], sums[1], sp)
        if sp.has_monotone:
            w = torch.clamp(w, st.leaf_min[:L], st.leaf_max[:L])
        live = torch.arange(L, device=dev) < leaves
        tree = tree._replace(
            leaf_value=torch.where(live, w, tree.leaf_value),
            leaf_weight=torch.where(live, sums[1], tree.leaf_weight),
            leaf_count=torch.where(live, sums[2], tree.leaf_count))
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
    tile. A level reads the host for its selection (``select_level``),
    and for the membership with categorical features or bundles; its tree
    update and frontier are written on the card, as the default grower's
    (``apply_level_fixed``, into trash rows for the parent pointers of the
    slots that have none). Not combined with CEGB, forced splits,
    feature_fraction_bynode or extra_trees (GBDT keeps the default grower
    then). Returns (TreeArrays, leaf_id [N] i32, number of level
    passes).

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

    def measure_tile(s, quant, slot, counts, n_slots, lo, hi):
        """[S, 3, hi - lo, B] f32 histograms of one tile of one shard's
        rows, read in place."""
        if quant is None:
            return K.hist_f32(s.bins_T[lo:hi], s.g, s.h, s.c, slot, n_slots,
                              B, s.bins, counts, col0=lo)
        acc = K.hist_q8(s.bins_T[lo:hi], quant.gq, quant.hq, quant.cq, slot,
                        n_slots, B, s.bins, counts, col0=lo)
        return H.dequant(acc, quant.hq is None, quant.scale_g, quant.scale_h)

    def tiled_search(routed, n_slots, sg, sh, sc, lmin, lmax, in_pass=True):
        """Each slot's best split from the tiles' passes and searches;
        ``routed`` each shard's (slot, counts). In a level pass each
        tile's histograms are a ``pass.hist`` span and its search a
        ``pass.search`` one."""
        def phase(name):
            return span(name) if in_pass else nullcontext()

        best = None
        allow = torch.ones(n_slots, dtype=torch.bool, device=dev)
        for lo, hi, sp_t, bun_t in tiles:
            with phase("pass.hist"):
                hist_t = _hist_allreduce(
                    [measure_tile(s, q, slot, counts, n_slots, lo, hi)
                     for s, q, (slot, counts) in zip(shd.shards, quants,
                                                     routed)],
                    gp, 2, shd.feature_devices)
            with phase("pass.search"):
                res_t = best_split(hist_t, num_bins[lo:hi], na_bin[lo:hi],
                                   sg, sh, sc, feature_mask[lo:hi], sp_t,
                                   allow, bun_t, leaf_min=lmin, leaf_max=lmax)
                res_t = res_t._replace(feature=res_t.feature + lo)
                best = res_t if best is None else fold_best(best, res_t)
        return best

    widths = level_widths(L, max_levels)
    with span("grow.front"):
        quants = [H.make_quant(s.g, s.h, s.c, qseed,
                               const_hess=gp.const_hess)
                  if gp.quant else None for s in shd.shards]
        na_of = _on_devices(na_bin, shd)
        # ---- root: exact stats from one leaf sum, its record from the
        # tiles' natural-order passes ----
        leaf_ids = [torch.zeros(s.bins_T.shape[1], dtype=torch.int32,
                                device=s.device) for s in shd.shards]
        sums0 = _psum([K.leaf_sums(s.g, s.h, s.c, lid, 1)
                       for s, lid in zip(shd.shards, leaf_ids)], gp)
        g0, h0, c0 = sums0[0, 0], sums0[1, 0], sums0[2, 0]
        f32 = dict(dtype=torch.float32, device=dev)
        inf = torch.full((1,), math.inf, **f32)
        rec0 = tiled_search([(None, None)] * len(shd.shards), 1, g0[None],
                            h0[None], c0[None], -inf, inf, in_pass=False)
        rec = SplitResult(*[
            torch.cat([v, torch.full((L - 1,) + v.shape[1:],
                                     NEG_INF if v.is_floating_point() else 0,
                                     dtype=v.dtype, device=dev)])
            for v in rec0])
        leaf_g, leaf_h, leaf_c = (torch.zeros(L, **f32) for _ in range(3))
        leaf_g[0], leaf_h[0], leaf_c[0] = g0, h0, c0
        active = torch.zeros(L, dtype=torch.bool, device=dev)
        active[:1].fill_(True)
        parent_node = torch.full((L,), -1, dtype=torch.int64, device=dev)
        parent_right = torch.zeros(L, dtype=torch.bool, device=dev)
        leaf_min = torch.full((L,), -math.inf, **f32)
        leaf_max = torch.full((L,), math.inf, **f32)
        # a trash row a slot for the tree update's parent pointers
        W = max(widths, default=1)
        tree = empty_tree(L, B, dev, spare=W)
        trash_node = max(L - 1, 1) + torch.arange(W, device=dev)
        tree.leaf_value[0] = leaf_output(g0, h0, sp)
        tree.leaf_weight[0] = h0
        tree.leaf_count[0] = c0
        num_leaves, passes = 1, 0
        # the root's selection is the front's, and each level pass ends
        # with the selection of the next: one that selects no split opens
        # no pass
        step = (select_level(rec, active, sp, L - num_leaves, widths[0])
                if widths and num_leaves < L else None)

    for lvl in range(len(widths)):
        if step is None:
            break
        sel, si, idx_in_lvl = step
        num_sel = int(si.shape[0])
        if num_sel == 0:
            break
        with span("grow.pass"):
            with span("pass.apply"):
                new_leaf = num_leaves + idx_in_lvl
                nid, nl = (num_leaves - 1 + idx_in_lvl)[si], new_leaf[si]
                (lg, lh, lc), (rg, rh, rc), (w_l, w_r, w_p) = split_outputs(
                    rec, leaf_g, leaf_h, leaf_c, leaf_min, leaf_max, sp)
                apply_level_fixed(tree, parent_node, parent_right, rec, si,
                                  nid, nl,
                                  torch.ones_like(si, dtype=torch.bool),
                                  trash_node[:num_sel], (lg, lh, lc),
                                  (rg, rh, rc), (w_l, w_r, w_p), sp)
                cat_sel = _membership_leaves(rec, sel, sp)

                # ---- route tables: both children measured, split i's in
                # slots 2i and 2i + 1 ----
                s_pass = 2 * num_sel
                none = torch.full_like(idx_in_lvl, s_pass)
                tables = H.RouteTables(
                    feat=torch.where(sel, rec.feature,
                                     torch.full_like(rec.feature, -1)),
                    thr=rec.bin, dleft=rec.default_left.to(torch.int32),
                    new_leaf=new_leaf,
                    slot_left=torch.where(sel, 2 * idx_in_lvl, none),
                    slot_right=torch.where(sel, 2 * idx_in_lvl + 1, none),
                    is_cat=cat_sel,
                    member=(None if cat_sel is None
                            else rec.cat_member & sel[:, None]))

            with span("pass.hist"):
                routed = []
                for i, s in enumerate(shd.shards):
                    t_d = _tables_on(tables, s.device)
                    slot, leaf_ids[i], counts = K.route_level(
                        s.bins_T, leaf_ids[i], t_d.stacked(), na_of[i],
                        s_pass, t_d.bitset())
                    routed.append((slot, counts))
                passes += 1

            with span("pass.apply"):
                # ---- monotone bounds, per-leaf stats, frontier ----
                if sp.has_monotone:
                    lo_l, hi_l, lo_r, hi_r = monotone_child_bounds(
                        sp, f, rec.is_cat[si], rec.feature[si], w_l[si],
                        w_r[si], leaf_min[si], leaf_max[si])
                    leaf_min[si], leaf_max[si] = lo_l, hi_l
                    leaf_min[nl], leaf_max[nl] = lo_r, hi_r
                for arr, left, right in ((leaf_g, lg, rg), (leaf_h, lh, rh),
                                         (leaf_c, lc, rc)):
                    arr[si] = left[si]
                    arr[nl] = right[si]
                active = sel.clone()
                active.index_fill_(0, nl, True)
                parent_node[si] = nid
                parent_node[nl] = nid
                parent_right.index_fill_(0, si, False)
                parent_right.index_fill_(0, nl, True)
                num_leaves += num_sel
                slot_leaf = torch.stack([si, nl], dim=1).reshape(s_pass)

            # ---- fresh records of the 2S children from the tiled search,
            # then the next level's selection ----
            child = tiled_search(routed, s_pass, leaf_g[slot_leaf],
                                 leaf_h[slot_leaf], leaf_c[slot_leaf],
                                 leaf_min[slot_leaf], leaf_max[slot_leaf])
            with span("pass.search"):
                for arr, vals in zip(rec, child):
                    arr[slot_leaf] = vals
                step = None
                if lvl + 1 < len(widths) and num_leaves < L:
                    step = select_level(rec, active, sp, L - num_leaves,
                                        widths[lvl + 1])

    out_ids = leaf_ids if shards is not None else leaf_ids[0]
    tree = trim_tree(tree, L, num_leaves)
    if not gp.quant:
        return tree, out_ids, passes
    # ---- leaf renewal from exact sums, as the default grower ----
    with span("grow.leaf_renew"):
        sums = _psum([K.leaf_sums(s.g, s.h, s.c, lid, L)
                      for s, lid in zip(shd.shards, leaf_ids)], gp)
        w = leaf_output(sums[0], sums[1], sp)
        if sp.has_monotone:
            w = torch.clamp(w, leaf_min, leaf_max)
        live = torch.arange(L, device=dev) < num_leaves
        tree = tree._replace(
            leaf_value=torch.where(live, w, tree.leaf_value),
            leaf_weight=torch.where(live, sums[1], tree.leaf_weight),
            leaf_count=torch.where(live, sums[2], tree.leaf_count))
    return tree, out_ids, passes
