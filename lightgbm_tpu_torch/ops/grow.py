"""Tree-growing parameters, the flat device-side tree layout and the
leaf-wise (lossguide) grower.

Port of ``GrowParams`` (:32), ``TreeArrays`` (:129), ``_empty_tree``
(:173) and the serial path of ``grow_tree`` (:195) of
``lightgbm_tpu/ops/grow.py``, numerical and categorical splits, with the
split constraints: monotone bounds (:438-478), forced splits applied
leaf-wise (:308-340, :479-490) and extra_trees keyed by ``_et_key``
(:236-262; the root's tag is L, a split step's children's is the step),
and the histogram pool of ``histogram_pool_size`` (:276-290, :377-420).
CEGB is not supported on this grower (GBDT warns and ignores it, as the
reference does). Internal
node ``i`` is created by split ``i``; child pointers use the reference
encoding: >= 0 an internal node, < 0 ``~leaf``.

Data-parallel growth (``GrowParams.axis_name`` set, reference: :82-126,
:254, :375, :391): the rows come as ``ShardedRows``, one ``RowShard`` a
mesh shard on its device; every kernel runs on each shard's own rows, and
``_psum`` / ``_hist_allreduce`` sum the shards' histograms and sums in
shard order, in f32, on the first shard's device, where the split search
runs once. On a 2-D (data, feature) mesh each feature block is summed on
its own device and the blocks gathered, bit for bit the 1-D sum. When the
data axis spans processes (``GrowParams.processes``), each local sum is
then summed across the ranks (``_xsum``); the histograms are f32 before
that sum, as in the reference (grow_depthwise.py:286-298).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs.tracing import span
from ..utils import threefry
from . import hist_kernels as K
from . import histogram as H
from .scan import blocked_cumsum, tree_sum
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
    # histogram_pool_size (models/gbdt.py sizes both): the leaf-wise
    # grower's cached leaf histograms (0: one a leaf), and the lean
    # depthwise grower's feature tile (0: the whole-frontier grower)
    hist_pool: int = 0
    lean_ft: int = 0
    # voting-parallel (reference: VotingParallelTreeLearner, top_k): the
    # features elected a level for the histogram sum; 0 = off
    voting_top_k: int = 0
    # data-parallel axis of the mesh (reference: :82-88): set, the rows come
    # sharded and every histogram and root or leaf sum is summed over the
    # shards (_psum, _hist_allreduce); the optional feature axis of a 2-D
    # mesh splits each histogram sum into feature_shards blocks
    axis_name: str = ""
    feature_axis_name: str = ""
    feature_shards: int = 1
    # processes the data axis spans (parallel/multihost.py): above one,
    # every shard sum is then summed across the ranks
    processes: int = 1


class RowShard(NamedTuple):
    """One mesh shard's rows on its device: the [F, n] bins and their
    row-major copy, the (g, h, c) rows or the fused front's (score, aux,
    bag), and the shard's block of the CEGB lazy bitset. Padding rows
    carry zero g, h and count (bag 0)."""
    bins_T: torch.Tensor
    bins: Optional[torch.Tensor] = None
    g: Optional[torch.Tensor] = None
    h: Optional[torch.Tensor] = None
    c: Optional[torch.Tensor] = None
    fused: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    data_used: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.bins_T.device

    @property
    def rows(self):
        return (self.g, self.h, self.c)


@dataclass
class ShardedRows:
    """The shards of a data-parallel grow, in mesh order, and the device
    that sums each feature block on a 2-D mesh (empty on a 1-D one)."""
    shards: list
    feature_devices: Tuple[torch.device, ...] = ()

    @property
    def home(self) -> torch.device:
        """The first shard's device: the sums land there and the split
        search runs there."""
        return self.shards[0].device


def as_sharded(shards: Optional[ShardedRows], bins_T, bins=None, g=None,
               h=None, c=None, fused=None, data_used=None) -> ShardedRows:
    """``shards`` as given, or the serial rows as one shard."""
    if shards is not None:
        return shards
    return ShardedRows([RowShard(bins_T, bins, g, h, c, fused, data_used)])


# bytes and calls of the shard sums (mesh runs only): the histogram sums
# and every sum, and apart from them the sums across the ranks (x_*; their
# bytes are one rank's payload); scripts and chip_smoke.py read and reset
# them
ALLREDUCE = {"calls": 0, "bytes": 0, "hist_calls": 0, "hist_bytes": 0,
             "x_calls": 0, "x_bytes": 0, "x_hist_calls": 0,
             "x_hist_bytes": 0}


def reset_allreduce() -> None:
    for k in ALLREDUCE:
        ALLREDUCE[k] = 0


def _sum_parts(parts, device: torch.device) -> torch.Tensor:
    acc = parts[0].to(device=device, dtype=torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(device=device, dtype=torch.float32)
    return acc


def _xsum(t: torch.Tensor, gp: GrowParams, hist: bool = False
          ) -> torch.Tensor:
    """``t`` summed across the ranks when the data axis spans processes
    (``multihost.allreduce_sum``: the same bytes on every rank), else
    ``t``."""
    if gp.processes <= 1:
        return t
    from ..parallel.multihost import allreduce_sum
    nbytes = t.numel() * t.element_size()
    ALLREDUCE["x_calls"] += 1
    ALLREDUCE["x_bytes"] += nbytes
    if hist:
        ALLREDUCE["x_hist_calls"] += 1
        ALLREDUCE["x_hist_bytes"] += nbytes
    return allreduce_sum(t)


def _psum(parts, gp: GrowParams, hist: bool = False) -> torch.Tensor:
    """The shards' tensors summed in shard order, in f32, on the first
    shard's device (the reference's ``psum`` over the data axis), then
    across the ranks; one part in one process is returned as it is."""
    if len(parts) == 1:
        return _xsum(parts[0], gp, hist)
    ALLREDUCE["calls"] += 1
    ALLREDUCE["bytes"] += sum(p.numel() * p.element_size() for p in parts)
    return _xsum(_sum_parts(parts, parts[0].device), gp, hist)


def _hist_allreduce(parts, gp: GrowParams, f_dim: int,
                    feature_devices: Tuple[torch.device, ...] = ()
                    ) -> torch.Tensor:
    """Sum histogram-shaped shard tensors (reference: :105-126). On a 1-D
    mesh a ``_psum``; on a 2-D mesh each feature block of ``F //
    feature_shards`` columns is summed over the shards on its block's
    device and the blocks are gathered on the first shard's device: bit
    for bit the 1-D sum, since the sum is elementwise. Across processes
    each block is then summed across the ranks on its device."""
    if len(parts) == 1:
        return _xsum(parts[0], gp, hist=True)
    ALLREDUCE["hist_calls"] += 1
    ALLREDUCE["hist_bytes"] += sum(p.numel() * p.element_size()
                                   for p in parts)
    k, fdim = gp.feature_shards, parts[0].shape[f_dim]
    if not gp.feature_axis_name or k <= 1 or fdim % k or \
            len(feature_devices) != k:
        return _psum(parts, gp, hist=True)
    ALLREDUCE["calls"] += 1
    ALLREDUCE["bytes"] += sum(p.numel() * p.element_size() for p in parts)
    blk = fdim // k
    home = parts[0].device
    blocks = [_xsum(_sum_parts([p.narrow(f_dim, j * blk, blk)
                                for p in parts], feature_devices[j]),
                    gp, hist=True).to(home) for j in range(k)]
    return torch.cat(blocks, dim=f_dim)


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


def empty_tree(L: int, B: int, device: torch.device,
               spare: int = 0) -> TreeArrays:
    """A tree of no split; ``spare`` more rows on every node and leaf
    array (the fixed-width level pass's trash rows)."""
    m = max(L - 1, 1) + spare
    L = L + spare

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


class ForcedSplits(NamedTuple):
    """The forced-splits tree as flat arrays (reference: ForcedSplits,
    grow_depthwise.py:65-72): each forced node's column and bin, and the
    forced nodes of its children (-1: stop forcing)."""
    feat: torch.Tensor    # [M] i64
    bin: torch.Tensor     # [M] i64
    left: torch.Tensor    # [M] i64
    right: torch.Tensor   # [M] i64


def forced_override(res: SplitResult, forced: ForcedSplits,
                    forced_ptr: torch.Tensor, has_f: torch.Tensor,
                    hist: torch.Tensor, na_bin: torch.Tensor,
                    leaf_c: torch.Tensor) -> Tuple[SplitResult, torch.Tensor]:
    """Forced splits override the search (reference: grow_depthwise.py
    :406-435, grow.py:308-340): a leaf holding a forced node (``has_f``)
    splits on its (column, bin) with gain 1e30, its left stats the prefix
    sums of its histogram at the bin with the missing bin left out, when
    both sides keep a row. Returns (the records, where a forced split
    applies [L] bool). The prefix sums run over the forced columns' rows
    alone, which gives each row's sums in the same order."""
    lv = hist.shape[0]
    b = hist.shape[-1]
    fp = torch.clamp(forced_ptr, min=0)
    ffeat, fbin = forced.feat[fp], forced.bin[fp]
    lidx = torch.arange(lv, device=hist.device)
    rows = hist[lidx, :, ffeat]                                   # [L,3,B]
    na_self = (torch.arange(b, device=hist.device)[None, :]
               == na_bin.to(torch.int64)[ffeat][:, None])          # [L,B]
    cumf = blocked_cumsum(torch.where(na_self[:, None], torch.zeros(
        (), dtype=hist.dtype, device=hist.device), rows))
    flg, flh, flc = (cumf[lidx, ch, fbin] for ch in range(3))
    okf = has_f & (flc >= 1) & (leaf_c - flc >= 1)
    no = torch.zeros_like(res.default_left)
    res = res._replace(
        gain=torch.where(okf, torch.full_like(res.gain, 1e30), res.gain),
        feature=torch.where(okf, ffeat, res.feature),
        bin=torch.where(okf, fbin, res.bin),
        default_left=torch.where(okf, no, res.default_left),
        left_g=torch.where(okf, flg, res.left_g),
        left_h=torch.where(okf, flh, res.left_h),
        left_cnt=torch.where(okf, flc, res.left_cnt),
        is_cat=torch.where(okf, no, res.is_cat),
        cat_member=res.cat_member & ~okf[:, None])
    return res, okf


def extra_trees_key(sp: SplitParams, qseed: Optional[int],
                    tag: int) -> Optional[threefry.Key]:
    """The extra_trees key of one search (reference: grow_depthwise.py
    :392-400, grow.py ``_et_key``): fold_in(fold_in(PRNGKey(extra_seed),
    qseed), tag); None when extra_trees is off."""
    if not sp.extra_trees:
        return None
    return threefry.fold_in(threefry.fold_in(
        threefry.prng_key(sp.extra_seed), qseed or 0), tag)


def monotone_child_bounds(sp: SplitParams, f: int, is_cat: torch.Tensor,
                          feat: torch.Tensor, w_l: torch.Tensor,
                          w_r: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor):
    """The output bounds of a split's (left, right) children (reference:
    ``_monotone_child_bounds``, grow_depthwise.py:143-163): each inherits
    its parent's; a split on a constrained column pins the midpoint of
    the two outputs as the bound between them. Returns (left min, left
    max, right min, right max), shaped like ``w_l``."""
    mono = sp.monotone_array(f, feat.device)
    if feat.dim() == 0:
        # a leaf-wise step's 0-d index: indexing reads it on the host
        with span("sync.monotone"):
            mono_f = mono[feat]
    else:
        mono_f = mono[feat]
    mf = torch.where(is_cat, torch.zeros_like(feat), mono_f)
    mid = (w_l + w_r) / 2.0
    return (torch.where(mf < 0, torch.maximum(lo, mid), lo),
            torch.where(mf > 0, torch.minimum(hi, mid), hi),
            torch.where(mf > 0, torch.maximum(lo, mid), lo),
            torch.where(mf < 0, torch.minimum(hi, mid), hi))


def grow_tree(bins_T: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor, num_bins: torch.Tensor, na_bin: torch.Tensor,
              feature_mask: torch.Tensor, gp: GrowParams,
              bins: Optional[torch.Tensor] = None,
              qseed: Optional[int] = None,
              bundle: Optional[BundleArrays] = None,
              forced=None, shards: Optional[ShardedRows] = None
              ) -> Tuple[TreeArrays, torch.Tensor, int, int]:
    """Grow one tree leaf-wise (best-first), unquantized.

    bins_T [F, N] u8 on the device; g/h/c [N] f32 grad/hess/in-bag count
    rows (already masked by the bag); num_bins / na_bin [F] i32 (na_bin >=
    B means no missing bin); feature_mask [F] bool; bins the row-major
    [N, F] copy of bins_T, which the split passes' slot histogram needs on
    the card; ``bundle`` the EFB arrays when ``gp.split.has_bundles``;
    ``forced`` the forced-splits tree (``ForcedSplits``).
    Returns (TreeArrays, leaf_id [N] i32, number of split passes, number
    of pool rebuilds).

    Each split step t takes the leaf with the best gain (the first on
    ties, as ``jnp.argmax``), partitions its rows with a vectorized
    ``where`` on the leaf ids (by threshold, or by membership for a
    categorical or bundle split), builds the smaller child's histogram
    with one ``hist_f32`` pass over a slot vector (the smaller child's
    rows in slot 0, every other row dropped: the reference's masked
    full-width pass) and the sibling's by subtraction from the parent,
    then searches both children's best splits at once. Node t is created
    by step t and its right child is leaf t + 1. The reference runs the
    L - 1 steps in one ``lax.scan``; here the step loop runs on the host and
    reads the chosen leaf and its "can split" flag once a step. A step
    blocks the host on the card four or five times: that read, the
    chosen gain's 0-d index, and the node's pointers written as Python
    ints; each sits in a ``sync.*`` span (``obs/tracing.py``).

    With ``gp.hist_pool`` = P < L (and no forced splits, which keep every
    histogram resident, reference :278) at most P leaf histograms are
    cached, in least-recently-written slots (reference: HistogramPool,
    :276-290, :377-420): the left child takes its parent's slot when the
    parent's histogram is cached, else the oldest slot, and the right child
    the oldest slot left (the lower index first on equal age, as argmin);
    a parent whose histogram was evicted is rebuilt by one more hist_f32
    pass with its pre-split rows in slot 0. The pool's bookkeeping lives on
    the host: it follows from the chosen leaves alone.

    ``shards`` (data-parallel): the rows as ``ShardedRows`` (bins_T, g,
    h, c and bins are then unused); each shard builds its histograms and
    partitions its own rows, and the leaf ids come back as a list, one
    [n_s] i32 tensor a shard."""
    sh = as_sharded(shards, bins_T, bins, g, h, c)
    f = sh.shards[0].bins_T.shape[0]
    dev = sh.home
    fdev = sh.feature_devices
    L, B = gp.num_leaves, gp.max_bin
    sp = gp.split
    def choose():
        """The step's choice: (the records with any forced split applied,
        the leaf to split, whether it can split)."""
        nonlocal forced_ptr
        best_eff = best
        if forced is not None:
            # a leaf holding a forced node splits on it first (gain 1e30);
            # a degenerate forced split stops forcing at that leaf
            has_f = forced_ptr >= 0
            best_eff, okf = forced_override(best, forced, forced_ptr, has_f,
                                            hist, na_bin, leaf_c)
            forced_ptr = torch.where(has_f & ~okf,
                                     torch.full_like(forced_ptr, -1),
                                     forced_ptr)
        lt = torch.argmax(best_eff.gain)
        # a 0-d index tensor: indexing reads it on the host
        with span("sync.step_index"):
            ok = best_eff.gain[lt] > NEG_INF / 2
        # the one intended sync a step: the host picks the leaf to split
        # and stops when none can
        with span("sync.step"):
            # tpu-lint: disable=host-sync-in-jit
            l, can_split = torch.stack([lt, ok.to(lt.dtype)]).tolist()
        return best_eff, l, can_split

    with span("grow.front"):
        hist0 = _hist_allreduce([H.hist_leaf(s.bins_T, B, rows=s.rows)
                                 for s in sh.shards], gp, 1, fdev)
        g0, h0, c0 = tree_sum(hist0[0, 0]), tree_sum(hist0[1, 0]), \
            tree_sum(hist0[2, 0])
        ones = torch.ones(2, dtype=torch.bool, device=dev)
        best0 = best_split(hist0[None], num_bins, na_bin, g0[None], h0[None],
                           c0[None],
                           node_feature_mask(feature_mask, gp, qseed, L),
                           sp, ones[:1], bundle,
                           rand_key=extra_trees_key(sp, qseed, L))

        def tile(x: torch.Tensor, fill) -> torch.Tensor:
            out = torch.full((L,), fill, dtype=x.dtype, device=dev)
            out[0] = x[0]
            return out

        member0 = torch.zeros((L, B), dtype=torch.bool, device=dev)
        member0[0] = best0.cat_member[0]
        best = SplitResult(
            gain=tile(best0.gain, NEG_INF), feature=tile(best0.feature, 0),
            bin=tile(best0.bin, 0),
            default_left=tile(best0.default_left, False),
            left_g=tile(best0.left_g, 0.0), left_h=tile(best0.left_h, 0.0),
            left_cnt=tile(best0.left_cnt, 0.0),
            is_cat=tile(best0.is_cat, False), cat_member=member0)
        # the histogram pool: P cached slots, each leaf's slot (-1:
        # evicted), each slot's leaf (-1: free) and the step that last
        # wrote it
        P = gp.hist_pool if 0 < gp.hist_pool < L and forced is None else L
        pooled = P < L
        hist = torch.zeros((P, 3, f, B), dtype=torch.float32, device=dev)
        hist[0] = hist0
        slot_of_leaf = [0] + [-1] * (L - 1)
        leaf_of_slot = [0] + [-1] * (P - 1)
        slot_age = [0] * P
        rebuilds = 0
        leaf_g, leaf_h, leaf_c = (torch.zeros(L, dtype=torch.float32,
                                              device=dev) for _ in range(3))
        leaf_g[0], leaf_h[0], leaf_c[0] = g0, h0, c0
        tree = empty_tree(L, B, dev)
        leaf_ids = [torch.zeros(s.bins_T.shape[1], dtype=torch.int32,
                                device=s.device) for s in sh.shards]
        # monotone output bounds and forced-node pointers of the leaves
        leaf_min = torch.full((L,), -float("inf"), device=dev)
        leaf_max = torch.full((L,), float("inf"), device=dev)
        forced_ptr = torch.full((L,), -1, dtype=torch.int64, device=dev)
        if forced is not None:
            with span("sync.forced"):
                forced_ptr[0] = 0
        # host-side bookkeeping: every entry follows from the chosen leaves
        depth = [0] * L
        parent_node = [-1] * L
        parent_right = [False] * L
        num_leaves = 1
        # the root's choice is the front's, and each step ends with the
        # choice of the next: a choice that finds no split opens no pass
        step = choose() if L > 1 else None

    for t in range(L - 1):
        best_eff, l, can_split = step
        if not can_split:
            break
        new_leaf = t + 1
        with span("grow.pass"):
            with span("pass.hist"):
                feat = best_eff.feature[l]

                # ---- partition rows (DataPartition::Split: a where on
                # leaf_id), each shard its own ----
                split_rec = (feat.view(1),
                             na_bin.index_select(0, feat.view(1)),
                             best_eff.default_left[l], best_eff.bin[l],
                             best_eff.is_cat[l], best_eff.cat_member[l])
                for i, s in enumerate(sh.shards):
                    ft, na_f, dl, thr, isc, mem = (x.to(s.device)
                                                   for x in split_rec)
                    col = s.bins_T.index_select(0, ft)[0].to(torch.int32)
                    go_right = torch.where(col == na_f, ~dl, col > thr)
                    if sp.cat_features or sp.has_bundles:
                        # a categorical or bundle split sends its member
                        # bins left (reference: grow.py:355-358)
                        go_right = torch.where(isc, ~mem[col.long()],
                                               go_right)
                    leaf_ids[i] = torch.where((leaf_ids[i] == l) & go_right,
                                              new_leaf, leaf_ids[i])

                # ---- child stats ----
                lg, lh, lc = (best_eff.left_g[l], best_eff.left_h[l],
                              best_eff.left_cnt[l])
                pg, ph, pc = leaf_g[l], leaf_h[l], leaf_c[l]
                rg, rh, rc = pg - lg, ph - lh, pc - lc

                # ---- smaller-child histogram + sibling by subtraction ----
                small_is_left = lc <= rc
                small_leaf = torch.where(small_is_left, l, new_leaf)
                hist_small = _hist_allreduce([
                    K.hist_f32(s.bins_T, s.g, s.h, s.c,
                               (lid != small_leaf.to(s.device)).to(
                                   torch.int32), 1, B, s.bins)[0]
                    for s, lid in zip(sh.shards, leaf_ids)], gp, 1, fdev)
                if not pooled:
                    hist_parent = hist[l]
                elif slot_of_leaf[l] >= 0:
                    hist_parent = hist[slot_of_leaf[l]]
                else:
                    # the parent was evicted: one pass over its pre-split
                    # rows
                    hist_parent = _hist_allreduce([
                        K.hist_f32(s.bins_T, s.g, s.h, s.c,
                                   (~((lid == l) | (lid == new_leaf))).to(
                                       torch.int32), 1, B, s.bins)[0]
                        for s, lid in zip(sh.shards, leaf_ids)], gp, 1, fdev)
                    rebuilds += 1
                hist_large = hist_parent - hist_small
                hist_left = torch.where(small_is_left, hist_small, hist_large)
                hist_right = torch.where(small_is_left, hist_large,
                                         hist_small)
                if pooled:
                    slot_l, slot_r = _pool_slots(slot_of_leaf[l], slot_age)
                    for sl, leaf in ((slot_l, l), (slot_r, new_leaf)):
                        if leaf_of_slot[sl] >= 0:
                            slot_of_leaf[leaf_of_slot[sl]] = -1
                        leaf_of_slot[sl] = leaf
                        slot_of_leaf[leaf] = sl
                        slot_age[sl] = t + 1
                else:
                    slot_l, slot_r = l, new_leaf
                hist[slot_l] = hist_left
                hist[slot_r] = hist_right

            with span("pass.apply"):
                # ---- tree arrays (node t) ----
                # the node's pointers are Python ints written into device
                # tensors: each a blocking copy
                par = parent_node[l]
                if par >= 0:
                    with span("sync.node"):
                        (tree.right_child if parent_right[l]
                         else tree.left_child)[par] = t
                with span("sync.node"):
                    tree.left_child[t] = ~l
                with span("sync.node"):
                    tree.right_child[t] = ~new_leaf
                tree.split_feature[t] = feat
                tree.threshold_bin[t] = best_eff.bin[l]
                tree.default_left[t] = best_eff.default_left[l]
                tree.split_gain[t] = best_eff.gain[l]
                tree.is_cat[t] = best_eff.is_cat[l]
                tree.cat_mask[t] = best_eff.cat_member[l]
                # (pg, ph, pc are views of the leaf stats rewritten below)
                w_l, w_r = leaf_output(lg, lh, sp), leaf_output(rg, rh, sp)
                w_p = leaf_output(pg, ph, sp)
                if sp.has_monotone:
                    # outputs clamped to the parent's bounds; the
                    # children's bounds pin the midpoint on a constrained
                    # column
                    lo, hi = leaf_min[l].clone(), leaf_max[l].clone()
                    w_l, w_r, w_p = (torch.clamp(w, lo, hi)
                                     for w in (w_l, w_r, w_p))
                    lo_l, hi_l, lo_r, hi_r = monotone_child_bounds(
                        sp, f, best_eff.is_cat[l], feat, w_l, w_r, lo, hi)
                    leaf_min[l], leaf_max[l] = lo_l, hi_l
                    leaf_min[new_leaf], leaf_max[new_leaf] = lo_r, hi_r
                if forced is not None:
                    # the forced pointer moves to the children
                    fnode = torch.clamp(forced_ptr[l], min=0)
                    applied = forced_ptr[l] >= 0
                    fl_next = torch.where(applied, forced.left[fnode], -1)
                    fr_next = torch.where(applied, forced.right[fnode], -1)
                    forced_ptr[l], forced_ptr[new_leaf] = fl_next, fr_next
                tree.internal_value[t] = w_p
                tree.internal_weight[t] = ph
                tree.internal_count[t] = pc
                for arr, left, right in ((tree.leaf_value, w_l, w_r),
                                         (tree.leaf_weight, lh, rh),
                                         (tree.leaf_count, lc, rc),
                                         (leaf_g, lg, rg), (leaf_h, lh, rh),
                                         (leaf_c, lc, rc)):
                    arr[l] = left
                    arr[new_leaf] = right
                d = depth[l] + 1
                depth[l] = depth[new_leaf] = d
                parent_node[l] = parent_node[new_leaf] = t
                parent_right[l], parent_right[new_leaf] = False, True
                num_leaves += 1

            with span("pass.search"):
                # ---- best splits of the two children (batched), then
                # the next step's choice ----
                allow = ones if gp.max_depth <= 0 or d < gp.max_depth \
                    else ~ones
                lmin = lmax = None
                if sp.has_monotone:
                    # indexing by a host list: each a blocking copy
                    with span("sync.monotone"):
                        lmin = leaf_min[[l, new_leaf]]
                    with span("sync.monotone"):
                        lmax = leaf_max[[l, new_leaf]]
                ch_mask = node_feature_mask(feature_mask.expand(2, f), gp,
                                            qseed, t)
                bs = best_split(
                    torch.stack([hist_left, hist_right]), num_bins, na_bin,
                    torch.stack([lg, rg]), torch.stack([lh, rh]),
                    torch.stack([lc, rc]), ch_mask, sp, allow, bundle,
                    leaf_min=lmin, leaf_max=lmax,
                    rand_key=extra_trees_key(sp, qseed, t))
                for arr, vals in zip(best, bs):
                    arr[l] = vals[0]
                    arr[new_leaf] = vals[1]
                step = choose() if t + 1 < L - 1 else None

    if num_leaves == 1:
        # single-leaf tree: constant output
        tree.leaf_value[0] = leaf_output(g0, h0, sp)
        tree.leaf_weight[0] = h0
        tree.leaf_count[0] = c0
    return (tree._replace(num_leaves=num_leaves),
            leaf_ids if shards is not None else leaf_ids[0], num_leaves - 1,
            rebuilds)


def _pool_slots(slot_p: int, slot_age: list) -> Tuple[int, int]:
    """The pool slots of a split's (left, right) children (reference:
    grow.py:400-412): with the parent's histogram cached in slot_p the
    left child takes it and the right child the oldest other slot; else
    the two oldest slots, the lower index first on equal age."""
    order = sorted((age, i) for i, age in enumerate(slot_age) if i != slot_p)
    if slot_p >= 0:
        return slot_p, order[0][1]
    return order[0][1], order[1][1]
