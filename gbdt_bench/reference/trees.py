"""Depthwise trees on quantized gradients, grown and judged in plain PyTorch.

The semantics are those of the program's documented depthwise grower with
quantized gradients (LightGBM's quantized training on a level-wise
schedule):

- Each tree quantizes its gradients and hessians once: scale = max |x|,
  q = clip(floor(x * (127 / scale) + u), -127, 127), with u in [0, 1) a
  counter hash of (row index, tree index, channel) (``dither``). The split
  search reads the sums of q times scale / 127.
- Level by level, every leaf made by the level before (the root first)
  finds its best split: numeric thresholds "bin <= t goes left", both sides
  holding at least ``min_data_in_leaf`` rows and ``min_sum_hessian_in_leaf``
  hessian, gain G_l^2 / H_l + G_r^2 / H_r - G^2 / H. The leaves with a
  positive gain split, the largest gains first, as many as the leaf budget
  ``num_leaves`` still allows; the others stay leaves for good.
- A leaf's value is -G / H over its rows' exact f32 gradients, times the
  learning rate; the first tree also carries the initial score.

``judge_tree`` follows a tree that the program grew, level by level, and
reads how far each of its choices lies from the reference's; ``grow_tree``
grows the reference's own (the control, at a lower precision). Node
numbering is the program's: internal nodes 0.., a child < 0 is the leaf ~c.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

M32 = 0xFFFFFFFF
NO_GAIN = -float("inf")
# half-width, relative to the gain's terms, of the band in which a gain is
# zero within f32 rounding
TIE = 1e-5
# the program keeps a node's sums of g and h in f32, the larger child's as
# the parent's minus the smaller's, so a sum at depth d carries up to
# about (d + 2) roundings of 2^-24 of the root's magnitude, twice over
SLACK = 2.0 * 2.0 ** -24


@dataclass
class Tree:
    """One tree as plain arrays (host numpy)."""
    feature: np.ndarray          # [L-1] raw column of each internal node
    threshold: np.ndarray        # [L-1] bin: <= goes left
    left: np.ndarray             # [L-1] child: >= 0 node, < 0 ~leaf
    right: np.ndarray
    leaf_value: np.ndarray       # [L] f32, shrunk (the first with the bias)
    leaf_count: np.ndarray       # [L]
    internal_count: np.ndarray   # [L-1]
    num_leaves: int


@dataclass
class GrowParams:
    num_leaves: int
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    learning_rate: float


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def dither(n: int, seed: int, salt: int, device) -> torch.Tensor:
    """[n] f32 uniforms in [0, 1) from a counter hash of the row index."""
    i = (torch.arange(n, dtype=torch.int64, device=device)
         + ((salt * 0x632BE59B) & M32)) & M32
    z = _mul32(i ^ ((int(seed) * 0x9E3779B9) & M32), 2654435761)
    z = _mul32(z ^ (z >> 15), 2246822519)
    z = z ^ (z >> 13)
    return (z >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize(x: torch.Tensor, seed: int, salt: int):
    """(q [N] f64 integers in [-127, 127], scale / 127 as f64)."""
    scale = torch.clamp(x.abs().max(), min=1e-20)
    mul = torch.div(torch.full_like(scale, 127.0), scale)
    q = torch.clamp(torch.floor(x * mul + dither(x.shape[0], seed, salt,
                                                 x.device)), -127.0, 127.0)
    return q.to(torch.float64), float(scale) / 127.0


def _position_depths(tree: Tree):
    """Depth of every internal node and every leaf."""
    nd = np.zeros(max(tree.num_leaves - 1, 0), dtype=np.int64)
    ld = np.zeros(tree.num_leaves, dtype=np.int64)
    if tree.num_leaves <= 1:
        return nd, ld
    stack = [(0, 0)]
    while stack:
        node, d = stack.pop()
        nd[node] = d
        for c in (int(tree.left[node]), int(tree.right[node])):
            if c >= 0:
                stack.append((c, d + 1))
            else:
                ld[~c] = d + 1
    return nd, ld


class LevelSearch:
    """The split search over the quantized sums of the rows at a set of
    positions (per row: a position id, -1 for rows outside)."""

    def __init__(self, bins_T: torch.Tensor, num_bins: torch.Tensor,
                 gq, hq, sg: float, sh: float, count: torch.Tensor,
                 gp: GrowParams, cols: Optional[torch.Tensor] = None):
        self.bins_T, self.num_bins = bins_T, num_bins
        self.cols = cols
        self.chans = (gq, hq, count.to(torch.float64))
        self.sg, self.sh, self.gp = sg, sh, gp
        self.B = int(num_bins.max())

    def histograms(self, slot: torch.Tensor, n_slots: int) -> torch.Tensor:
        """[S, 3, F, B] f64 sums of (gq, hq, count) by slot, feature, bin."""
        f, _ = self.bins_T.shape
        B = self.B
        keep = slot >= 0
        s = slot[keep]
        out = torch.zeros((n_slots, 3, f, B), dtype=torch.float64,
                          device=slot.device)
        chans = [c[keep] for c in self.chans]
        for j in range(f):
            key = s * B + self.bins_T[j][keep].to(torch.int64)
            for c, w in enumerate(chans):
                out[:, c, j, :] = torch.bincount(
                    key, weights=w, minlength=n_slots * B).view(n_slots, B)
        return out

    def gains(self, hist: torch.Tensor, slack_g: float = 0.0,
              slack_h: float = 0.0):
        """(([S, F, B] gain of every threshold and its least and most
        within a slack, the absolute rounding that the sums of g and h may
        carry), [S] parent (g, h, count)). NO_GAIN where a threshold is not
        allowed within the slack, and in the least also where it is not
        allowed for sure."""
        gp = self.gp
        cum = torch.cumsum(hist, dim=3)
        pg = hist[:, 0, 0, :].sum(dim=1) * self.sg
        ph = hist[:, 1, 0, :].sum(dim=1) * self.sh
        pc = hist[:, 2, 0, :].sum(dim=1)
        lg, lh, lc = cum[:, 0] * self.sg, cum[:, 1] * self.sh, cum[:, 2]
        rg, rh, rc = (pg[:, None, None] - lg, ph[:, None, None] - lh,
                      pc[:, None, None] - lc)
        eps = 1e-38
        gain = (lg * lg / (lh + eps) + rg * rg / (rh + eps)
                - (pg * pg / (ph + eps))[:, None, None])
        t = torch.arange(self.B, device=hist.device)[None, None, :]
        base = ((t < (self.num_bins[None, :, None] - 1))
                & (lc >= gp.min_data_in_leaf) & (rc >= gp.min_data_in_leaf))
        if self.cols is not None:
            base = base & self.cols[None, :, None]
        m = gp.min_sum_hessian_in_leaf
        loose = base & (lh + slack_h >= m) & (rh + slack_h >= m)
        neg = torch.full_like(gain, NO_GAIN)
        sure = base & (lh - slack_h >= m) & (rh - slack_h >= m)
        # how far each side's g^2 / h moves when g and h move by the slack
        err = sum(2.0 * (g / (h + eps)).abs() * slack_g
                  + (g / (h + eps)) ** 2 * slack_h
                  for g, h in ((lg, lh), (rg, rh)))
        return (torch.where(loose, gain, neg),
                torch.where(sure, gain - err, neg),
                torch.where(loose, gain + err, neg)), (pg, ph, pc)


def _leaf_sums(leaf: torch.Tensor, L: int, g: torch.Tensor, h: torch.Tensor):
    """Each leaf's exact (f64) sums of the rows' f32 g and h."""
    f64 = torch.float64
    return (torch.bincount(leaf, weights=g.to(f64), minlength=L),
            torch.bincount(leaf, weights=h.to(f64), minlength=L))


def leaf_values(G, H, lr: float, bias: float) -> torch.Tensor:
    w = (-G / (H + 1e-38)).to(torch.float32)
    return w * torch.tensor(lr, dtype=torch.float32, device=G.device) + bias


def route(tree: Tree, bins_T: torch.Tensor) -> torch.Tensor:
    """Each row's leaf [N] i64."""
    n = bins_T.shape[1]
    dev = bins_T.device
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    feat = torch.as_tensor(tree.feature, dtype=torch.int64, device=dev)
    thr = torch.as_tensor(tree.threshold, dtype=torch.int64, device=dev)
    left = torch.as_tensor(tree.left, dtype=torch.int64, device=dev)
    right = torch.as_tensor(tree.right, dtype=torch.int64, device=dev)
    depth = int(_position_depths(tree)[1].max())
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(depth):
        at = node.clamp(min=0)
        b = bins_T.gather(0, feat[at][None, :])[0].to(torch.int64)
        nxt = torch.where(b <= thr[at], left[at], right[at])
        node = torch.where(node >= 0, nxt, node)
    return ~node


def judge_tree(tree: Tree, bins_T: torch.Tensor, num_bins: torch.Tensor,
               g: torch.Tensor, h: torch.Tensor, qseed: int, gp: GrowParams,
               bias: float, bag: Optional[torch.Tensor] = None,
               cols: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Follow a grown tree level by level on the reference's own
    quantized gradients. Readings: the largest shortfall of a chosen
    split's gain from the best, relative to the size of the terms the gain
    is the difference of, G^2 / H + the best gain (``split_gap``; 1e30 for
    a split the search does not allow), the splits a level made outside
    those the budget and the gains call for, a gain within ``TIE`` of those
    terms counting as either (``split_count_gap``). Both take each gain,
    and each side's ``min_sum_hessian_in_leaf``, within the rounding that
    the program's f32 node sums carry (``SLACK``): the chosen split at its
    most, the best at its least. Then the largest
    relative gap of a leaf value from -G / H (``leaf_gap``, each leaf
    against the larger of its own and the tree's median |value|), and the
    rows a node or leaf counts against the rows routed there
    (``count_mismatch``). ``bag`` [N] (1 in the bag, 0 out) and ``cols``
    [F] bool (the columns searched) are the iteration's draws; all rows
    and columns when None."""
    n = bins_T.shape[1]
    dev = bins_T.device
    inbag = torch.ones(n, device=dev) if bag is None else (bag > 0).to(
        torch.float32)
    g, h = g * inbag, h * inbag
    gq, sg = quantize(g, qseed, 1)
    hq, sh = quantize(h, qseed, 2)
    search = LevelSearch(bins_T, num_bins, gq, hq, sg, sh, inbag, gp, cols)
    # the magnitudes of the root's sums, which the program's node sums
    # carry their rounding from
    root_g = float((gq.abs() * inbag).sum()) * sg
    root_h = float((hq * inbag).sum()) * sh
    L = tree.num_leaves
    node_depth, leaf_depth = _position_depths(tree)
    split_gap, count_gap, count_mis = 0.0, 0, 0
    # a row's position: internal node k >= 0, or leaf l as ~l
    pos = torch.zeros(n, dtype=torch.int64, device=dev) if L > 1 else \
        torch.full((n,), ~0, dtype=torch.int64, device=dev)
    leaves = 1
    d = 0
    while True:
        nodes = [k for k in range(L - 1) if node_depth[k] == d]
        lvs = [l for l in range(L) if leaf_depth[l] == d]
        if not nodes and not lvs:
            break
        budget = gp.num_leaves - leaves
        if nodes or budget > 0:
            codes = nodes + [~l for l in lvs]
            table = {c: i for i, c in enumerate(codes)}
            lut = torch.full((L - 1 + L + 1,), -1, dtype=torch.int64,
                             device=dev)
            for c, i in table.items():
                lut[c if c >= 0 else (L - 1) + (~c)] = i
            slot = lut[torch.where(pos >= 0, pos, (L - 1) + (~pos))]
            hist = search.histograms(slot, len(codes))
            slack = SLACK * (d + 2)
            (gains, low, high), (pg, ph, _) = search.gains(
                hist, slack * root_g, slack * root_h)
            best = gains.flatten(1).max(dim=1).values.cpu().numpy()
            best_low = low.flatten(1).max(dim=1).values.cpu().numpy()
            best_high = high.flatten(1).max(dim=1).values.cpu().numpy()
            # the gain is a difference of terms about this large, which is
            # what its rounding scales with
            size = (pg * pg / (ph + 1e-38)).cpu().numpy() + np.maximum(best,
                                                                      0.0)
            size = np.maximum(size, 1e-300)
            for i, k in enumerate(nodes):
                chosen = float(high[i, int(tree.feature[k]),
                                    int(tree.threshold[k])])
                if chosen == NO_GAIN:
                    split_gap = max(split_gap, 1e30)
                else:
                    split_gap = max(split_gap,
                                    max(best_low[i] - chosen, 0.0) / size[i])
            # a candidate whose gain is 0 within rounding may go either way
            lo = int(min((best_low > TIE * size).sum(), max(budget, 0)))
            hi = int(min((best_high > -TIE * size).sum(), max(budget, 0)))
            count_gap += max(0, lo - len(nodes)) + max(0, len(nodes) - hi)
            if nodes:
                k_of = torch.as_tensor(nodes, dtype=torch.int64, device=dev)
                feat = torch.as_tensor(tree.feature, dtype=torch.int64,
                                       device=dev)[k_of]
                thr = torch.as_tensor(tree.threshold, dtype=torch.int64,
                                      device=dev)[k_of]
                lft = torch.as_tensor(tree.left, dtype=torch.int64,
                                      device=dev)[k_of]
                rgt = torch.as_tensor(tree.right, dtype=torch.int64,
                                      device=dev)[k_of]
                inner = (slot >= 0) & (slot < len(nodes))
                s = slot.clamp(0, len(nodes) - 1)
                b = bins_T.gather(0, feat[s][None, :])[0].to(torch.int64)
                moved = torch.where(b <= thr[s], lft[s], rgt[s])
                seen = torch.bincount(slot[inner], weights=inbag[inner],
                                      minlength=len(nodes)).round()
                count_mis += int(np.abs(seen.cpu().numpy() - np.asarray(
                    tree.internal_count)[nodes]).sum())
                pos = torch.where(inner, moved, pos)
        leaves += len(nodes)
        d += 1
    leaf = ~pos
    G, H = _leaf_sums(leaf, L, g, h)
    C = torch.bincount(leaf, weights=inbag.to(torch.float64), minlength=L)
    ref = leaf_values(G, H, gp.learning_rate, 0.0).cpu().numpy() \
        .astype(np.float64)
    got = tree.leaf_value[:L].astype(np.float64) - bias
    scale = np.maximum(np.abs(ref), np.median(np.abs(ref)))
    leaf_gap = float(np.max(np.abs(got - ref) / np.maximum(scale, 1e-30)))
    count_mis += int(np.abs(C.cpu().numpy() - tree.leaf_count[:L]).sum())
    return dict(split_gap=float(split_gap), split_count_gap=count_gap,
                leaf_gap=leaf_gap, count_mismatch=count_mis)


def grow_tree(bins_T: torch.Tensor, num_bins: torch.Tensor, g: torch.Tensor,
              h: torch.Tensor, qseed: int, gp: GrowParams, bias: float,
              row_keep: Optional[torch.Tensor] = None,
              cols: Optional[torch.Tensor] = None) -> Tree:
    """Grow one tree by the semantics above. ``row_keep`` [N] f32 weights
    the rows' counts and gradients (all ones when None: a bag, or a
    planted fault that leaves rows out); ``cols`` the columns searched."""
    n = bins_T.shape[1]
    dev = bins_T.device
    L = gp.num_leaves
    keep = torch.ones(n, device=dev) if row_keep is None else row_keep
    gk, hk = g * keep, h * keep
    gq, sg = quantize(gk, qseed, 1)
    hq, sh = quantize(hk, qseed, 2)
    search = LevelSearch(bins_T, num_bins, gq, hq, sg, sh, keep, gp, cols)
    feature = np.zeros(max(L - 1, 1), dtype=np.int64)
    threshold = np.zeros_like(feature)
    left = np.zeros_like(feature)
    right = np.zeros_like(feature)
    internal_count = np.zeros(max(L - 1, 1))
    parent = np.full(L, -1)
    parent_right = np.zeros(L, dtype=bool)
    leaf = torch.zeros(n, dtype=torch.int64, device=dev)
    active = [0]
    num_leaves = 1
    while active and num_leaves < L:
        lut = torch.full((L,), -1, dtype=torch.int64, device=dev)
        for i, l in enumerate(active):
            lut[l] = i
        hist = search.histograms(lut[leaf], len(active))
        (gains, _, _), (_, _, pc) = search.gains(hist)
        flat = gains.flatten(1)
        best, arg = flat.max(dim=1)
        best, arg = best.cpu().numpy(), arg.cpu().numpy()
        B = gains.shape[2]
        cands = [i for i in range(len(active)) if best[i] > 0]
        # the largest gains first, ties to the lower leaf
        cands.sort(key=lambda i: (-best[i], active[i]))
        chosen = sorted(cands[:L - num_leaves], key=lambda i: active[i])
        if not chosen:
            break
        new_active = []
        for j, i in enumerate(chosen):
            si = active[i]
            nid, nl = num_leaves - 1 + j, num_leaves + j
            f, t = divmod(int(arg[i]), B)
            feature[nid], threshold[nid] = f, t
            if parent[si] >= 0:
                if parent_right[si]:
                    right[parent[si]] = nid
                else:
                    left[parent[si]] = nid
            left[nid], right[nid] = ~si, ~nl
            internal_count[nid] = float(pc[i])
            parent[si], parent_right[si] = nid, False
            parent[nl], parent_right[nl] = nid, True
            rows = (leaf == si) & (bins_T[f].to(torch.int64) > t)
            leaf = torch.where(rows, nl, leaf)
            new_active += [si, nl]
        num_leaves += len(chosen)
        active = sorted(new_active)
    G, H = _leaf_sums(leaf, L, gk, hk)
    C = torch.bincount(leaf, weights=keep.to(torch.float64), minlength=L)
    lv = leaf_values(G, H, gp.learning_rate, bias).cpu().numpy()
    return Tree(feature, threshold, left, right, lv, C.cpu().numpy(),
                internal_count, num_leaves)


def tree_scores(trees: List[Tree], bins_T: torch.Tensor, bias: float
                ) -> torch.Tensor:
    """The f32 score of every row after all trees, summed as the program
    sums it: the initial score, then each tree's leaf values in order (the
    first tree's stored values carry the initial score, which comes off)."""
    n = bins_T.shape[1]
    dev = bins_T.device
    b32 = torch.tensor(bias, dtype=torch.float32, device=dev)
    score = torch.zeros(n, dtype=torch.float32, device=dev) + b32
    for t, tree in enumerate(trees):
        lv = torch.as_tensor(tree.leaf_value, dtype=torch.float32,
                             device=dev)
        delta = lv[route(tree, bins_T)]
        score = score + (delta - b32 if t == 0 else delta)
    return score
