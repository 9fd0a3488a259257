"""The work a boosting iteration needs, counted from what the algorithm
needs on these inputs and not from what a kernel reads.

The counts come from the trees the window itself grew (each node's and
leaf's row count), so they hold whatever implements the work. The byte
rule is that of ``chip_smoke.py``'s ``bound`` arithmetic (each kept row's
bins and channels read once), applied to the rows the trees record. Bytes:

- histograms: each in-bag row's F one-byte bins and its gradient channels
  (``chan_bytes``: g and h as int8 under quantized training, plus a count
  byte when a bag is drawn) once at the root; then at each level, the same
  for the rows of the smaller child of every split (the larger is the
  parent's histogram minus the smaller's), except at the level that spends
  the last of the leaf budget ``num_leaves``: its children are never
  searched, so their histograms are not needed;
- routing: at each level, each row of a splitting leaf reads its split bin
  and its leaf id and writes its new leaf id (1 + 4 + 4 bytes);
- gradients: each row's score and label read (8 bytes) and its quantized
  channels written (``chan_bytes``);
- leaf values from exact sums: each row's leaf id, score and label (12);
- score update: each train row's leaf id read and its score read and
  written (12); each valid row's score read and written (8) and the bins on
  its path (the train rows' mean path length, one byte a level);
- the metric: each valid row's score and label (8).

Operations (f32 or integer): three adds a (row, feature) of every
histogram built, about 20 for a row's gradient, and the split search's
about 20 a (leaf, feature, bin) searched: the root, and both children of
every split but those of the level that spends the budget. The least time of an iteration
is the larger of bytes over the card's bandwidth and operations over its
f32 rate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class Shape:
    rows_train: int
    rows_valid: int
    features: int
    bins: int           # padded bins a feature, as the split search sees
    chan_bytes: int     # gradient channel bytes a row
    num_leaves: int     # the leaf budget of a tree
    extra_grad_flops: float = 0.0   # a ranking objective's pair work


def _count(tree, child: int) -> float:
    return float(tree.internal_count[child] if child >= 0
                 else tree.leaf_count[~child])


def levels(tree) -> List[List[int]]:
    """The internal nodes of each depth."""
    out: List[List[int]] = []
    if tree.num_leaves <= 1:
        return out
    frontier = [0]
    while frontier:
        out.append(frontier)
        frontier = [c for k in frontier for c in (int(tree.left[k]),
                                                   int(tree.right[k]))
                    if c >= 0]
    return out


def searched_levels(tree, num_leaves: int) -> List[List[int]]:
    """The levels whose children are searched: each but the one after
    which the tree holds its whole leaf budget."""
    out, leaves = [], 1
    for nodes in levels(tree):
        leaves += len(nodes)
        if leaves < num_leaves:
            out.append(nodes)
    return out


def hist_bytes(tree, shape: Shape) -> float:
    """Bytes the tree's histograms need."""
    row = shape.features + shape.chan_bytes
    root = float(tree.internal_count[0]) if tree.num_leaves > 1 else \
        float(tree.leaf_count[0])
    total = root * row
    for nodes in searched_levels(tree, shape.num_leaves):
        small = sum(min(_count(tree, int(tree.left[k])),
                        _count(tree, int(tree.right[k]))) for k in nodes)
        total += small * row
    return total


def mean_path(tree) -> float:
    """The train rows' mean number of levels from the root to a leaf."""
    if tree.num_leaves <= 1:
        return 0.0
    rows = 0.0
    for d, nodes in enumerate(levels(tree)):
        for k in nodes:
            for c in (int(tree.left[k]), int(tree.right[k])):
                if c < 0:
                    rows += (d + 1) * float(tree.leaf_count[~c])
    return rows / max(float(tree.leaf_count[:tree.num_leaves].sum()), 1.0)


def iteration_work(tree, shape: Shape):
    """(bytes, operations) that one iteration with this tree needs."""
    n, nv, f = shape.rows_train, shape.rows_valid, shape.features
    hb = hist_bytes(tree, shape)
    built_rows = hb / (f + shape.chan_bytes)
    routed = sum(float(tree.internal_count[k]) for nodes in levels(tree)
                 for k in nodes)
    nbytes = (hb + routed * 9 + n * (8 + shape.chan_bytes) + n * 12
              + n * 12 + nv * (8 + mean_path(tree)) + nv * 8)
    searched = sum(len(nodes) * 2
                   for nodes in searched_levels(tree, shape.num_leaves)) + 1
    ops = (3.0 * built_rows * f + 20.0 * n + shape.extra_grad_flops
           + 20.0 * searched * f * shape.bins)
    return nbytes, ops


def least_seconds(nbytes: float, ops: float, bandwidth: float,
                  flops: float) -> float:
    return max(nbytes / bandwidth, ops / flops)
