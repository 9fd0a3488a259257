"""The comparison that decides ``correct``.

The reference (``reference/``) bins the raw rows itself, then follows the
run's first ``CHECKED_TREES`` trees and the last ``CHECKED_TREES`` of the
measured window level by level on its own gradients and quantization,
sums every tree of the run over its own bins, and computes the metric from
that. The window's trees are judged so that a fault that starts only once
the program has warmed up (a captured graph, a cached plan, a stale
buffer) shows. The numbers compared, each
against its limit in ``limits/<cell>.json``:

- ``binning_mismatch``: bin bounds and train or valid bins that differ;
- ``bag_share_z``: how far the share of rows in a checked iteration's bag
  lies from ``bagging_fraction``, in standard deviations of a Bernoulli
  draw of that fraction (0 without bagging); ``bag_repeats``: checked
  iterations whose bag is the one before's; ``column_count_gap``: columns
  searched against round(F * ``feature_fraction``). The reference then
  follows the program's own draws, which are random;
- ``split_gap``: the largest relative shortfall of a chosen split's gain
  from the best one at its node;
- ``split_count_gap``: splits a level made against those the gains and
  the leaf budget call for, summed over levels, plus num_leaves - 1 for
  each iteration that left no tree;
- ``leaf_gap``: the largest relative gap of a leaf value from -G / H times
  the learning rate;
- ``count_mismatch``: rows a node or leaf counts against the rows the
  reference routes there;
- ``train_score_gap`` / ``valid_score_gap``: the largest absolute gap of
  the final scores from the sums of the run's trees;
- ``metric_gap``: the gap of the last reported validation metric from the
  one computed on the reference's validation scores.

The reference follows the run's own trees: where the program grew a tree,
the reference judges its choices rather than growing its own, since a tie
within rounding may pick another split and every later tree would then
differ. Its own gradients come from its own sum of the run's earlier
trees.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .gen.data import Data
from .reference import binning, metrics as ref_metrics, objectives as obj
from .reference.trees import (GrowParams, Tree, grow_tree, judge_tree,
                              route, tree_scores)

CHECKED_TREES = 3
NAMES = ("binning_mismatch", "bag_share_z", "bag_repeats",
         "column_count_gap", "split_gap", "split_count_gap", "leaf_gap",
         "count_mismatch", "train_score_gap", "valid_score_gap",
         "metric_gap")


class Problem:
    """The reference's view of a cell: its bins, objective and metric."""

    def __init__(self, params: dict, host: Data, device):
        self.params, self.device = params, device
        x = host.x_train.to(device)
        self.bounds = binning.find_bounds(
            x, int(params.get("max_bin", 255)),
            int(params.get("min_data_in_bin", 3)),
            int(params.get("bin_construct_sample_cnt", 200000)),
            int(params.get("data_random_seed", 1)))
        self.bins_T = binning.bin_columns(x, self.bounds)
        del x
        self.valid_bins_T = binning.bin_columns(host.x_valid.to(device),
                                                self.bounds)
        self.num_bins = torch.as_tensor([len(b) for b in self.bounds],
                                        device=device)
        self.y = host.y_train.to(device)
        self.y_valid = host.y_valid.to(device)
        self.objective = str(params["objective"])
        bagged = int(params.get("bagging_freq", 0)) > 0
        self.bag_fraction = float(params.get("bagging_fraction", 1.0)) \
            if bagged else 1.0
        ff = float(params.get("feature_fraction", 1.0))
        f = self.bins_T.shape[0]
        self.columns_searched = f if ff >= 1.0 else max(1, round(f * ff))
        self.gp = GrowParams(int(params["num_leaves"]),
                             int(params.get("min_data_in_leaf", 20)),
                             float(params.get("min_sum_hessian_in_leaf",
                                              1e-3)),
                             float(params["learning_rate"]))
        if self.objective == "binary":
            self.bias = obj.binary_init_score(self.y)
        elif self.objective == "lambdarank":
            self.bias = 0.0
            self.grid = obj.QueryGrid(host.group_train, device)
            self.inv_dcg = obj.max_dcg_inv(
                self.y, self.grid,
                int(params.get("lambdarank_truncation_level", 20)))
            self.valid_grid = obj.QueryGrid(host.group_valid, device)
        else:
            raise ValueError(f"no reference for objective {self.objective}")

    def gradients(self, score: torch.Tensor):
        if self.objective == "binary":
            return obj.binary_gradients(score, self.y)
        return obj.lambdarank_gradients(
            score, self.y, self.grid, self.inv_dcg,
            int(self.params.get("lambdarank_truncation_level", 20)))

    def metric(self, valid_score: torch.Tensor) -> float:
        if self.objective == "binary":
            return ref_metrics.auc(self.y_valid, valid_score)
        k = int(list(self.params.get("eval_at", [10]))[0])
        return ref_metrics.ndcg(self.y_valid, valid_score, self.valid_grid,
                                k)

    def start_score(self) -> torch.Tensor:
        b32 = torch.tensor(self.bias, dtype=torch.float32,
                           device=self.device)
        return torch.zeros(self.bins_T.shape[1], dtype=torch.float32,
                           device=self.device) + b32

    def after_tree(self, score: torch.Tensor, tree: Tree, first: bool
                   ) -> torch.Tensor:
        lv = torch.as_tensor(tree.leaf_value, dtype=torch.float32,
                             device=self.device)
        delta = lv[route(tree, self.bins_T)]
        if first:
            delta = delta - torch.tensor(self.bias, dtype=torch.float32,
                                         device=self.device)
        return score + delta


def readings(prob: Problem, out) -> Dict[str, float]:
    """The numbers compared, from a run's outputs (``program.Outputs`` or
    the control's)."""
    r: Dict[str, float] = {}
    mis = sum(int(len(a) != len(b) or not np.array_equal(a, b))
              for a, b in zip(out.bounds, prob.bounds))
    for got, ref in ((out.bins_T, prob.bins_T),
                     (out.valid_bins_T, prob.valid_bins_T)):
        if tuple(got.shape) != tuple(ref.shape):
            mis += ref.numel()
        else:
            mis += int((got.to(ref.device) != ref).sum())
    r["binning_mismatch"] = float(mis)
    score = prob.start_score()
    split_gap = leaf_gap = z = 0.0
    count_gap = count_mis = repeats = col_gap = 0
    f, n = prob.bins_T.shape
    frac, k = prob.bag_fraction, prob.columns_searched
    prev = None
    # one pass over every tree: the reference's own score before each, a
    # checked tree judged on the gradients of that score
    for t, tree in enumerate(out.trees):
        if t in out.checked:
            bag_np, cols_np = out.checked[t]
            bag = None if bag_np is None else torch.as_tensor(
                bag_np, device=prob.device)
            cols = None if cols_np is None else torch.as_tensor(
                cols_np, device=prob.device)
            share = 1.0 if bag is None else float((bag > 0).double().mean())
            z = max(z, abs(share - frac) / math.sqrt(
                max(frac * (1.0 - frac), 1e-12) / n))
            if (bag is not None and prev is not None and prev[0] == t - 1
                    and torch.equal(bag, prev[1])):
                repeats += 1
            prev = (t, bag)
            col_gap += abs((f if cols is None else int(cols.sum())) - k)
            g, h = prob.gradients(score)
            j = judge_tree(tree, prob.bins_T, prob.num_bins, g, h, qseed=t,
                           gp=prob.gp, bias=prob.bias if t == 0 else 0.0,
                           bag=bag, cols=cols)
            split_gap = max(split_gap, j["split_gap"])
            leaf_gap = max(leaf_gap, j["leaf_gap"])
            count_gap += j["split_count_gap"]
            count_mis += j["count_mismatch"]
        score = prob.after_tree(score, tree, t == 0)
    count_gap += max(0, out.iterations - len(out.trees)) * (
        prob.gp.num_leaves - 1)
    r.update(bag_share_z=z, bag_repeats=float(repeats),
             column_count_gap=float(col_gap))
    r.update(split_gap=split_gap, split_count_gap=float(count_gap),
             leaf_gap=leaf_gap, count_mismatch=float(count_mis))
    train_ref = score
    valid_ref = tree_scores(out.trees, prob.valid_bins_T, prob.bias)
    r["train_score_gap"] = _max_gap(out.train_score, train_ref)
    r["valid_score_gap"] = _max_gap(out.valid_score, valid_ref)
    r["metric_gap"] = abs(float(out.metric) - prob.metric(valid_ref))
    return {k: (v if math.isfinite(v) else 1e30) for k, v in r.items()}


def _max_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    if tuple(got.shape) != tuple(ref.shape):
        return 1e30
    return float((got.to(ref.device).to(torch.float64)
                  - ref.to(torch.float64)).abs().max())


def compare(read: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over every limited number; a
    number that is missing reads 1e30 and fails."""
    rows = [(k, float(read.get(k, 1e30)), float(limits[k])) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows


class ControlOutputs:
    """The reference put in the program's place: its own trees, grown with
    the gradients and hessians rounded to ``dtype`` (bfloat16: the next
    precision below the configuration's float32), or with a planted fault
    (``half_rows``: half the rows left out of the bag and the rest counted
    double;
    ``alter_leaf``: one leaf value of the second tree changed where it is
    produced)."""

    def __init__(self, prob: Problem, n_trees: int = CHECKED_TREES,
                 dtype: Optional[torch.dtype] = torch.bfloat16,
                 fault: Optional[str] = None, seed: int = 0):
        f, n = prob.bins_T.shape
        dev = prob.device
        half = None
        if fault == "half_rows":
            half = (torch.arange(n, device=dev) % 2 == 0).to(
                torch.float32) * 2.0
        draw = torch.Generator(device=dev)
        draw.manual_seed(seed)
        score = prob.start_score()
        gp = prob.gp
        if fault == "short_tree":
            gp = GrowParams(gp.num_leaves // 2, gp.min_data_in_leaf,
                            gp.min_sum_hessian_in_leaf, gp.learning_rate)
        n_cols = prob.columns_searched + int(fault == "extra_column")
        self.trees: List[Tree] = []
        self.checked = {}
        bag = None
        for t in range(n_trees):
            cols = None
            if prob.bag_fraction < 1.0 and not (fault == "reused_bag"
                                                and bag is not None):
                bag = (torch.rand(n, generator=draw, device=dev)
                       < prob.bag_fraction).to(torch.float32)
            if n_cols < f:
                cols = torch.zeros(f, dtype=torch.bool, device=dev)
                cols[torch.randperm(f, generator=draw, device=dev)[
                    :n_cols]] = True
            keep = bag if half is None else (
                half if bag is None else bag * half)
            # the rows the tree sees are its bag
            self.checked[t] = (None if keep is None else
                               (keep > 0).to(torch.float32).cpu().numpy(),
                               None if cols is None else cols.cpu().numpy())
            g, h = prob.gradients(score)
            if dtype is not None:
                g, h = g.to(dtype).to(torch.float32), h.to(dtype).to(
                    torch.float32)
            tree = grow_tree(prob.bins_T, prob.num_bins, g, h, t, gp,
                             prob.bias if t == 0 else 0.0, row_keep=keep,
                             cols=cols)
            if fault == "alter_leaf" and t == 1:
                tree.leaf_value = tree.leaf_value.copy()
                tree.leaf_value[0] *= 1.5
            self.trees.append(tree)
            score = prob.after_tree(score, tree, t == 0)
        self.bias = prob.bias
        self.iterations = n_trees
        self.train_score = score
        self.valid_score = tree_scores(self.trees, prob.valid_bins_T,
                                       prob.bias)
        self.metric = prob.metric(self.valid_score)
        self.bounds = prob.bounds
        self.bins_T = prob.bins_T
        self.valid_bins_T = prob.valid_bins_T
