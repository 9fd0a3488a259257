"""Evaluation metrics of the slice: auc, binary_logloss, l2, rmse.

Port of those metrics of ``lightgbm_tpu/metrics.py`` (reference factory:
metric.cpp:16), computed in f64 on the scores' device.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch


class Metric:
    """One named metric (reference: Metric, metric.h:24)."""

    def __init__(self, name: str, fn: Callable, greater_is_better: bool,
                 use_prob: bool):
        self.name = name
        self.fn = fn
        self.greater_is_better = greater_is_better
        self.use_prob = use_prob   # consumes converted output, not raw score

    def __call__(self, label: torch.Tensor, pred: torch.Tensor) -> float:
        return float(self.fn(label.to(torch.float64),
                             pred.to(torch.float64)))


def l2(label, pred):
    return ((pred - label) ** 2).mean()


def rmse(label, pred):
    return torch.sqrt(l2(label, pred))


def binary_logloss(label, prob):
    eps = 1e-15
    y = (label > 0).to(prob.dtype)
    p = torch.clamp(prob, eps, 1 - eps)
    return (-(y * torch.log(p) + (1 - y) * torch.log(1 - p))).mean()


def auc(label, prob):
    """ROC AUC via rank statistics with average ranks for tied scores."""
    y = (label > 0).to(torch.float64)
    order = torch.argsort(prob)
    ys, ps = y[order], prob[order]
    n = ps.shape[0]
    new_grp = torch.ones(n, dtype=torch.bool, device=ps.device)
    new_grp[1:] = ps[1:] != ps[:-1]
    gid = torch.cumsum(new_grp.to(torch.int64), 0) - 1
    rank = torch.arange(1, n + 1, dtype=torch.float64, device=ps.device)
    g_sum = torch.zeros(n, dtype=torch.float64, device=ps.device) \
        .index_add_(0, gid, rank)
    g_cnt = torch.zeros(n, dtype=torch.float64, device=ps.device) \
        .index_add_(0, gid, torch.ones_like(rank))
    avg_rank = (g_sum / g_cnt.clamp(min=1.0))[gid]
    w_pos = ys.sum()
    w_neg = n - w_pos
    sum_pos_rank = (avg_rank * ys).sum()
    return (sum_pos_rank - w_pos * (w_pos + 1) / 2.0) / torch.clamp(
        w_pos * w_neg, min=1e-30)


_TABLE = {
    "l2": ("l2", l2, False), "mse": ("l2", l2, False),
    "mean_squared_error": ("l2", l2, False), "regression": ("l2", l2, False),
    "l2_root": ("rmse", rmse, False), "rmse": ("rmse", rmse, False),
    "root_mean_squared_error": ("rmse", rmse, False),
    "binary_logloss": ("binary_logloss", binary_logloss, False),
    "binary": ("binary_logloss", binary_logloss, False),
    "auc": ("auc", auc, True),
}


def create_metrics(names: List[str]) -> List[Metric]:
    out = []
    for raw in names:
        name = raw.lower().strip()
        if name in ("", "none", "null", "na", "custom"):
            continue
        if name not in _TABLE:
            raise NotImplementedError(f"metric {name!r} is not ported yet "
                                      "(ROADMAP.md queue A11)")
        nm, fn, gib = _TABLE[name]
        out.append(Metric(nm, fn, gib, use_prob=True))
    return out


def default_metric_for_objective(objective: Optional[str]) -> str:
    return "binary_logloss" if str(objective).lower() == "binary" else "l2"
