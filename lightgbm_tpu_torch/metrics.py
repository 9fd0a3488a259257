"""Evaluation metrics.

Port of ``lightgbm_tpu/metrics.py`` (:21-369; reference factory
metric.cpp:16): each pointwise metric is a function of (label, prediction,
row weight or None), a weighted mean of a per-row loss where it is one,
computed in f64 on the scores' device (the reference computes in f32). The
ranking metrics ndcg@k and map@k (one metric for each ``eval_at`` entry,
:216-263, :294-300) take the Dataset's query groups and are numpy f64 on
the host, as in the reference, so they agree with it to the last bit. An
unknown metric name raises where the reference warns and skips.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from .config import Config
from .log import LightGBMError
from .obs.tracing import span
from .utils.query import query_grid

_EPS = 1e-15


class Metric:
    """One named metric (reference: Metric, metric.h:24)."""

    def __init__(self, name: str, fn: Callable, greater_is_better: bool,
                 use_prob: bool = True, eval_at: Optional[int] = None):
        self.name = name
        self.fn = fn
        self.greater_is_better = greater_is_better
        self.use_prob = use_prob   # consumes converted output, not raw score
        self.eval_at = eval_at     # the k of a ranking metric

    def __call__(self, label: torch.Tensor, pred: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 group: Optional[np.ndarray] = None) -> float:
        if self.eval_at is not None:
            # the reference's numpy ranking metrics: f32 labels and scores,
            # each a host read
            with span("sync.metric"):
                lab = label.cpu().numpy()
            with span("sync.metric"):
                pr = pred.to(torch.float32).cpu().numpy()
            return float(self.fn(lab, pr, None, group, self.eval_at))
        w = None if weight is None else weight.to(torch.float64)
        value = self.fn(label.to(torch.float64), pred.to(torch.float64), w)
        # the metric's one host read
        with span("sync.metric"):
            return float(value)


def _wmean(err, w):
    if w is None:
        return err.mean()
    return (err * w).sum() / w.sum()


# ---- regression (regression_metric.hpp) ----

def l2(label, pred, w=None):
    return _wmean((pred - label) ** 2, w)


def rmse(label, pred, w=None):
    return torch.sqrt(l2(label, pred, w))


def l1(label, pred, w=None):
    return _wmean((pred - label).abs(), w)


def _quantile(alpha):
    def f(label, pred, w=None):
        d = label - pred
        return _wmean(torch.where(d >= 0, alpha * d, (alpha - 1) * d), w)
    return f


def _huber(alpha):
    def f(label, pred, w=None):
        d = (pred - label).abs()
        return _wmean(torch.where(d <= alpha, 0.5 * d * d,
                                  alpha * (d - 0.5 * alpha)), w)
    return f


def _fair(c):
    def f(label, pred, w=None):
        d = (pred - label).abs()
        return _wmean(c * c * (d / c - torch.log1p(d / c)), w)
    return f


def poisson(label, pred, w=None):
    p = torch.clamp(pred, min=1e-10)
    return _wmean(p - label * torch.log(p), w)


def mape(label, pred, w=None):
    return _wmean(((label - pred) / torch.clamp(label.abs(), min=1.0)).abs(),
                  w)


def gamma(label, pred, w=None):
    p = torch.clamp(pred, min=1e-10)
    return _wmean(label / p - torch.log(label / p + 1e-10) - 1.0, w)


def gamma_deviance(label, pred, w=None):
    p = torch.clamp(pred, min=1e-10)
    return 2.0 * _wmean(torch.log(p / torch.clamp(label, min=1e-10))
                        + label / p - 1.0, w)


def _tweedie(rho):
    def f(label, pred, w=None):
        p = torch.clamp(pred, min=1e-10)
        a = label * torch.pow(p, 1.0 - rho) / (1.0 - rho)
        b = torch.pow(p, 2.0 - rho) / (2.0 - rho)
        return _wmean(-a + b, w)
    return f


# ---- binary (binary_metric.hpp) ----

def binary_logloss(label, prob, w=None):
    y = (label > 0).to(prob.dtype)
    p = torch.clamp(prob, _EPS, 1 - _EPS)
    return _wmean(-(y * torch.log(p) + (1 - y) * torch.log(1 - p)), w)


def binary_error(label, prob, w=None):
    y = (label > 0).to(prob.dtype)
    return _wmean(((prob > 0.5).to(prob.dtype) != y).to(prob.dtype), w)


def auc(label, prob, w=None):
    """Weighted ROC AUC by rank statistics (reference: _auc): each row's
    rank is the midpoint of its cumulative weight in score order, averaged
    (weight-wise) over rows of equal score."""
    y = (label > 0).to(torch.float64)
    ww = (torch.ones_like(prob, dtype=torch.float64) if w is None
          else w.to(torch.float64))
    order = torch.argsort(prob, stable=True)
    ys, ws, ps = y[order], ww[order], prob[order]
    rank = torch.cumsum(ws, 0) - ws / 2.0
    n = ps.shape[0]
    new_grp = torch.ones(n, dtype=torch.bool, device=ps.device)
    new_grp[1:] = ps[1:] != ps[:-1]
    gid = torch.cumsum(new_grp.to(torch.int64), 0) - 1
    zeros = torch.zeros(n, dtype=torch.float64, device=ps.device)
    g_w = zeros.index_add(0, gid, ws)
    g_rw = zeros.index_add(0, gid, rank * ws)
    rank = (g_rw / torch.clamp(g_w, min=1e-30))[gid]
    w_pos = (ys * ws).sum()
    w_neg = ((1 - ys) * ws).sum()
    return ((rank * ys * ws).sum() - w_pos * w_pos / 2.0) / torch.clamp(
        w_pos * w_neg, min=1e-30)


# ---- multiclass (multiclass_metric.hpp) ----

def multi_logloss(label, prob, w=None):
    idx = label.to(torch.int64)
    p = torch.clamp(prob.gather(1, idx[:, None])[:, 0], _EPS, 1.0)
    return _wmean(-torch.log(p), w)


def multi_error(label, prob, w=None):
    pred = torch.argmax(prob, dim=1)
    return _wmean((pred != label.to(torch.int64)).to(torch.float64), w)


def auc_mu(label, prob, w=None, weights_matrix=None):
    """AUC-mu (Kleiman & Page; reference: _auc_mu, multiclass_metric.hpp
    AucMuMetric): the mean over class pairs (a, b) of the AUC separating
    them along v = A[a] - A[b] of the class-weight matrix A (ones with a
    zero diagonal by default). Row weights are ignored, as there."""
    k = prob.shape[1]
    A = (np.ones((k, k)) - np.eye(k) if weights_matrix is None
         else np.asarray(weights_matrix, np.float64).reshape(k, k))
    lab = label.to(torch.int64)
    out = []
    for a in range(k):
        for b in range(a + 1, k):
            v = A[a] - A[b]
            d = float(v[a] - v[b]) * (prob @ torch.as_tensor(
                v, dtype=prob.dtype, device=prob.device))
            in_pair = (lab == a) | (lab == b)
            out.append(auc((lab == a).to(torch.float64),
                           torch.where(in_pair, d,
                                       torch.full_like(d, -float("inf"))),
                           in_pair.to(torch.float64)))
    return torch.stack(out).mean()


def _auc_mu_with_config(config: Config):
    """auc_mu bound to ``auc_mu_weights`` (num_class^2 values; the diagonal
    forced to 0, off-diagonal entries non-zero; config.cpp:163-177)."""
    wts = list(config.auc_mu_weights or [])
    if not wts:
        return auc_mu
    k = config.num_class
    if len(wts) != k * k:
        raise LightGBMError(f"auc_mu_weights must have num_class^2 = "
                            f"{k * k} elements (got {len(wts)})")
    A = np.asarray(wts, np.float64).reshape(k, k)
    if np.any((A == 0) & ~np.eye(k, dtype=bool)):
        raise LightGBMError("all off-diagonal auc_mu_weights must be "
                            "non-zero")
    A = A * (1.0 - np.eye(k))

    def fn(label, prob, w=None):
        return auc_mu(label, prob, w, weights_matrix=A)
    return fn


# ---- cross entropy (xentropy_metric.hpp) ----

def cross_entropy(label, prob, w=None):
    p = torch.clamp(prob, _EPS, 1 - _EPS)
    return _wmean(-(label * torch.log(p) + (1 - label) * torch.log(1 - p)), w)


def cross_entropy_lambda(label, hhat, w=None):
    z = 1.0 - torch.exp(-torch.clamp(hhat, min=_EPS))
    z = torch.clamp(z, _EPS, 1 - _EPS)
    return _wmean(-(label * torch.log(z) + (1 - label) * torch.log(1 - z)), w)


def kullback_leibler(label, prob, w=None):
    p = torch.clamp(prob, _EPS, 1 - _EPS)
    y = torch.clamp(label, _EPS, 1 - _EPS)
    return _wmean(y * torch.log(y / p) + (1 - y) * torch.log((1 - y) / (1 - p)),
                  w)


# ---- ranking (dcg_calculator.cpp), numpy f64 on the host ----

def ndcg(label, score, weight, group, k):
    """Mean NDCG@k over the queries, gains 2^label - 1; a query with no
    positive gain counts 1."""
    if group is None:
        raise LightGBMError("ndcg requires group info")
    idx, msk = query_grid(np.asarray(group))
    lab = np.asarray(label)[idx] * msk
    sc = np.where(msk, np.asarray(score)[idx], -np.inf)
    gains = (2.0 ** lab - 1.0) * msk
    order = np.argsort(-sc, axis=1, kind="stable")
    g_sorted = np.take_along_axis(gains, order, axis=1)
    m_sorted = np.take_along_axis(msk, order, axis=1)
    disc = 1.0 / np.log2(np.arange(gains.shape[1]) + 2.0)
    topk = np.arange(gains.shape[1]) < k
    dcg = (g_sorted * disc * topk * m_sorted).sum(axis=1)
    ideal = np.sort(gains + np.where(msk, 0, -np.inf), axis=1)[:, ::-1]
    ideal = np.where(np.isfinite(ideal), ideal, 0.0)
    idcg = (ideal * disc * topk).sum(axis=1)
    out = np.where(idcg > 0, dcg / np.maximum(idcg, 1e-30), 1.0)
    return float(out.mean())


def map_at(label, score, weight, group, k):
    """Mean average precision at k over the queries (label > 0 relevant)."""
    if group is None:
        raise LightGBMError("map requires group info")
    idx, msk = query_grid(np.asarray(group))
    lab = (np.asarray(label)[idx] > 0) & msk
    sc = np.where(msk, np.asarray(score)[idx], -np.inf)
    order = np.argsort(-sc, axis=1, kind="stable")
    rel = np.take_along_axis(lab, order, axis=1).astype(np.float64)
    pos = np.arange(rel.shape[1]) + 1.0
    prec = np.cumsum(rel, axis=1) / pos
    topk = np.arange(rel.shape[1]) < k
    ap_num = (prec * rel * topk).sum(axis=1)
    denom = np.minimum(lab.sum(axis=1), k)
    ap = np.where(denom > 0, ap_num / np.maximum(denom, 1), 0.0)
    return float(ap.mean())


# ---- factory (metric.cpp:16) ----

# the ranking metrics' names (lightgbm_tpu/metrics.py:294-295)
RANKING_METRICS = ("ndcg", "lambdarank", "rank_xendcg", "xendcg", "xe_ndcg",
                   "xe_ndcg_mart", "xendcg_mart", "map",
                   "mean_average_precision")


def _table(c: Config):
    """name -> (reported name, function, greater_is_better)."""
    quantile = ("quantile", _quantile(c.alpha), False)
    return {
        **dict.fromkeys(("l2", "mse", "mean_squared_error", "regression"),
                        ("l2", l2, False)),
        **dict.fromkeys(("l2_root", "rmse", "root_mean_squared_error"),
                        ("rmse", rmse, False)),
        **dict.fromkeys(("l1", "mae", "mean_absolute_error",
                         "regression_l1"), ("l1", l1, False)),
        "quantile": quantile,
        "huber": ("huber", _huber(c.alpha), False),
        "fair": ("fair", _fair(c.fair_c), False),
        "poisson": ("poisson", poisson, False),
        **dict.fromkeys(("mape", "mean_absolute_percentage_error"),
                        ("mape", mape, False)),
        "gamma": ("gamma", gamma, False),
        "gamma_deviance": ("gamma_deviance", gamma_deviance, False),
        "tweedie": ("tweedie", _tweedie(c.tweedie_variance_power), False),
        **dict.fromkeys(("binary_logloss", "binary"),
                        ("binary_logloss", binary_logloss, False)),
        "binary_error": ("binary_error", binary_error, False),
        "auc": ("auc", auc, True),
        **dict.fromkeys(("multi_logloss", "multiclass", "softmax",
                         "multiclassova"),
                        ("multi_logloss", multi_logloss, False)),
        "multi_error": ("multi_error", multi_error, False),
        "auc_mu": ("auc_mu", _auc_mu_with_config(c), True),
        **dict.fromkeys(("cross_entropy", "xentropy"),
                        ("cross_entropy", cross_entropy, False)),
        **dict.fromkeys(("cross_entropy_lambda", "xentlambda"),
                        ("cross_entropy_lambda", cross_entropy_lambda,
                         False)),
        **dict.fromkeys(("kullback_leibler", "kldiv"),
                        ("kullback_leibler", kullback_leibler, False)),
    }


def create_metrics(names: List[str],
                   config: Optional[Config] = None) -> List[Metric]:
    config = config if config is not None else Config()
    table = _table(config)
    out = []
    for raw in names:
        name = raw.lower().strip()
        if name in ("", "none", "null", "na", "custom"):
            continue
        if name in RANKING_METRICS:
            is_map = name in ("map", "mean_average_precision")
            base = "map" if is_map else "ndcg"
            for k in (config.eval_at or [1, 2, 3, 4, 5]):
                out.append(Metric(f"{base}@{k}", map_at if is_map else ndcg,
                                  True, False, eval_at=k))
            continue
        if name not in table:
            raise LightGBMError(f"unknown metric {name!r}")
        nm, fn, gib = table[name]
        out.append(Metric(nm, fn, gib))
    return out


_DEFAULT_METRIC = {
    **dict.fromkeys(("regression", "l2", "mse", "mean_squared_error"), "l2"),
    **dict.fromkeys(("rmse", "l2_root", "root_mean_squared_error"), "rmse"),
    **dict.fromkeys(("regression_l1", "l1", "mae", "mean_absolute_error"),
                    "l1"),
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape", "gamma": "gamma",
    "tweedie": "tweedie", "binary": "binary_logloss",
    **dict.fromkeys(("multiclass", "softmax", "multiclassova", "ova", "ovr"),
                    "multi_logloss"),
    **dict.fromkeys(("cross_entropy", "xentropy"), "cross_entropy"),
    **dict.fromkeys(("cross_entropy_lambda", "xentlambda"),
                    "cross_entropy_lambda"),
    **dict.fromkeys(("lambdarank", "rank_xendcg", "xendcg"), "ndcg"),
}


def default_metric_for_objective(objective: Optional[str]) -> str:
    """The reference's default metric of an objective (metrics.py:354-369):
    l2 for any name it does not list."""
    return _DEFAULT_METRIC.get(str(objective or "").lower(), "l2")
