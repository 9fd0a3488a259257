"""Objective functions: gradients, hessians, init scores, output transforms.

Port of the pointwise objectives of ``lightgbm_tpu/objectives.py`` (:24-431)
and its factory and percentile helpers (:643-721): the regression family
(L2 with ``reg_sqrt``, L1, Huber, Fair, Poisson, Quantile, MAPE, Gamma,
Tweedie), binary logloss, multiclass softmax and one-vs-all (``[N, K]``
scores), cross-entropy and cross-entropy-lambda; each with optional row
weights, which multiply g and h. Labels and weights live on the training
device as f32 tensors. Every row-wise formula keeps the reference's f32
operation order, Python-float factors rounded to f32 where they meet a row,
as JAX's weak types do; only ``exp`` differs, by an ulp on some arguments
of the CPU (ROADMAP.md C1). ``fused_grad_spec`` (the spec the fused
gradient front replays in-kernel) exists for the unweighted L2 and binary
objectives alone. The ranking objectives (lambdarank, rank_xendcg, :430-638)
take the Dataset's query groups: their per-query doc grid and ideal DCGs are
built on the host, the lambdas run as plain torch on the training device,
as the reference computes them outside any Pallas kernel (their log2
discounts and minor-axis sums differ from XLA:CPU's by ulps, ROADMAP.md C6).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import Config, objective_kind
from .log import LightGBMError
from .obs.tracing import span
from .ops.hist_kernels import grad_rows
from .utils.query import query_grid


def _weighted(grad, hess, weight):
    if weight is None:
        return grad, hess
    return grad * weight, hess * weight


def _host(x: torch.Tensor) -> float:
    """A one-element tensor read on the host: a sync, in a span of its
    own."""
    with span("sync.objective"):
        return float(x)


def _f32(x) -> float:
    """x (a number or a one-element tensor on any device) rounded to f32:
    the value of a reference f32 scalar."""
    return float(np.float32(_host(x) if isinstance(x, torch.Tensor)
                            else float(x)))


def _wmean(x: torch.Tensor, weight: Optional[torch.Tensor]) -> float:
    """(Weighted) mean as the reference's f32 one computes it: sums
    rounded to f32 (taken in f64, so they equal the reference's wherever
    its f32 sums are exact), then XLA:CPU's mean, the sum times the f32
    reciprocal of N, or the weighted sum over the weight sum."""
    x = x.to(torch.float64)
    if weight is None:
        inv_n = np.float32(1.0 / x.shape[0])
        return float(np.float32(_f32(x.sum())) * inv_n)
    w = weight.to(torch.float64)
    return float(np.float32(_f32((x * w).sum())) / np.float32(_f32(w.sum())))


def class_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the class axis of [N, K], left to right, as XLA's reduce
    loop adds a short row."""
    out = x[:, 0]
    for c in range(1, x.shape[1]):
        out = out + x[:, c]
    return out


def softmax(score: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the class axis: exp(x - max) over its sum."""
    u = torch.exp(score - score.max(dim=1, keepdim=True).values)
    return u / class_sum(u)[:, None]


def sigmoid(score: torch.Tensor, s: float = 1.0) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-s * score))


class ObjectiveFunction:
    """Base objective (reference: ObjectiveFunction, objective_function.h:19).

    ``is_constant_hessian`` is an instance attribute after ``init``: the
    class flag, cleared by row weights (the q8 histograms' const-hessian
    elision rebuilds h as count * h_const, valid only for unit rows)."""

    name = "custom"
    is_constant_hessian = False
    num_model_per_iteration = 1

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.num_data = 0

    def init(self, label: torch.Tensor,
             weight: Optional[torch.Tensor] = None,
             group: Optional[np.ndarray] = None) -> None:
        self.label = label
        self.weight = weight
        self.num_data = int(label.shape[0])
        self.is_constant_hessian = self.constant_hessian(weight is not None)

    @classmethod
    def constant_hessian(cls, weighted: bool) -> bool:
        """``is_constant_hessian`` after ``init`` with or without weights."""
        return cls.is_constant_hessian and not weighted

    def fuses(self, weighted: bool) -> bool:
        """Whether the fused gradient front replays this objective's
        gradients: only the exact unweighted L2 and binary objectives
        (subclasses override get_gradients)."""
        return not weighted and type(self) in (RegressionL2, Binary)

    def get_gradients(self, score: torch.Tensor):
        raise NotImplementedError

    def fused_grad_spec(self):
        """(spec, aux rows) for the fused gradient front, or None."""
        return None

    def boost_from_score(self) -> float:
        return 0.0

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score

    def renew_leaf_values(self, score, leaf_id, num_leaves):
        """Per-leaf output renewal of the L1 family, or None."""
        return None


# ---------------- regression family (regression_objective.hpp) ----------------

class RegressionL2(ObjectiveFunction):
    name = "regression"
    is_constant_hessian = True   # with unit weights

    def init(self, label, weight=None, group=None):
        super().init(label, weight, group)
        if self.config.reg_sqrt:
            self.label = torch.sign(label) * torch.sqrt(label.abs())

    def get_gradients(self, score):
        return _weighted(score - self.label, torch.ones_like(score),
                         self.weight)

    def fused_grad_spec(self):
        if not self.fuses(self.weight is not None):
            return None
        return ("l2",), self.label

    def boost_from_score(self) -> float:
        return _wmean(self.label, self.weight)

    def convert_output(self, score):
        if self.config.reg_sqrt:
            return torch.sign(score) * score * score
        return score


class RegressionL1(RegressionL2):
    name = "regression_l1"

    def get_gradients(self, score):
        return _weighted(torch.sign(score - self.label),
                         torch.ones_like(score), self.weight)

    def boost_from_score(self) -> float:
        return _host(weighted_percentile(self.label, self.weight, 0.5))

    def renew_leaf_values(self, score, leaf_id, num_leaves):
        # the leaf's weighted median residual (RegressionL1loss::
        # RenewTreeOutput)
        return leaf_percentile(self.label - score, leaf_id, num_leaves, 0.5,
                               self.weight)


class Huber(RegressionL2):
    name = "huber"
    is_constant_hessian = False

    def get_gradients(self, score):
        a = self.config.alpha
        return _weighted(torch.clamp(score - self.label, -a, a),
                         torch.ones_like(score), self.weight)


class Fair(RegressionL2):
    name = "fair"
    is_constant_hessian = False

    def get_gradients(self, score):
        d = score - self.label
        c = self.config.fair_c
        grad = c * d / (d.abs() + c)
        # a Python numerator would divide as reciprocal times it (torch's
        # __rtruediv__); the reference divides f32(c * c) itself
        hess = torch.div(torch.full_like(d, c * c), (d.abs() + c) ** 2)
        return _weighted(grad, hess, self.weight)


class Poisson(RegressionL2):
    name = "poisson"
    is_constant_hessian = False

    def init(self, label, weight=None, group=None):
        super().init(label, weight, group)
        self._hess_scale = float(np.exp(self.config.poisson_max_delta_step))

    def get_gradients(self, score):
        ex = torch.exp(score)
        return _weighted(ex - self.label, ex * self._hess_scale, self.weight)

    def boost_from_score(self) -> float:
        return float(np.log(max(_wmean(self.label, self.weight), 1e-9)))

    def convert_output(self, score):
        return torch.exp(score)


class Quantile(RegressionL2):
    name = "quantile"

    def get_gradients(self, score):
        a = self.config.alpha
        d = score - self.label
        grad = torch.where(d >= 0, torch.full_like(d, _f32(1.0 - a)),
                           torch.full_like(d, _f32(-a)))
        return _weighted(grad, torch.ones_like(score), self.weight)

    def boost_from_score(self) -> float:
        return _host(weighted_percentile(self.label, self.weight,
                                         self.config.alpha))

    def renew_leaf_values(self, score, leaf_id, num_leaves):
        return leaf_percentile(self.label - score, leaf_id, num_leaves,
                               self.config.alpha, self.weight)


class Mape(RegressionL2):
    """MAPE. The reference's LightGBM reports a constant hessian because
    1 / |label| rides as a label weight; here h = w / max(1, |label|)
    varies by row, so the flag stays off (the q8 elision needs unit rows)."""
    name = "mape"
    is_constant_hessian = False

    def init(self, label, weight=None, group=None):
        super().init(label, weight, group)
        w = weight if weight is not None else torch.ones_like(label)
        self._mape_w = w / torch.clamp(label.abs(), min=1.0)

    def get_gradients(self, score):
        return torch.sign(score - self.label) * self._mape_w, self._mape_w

    def boost_from_score(self) -> float:
        return _host(weighted_percentile(self.label, self._mape_w, 0.5))

    def renew_leaf_values(self, score, leaf_id, num_leaves):
        return leaf_percentile(self.label - score, leaf_id, num_leaves, 0.5,
                               self._mape_w)


class Gamma(Poisson):
    name = "gamma"

    def init(self, label, weight=None, group=None):
        RegressionL2.init(self, label, weight, group)

    def get_gradients(self, score):
        ex = torch.exp(-score)
        return _weighted(1.0 - self.label * ex, self.label * ex, self.weight)


class Tweedie(Poisson):
    name = "tweedie"

    def init(self, label, weight=None, group=None):
        RegressionL2.init(self, label, weight, group)
        self.rho = self.config.tweedie_variance_power

    def get_gradients(self, score):
        rho = self.rho
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        grad = -self.label * e1 + e2
        hess = -self.label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return _weighted(grad, hess, self.weight)


# ---------------- binary (binary_objective.hpp:21) ----------------

class Binary(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.label_weight_pos = 1.0
        self.label_weight_neg = 1.0

    def init(self, label, weight=None, group=None):
        super().init(label, weight, group)
        self.label_pos = (label > 0).to(torch.float32)
        pos = self.label_pos.to(torch.float64)
        if weight is None:
            cnt_pos, cnt_all = float(pos.sum()), float(self.num_data)
        else:
            w = weight.to(torch.float64)
            cnt_pos, cnt_all = _f32((pos * w).sum()), _f32(w.sum())
        cnt_neg = cnt_all - cnt_pos
        self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self.label_weight_neg = cnt_pos / cnt_neg
            else:
                self.label_weight_pos = cnt_neg / cnt_pos
        elif self.config.scale_pos_weight != 1.0:
            self.label_weight_pos = self.config.scale_pos_weight

    def _spec(self):
        return ("logloss", self.sigmoid, float(self.label_weight_pos),
                float(self.label_weight_neg))

    def get_gradients(self, score):
        return _weighted(*grad_rows(self._spec(), score, self.label_pos),
                         self.weight)

    def fused_grad_spec(self):
        if not self.fuses(self.weight is not None):
            return None
        return self._spec(), self.label_pos

    def boost_from_score(self) -> float:
        if self._cnt_pos <= 0 or self._cnt_neg <= 0:
            return 0.0
        p = self._cnt_pos * self.label_weight_pos / (
            self._cnt_pos * self.label_weight_pos
            + self._cnt_neg * self.label_weight_neg)
        return float(np.log(p / (1.0 - p)) / self.sigmoid)

    def convert_output(self, score):
        return sigmoid(score, self.sigmoid)


# ---------------- multiclass (multiclass_objective.hpp:24) ----------------

def _onehot(label: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(label.to(torch.int64), k).to(
        torch.float32)


def _row_weighted(grad, hess, weight):
    if weight is None:
        return grad, hess
    return grad * weight[:, None], hess * weight[:, None]


class MulticlassSoftmax(ObjectiveFunction):
    """Softmax over K classes: score, g and h are [N, K]; no init score."""
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration = config.num_class

    def init(self, label, weight=None, group=None):
        super().init(label, weight, group)
        self.onehot = _onehot(label, self.num_class)

    def get_gradients(self, score):
        prob = softmax(score)
        factor = self.num_class / (self.num_class - 1.0)
        return _row_weighted(prob - self.onehot,
                             factor * prob * (1.0 - prob), self.weight)

    def convert_output(self, score):
        return softmax(score)


class MulticlassOVA(ObjectiveFunction):
    """K one-vs-all binary logloss models: [N, K] scores, no init score."""
    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration = config.num_class
        self.sigmoid = float(config.sigmoid)

    def init(self, label, weight=None, group=None):
        super().init(label, weight, group)
        self.onehot = _onehot(label, self.num_class)

    def get_gradients(self, score):
        s = self.sigmoid
        t = 2.0 * self.onehot - 1.0
        resp = 1.0 / (1.0 + torch.exp(t * s * score))
        return _row_weighted(-t * resp * s, s * s * resp * (1.0 - resp),
                             self.weight)

    def convert_output(self, score):
        return sigmoid(score, self.sigmoid)


# ---------------- cross-entropy (xentropy_objective.hpp) ----------------

class CrossEntropy(ObjectiveFunction):
    """Labels in [0, 1] (reference: CrossEntropy, xentropy_objective.hpp:21)."""
    name = "cross_entropy"

    def get_gradients(self, score):
        p = 1.0 / (1.0 + torch.exp(-score))
        return _weighted(p - self.label, p * (1.0 - p), self.weight)

    def boost_from_score(self) -> float:
        m = min(max(_wmean(self.label, self.weight), 1e-9), 1 - 1e-9)
        return float(np.log(m / (1 - m)))

    def convert_output(self, score):
        return sigmoid(score)


class CrossEntropyLambda(ObjectiveFunction):
    """The intensity parametrization (reference: CrossEntropyLambda,
    xentropy_objective.hpp); the weights enter the formula itself."""
    name = "cross_entropy_lambda"

    def get_gradients(self, score):
        w = self.weight if self.weight is not None else 1.0
        y = self.label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = torch.exp(-score)
        grad = (1.0 - y / torch.clamp(z, min=1e-12)) * w / (1.0 + enf)
        c = 1.0 / torch.clamp(1.0 - torch.exp(-w * hhat), min=1e-12)
        d = 1.0 / (1.0 + enf)
        hess = w * d * (1.0 - d) * (1.0 - y * c) \
            + w * w * d * d * y * c * (1.0 - c) * -1.0
        return grad, hess.abs() + 1e-6

    def boost_from_score(self) -> float:
        m = min(max(_wmean(self.label, None), 1e-9), 1 - 1e-9)
        return float(np.log(np.expm1(m))) if m > 0 else 0.0

    def convert_output(self, score):
        return torch.log1p(torch.exp(score))


# ---------------- ranking (rank_objective.hpp:23) ----------------

class LambdaRank(ObjectiveFunction):
    """LambdaRank with NDCG lambdas (reference: LambdaRank,
    objectives.py:432-507). The queries are padded into a [Q, M] doc grid;
    the pairs of each query are a masked [T, M] block, T =
    min(lambdarank_truncation_level, M) score-sorted positions against all
    M, run over query chunks of about 16M pair cells (lambdarank_grid).

    Each query's lambdas are normalised by its ideal DCG at the truncation
    level, over its top min(lambdarank_truncation_level, n) label gains, as
    LightGBM's CalMaxDCGAtK(truncation_level_, ...) in rank_objective.hpp
    takes it. Here the port departs from the reference
    (objectives.py:485-499), which sums the ideal DCG over all n documents:
    the two differ on every query with more relevant documents than the
    truncation level, and agree at a level at or above every query's
    size."""
    name = "lambdarank"

    def init(self, label, weight=None, group=None):
        super().init(label, weight, group)
        if group is None:
            raise LightGBMError("lambdarank requires query/group "
                                "information")
        self.group = np.asarray(group, dtype=np.int64)
        dev = label.device
        idx, msk = query_grid(self.group)
        self._idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        self._msk = torch.as_tensor(msk, device=dev)
        # the grid's real cells in row-major order: queries hold
        # consecutive rows, so cell k of them is row k
        self._cells = torch.as_tensor(np.flatnonzero(msk), device=dev)
        label_np = label.cpu().numpy()
        # label gains (default 2^i - 1)
        gains = self.config.label_gain
        if not gains:
            maxl = int(label_np.max())
            gains = [(1 << i) - 1 for i in range(max(maxl + 1, 2))]
        self._label_gain = torch.as_tensor(
            np.array(gains, dtype=np.float64).astype(np.float32), device=dev)
        self.sigmoid = self.config.sigmoid
        self.trunc = self.config.lambdarank_truncation_level
        self.norm = self.config.lambdarank_norm
        # the inverse ideal DCG of each query at the truncation level, in
        # f64, then f32
        lab_grid = np.where(msk, label_np[idx], -1)
        inv_max_dcg = np.zeros(len(self.group), dtype=np.float64)
        top = max(int(self.trunc), 1)
        for q in range(len(self.group)):
            ls = np.sort(lab_grid[q][msk[q]])[::-1][:top]
            g = np.array([gains[int(v)] for v in ls], dtype=np.float64)
            disc = 1.0 / np.log2(np.arange(len(ls)) + 2.0)
            dcg = float((g * disc).sum())
            inv_max_dcg[q] = 1.0 / dcg if dcg > 0 else 0.0
        self._inv_max_dcg = torch.as_tensor(inv_max_dcg.astype(np.float32),
                                            device=dev)

    def _scatter(self, grad_grid, hess_grid, score):
        """The grids back to rows, hessians floored at 1e-16. The
        reference scatter-adds every cell into zeros, the padded ones 0.0
        into row 0: each row ends as 0.0 plus its own cell, which is what
        a gather of the real cells plus 0.0 gives (and on the card without
        an atomic add a padded cell into one row)."""
        zero = torch.zeros_like(score)
        grad = zero + grad_grid.reshape(-1).index_select(0, self._cells)
        hess = zero + hess_grid.reshape(-1).index_select(0, self._cells)
        return _weighted(grad, torch.clamp(hess, min=1e-16), self.weight)

    def get_gradients(self, score):
        # the pair grid, from the rows into the grid and back
        with span("obj.pair_grid"):
            lab = self.label[self._idx] * self._msk
            sc = torch.where(self._msk, score[self._idx],
                             torch.full((), -np.inf, device=score.device))
            grad_grid, hess_grid = lambdarank_grid(
                sc, lab.to(torch.int32), self._msk, self._label_gain,
                self._inv_max_dcg, self.sigmoid, self.trunc, self.norm)
            return self._scatter(grad_grid, hess_grid, score)


def _sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over a short non-minor axis one slice after another, the order
    in which XLA:CPU reduces such an axis."""
    out = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        out = out + x.select(dim, i)
    return out


def lambdarank_grid(sc, lab, msk, label_gain, inv_max_dcg, sigmoid, trunc,
                    norm, max_cells: int = 1 << 24):
    """Pairwise NDCG lambdas of a [Q, M] grid (reference: _lambdarank_grid,
    objectives.py:514-607): for each query the pairs (i, j), i among the
    first T score-sorted positions, j > i, of different gains; with norm,
    the score-distance term and the log2(1 + denom) / denom scale. Runs
    over query chunks so that the [C, T, M] pair tensors stay near
    ``max_cells`` cells. Returns the (grad, hess) grids in doc order."""
    q, m = sc.shape
    dev = sc.device
    t = min(max(int(trunc), 1), m)
    chunk = int(max(1, min(q, max_cells // max(1, t * m))))
    disc = 1.0 / torch.log2(torch.arange(m, dtype=torch.float32,
                                         device=dev) + 2.0)
    pos_i = torch.arange(t, device=dev)[None, :, None]
    pos_j = torch.arange(m, device=dev)[None, None, :]
    gain = label_gain[lab.clamp(0, label_gain.shape[0] - 1).to(torch.int64)]
    inf = torch.full((), np.inf, device=dev)
    zero = torch.zeros((), device=dev)
    grad = torch.empty_like(sc)
    hess = torch.empty_like(sc)
    for c0 in range(0, q, chunk):
        sc_c, gain_c = sc[c0:c0 + chunk], gain[c0:c0 + chunk]
        msk_c, imd_c = msk[c0:c0 + chunk], inv_max_dcg[c0:c0 + chunk]
        order = torch.argsort(-torch.where(msk_c, sc_c, -inf), dim=1,
                              stable=True)
        ssc = sc_c.gather(1, order)
        sgain = gain_c.gather(1, order)
        smsk = msk_c.gather(1, order)
        s_i, s_j = ssc[:, :t, None], ssc[:, None, :]
        g_i, g_j = sgain[:, :t, None], sgain[:, None, :]
        d_i, d_j = disc[None, :t, None], disc[None, None, :]
        valid = (smsk[:, :t, None] & smsk[:, None, :] & (pos_j > pos_i)
                 & (g_i != g_j))
        delta_pair = ((g_i - g_j).abs() * (d_i - d_j).abs()
                      * imd_c[:, None, None])
        # high = the pair's doc of the higher label
        i_is_high = g_i > g_j
        ds = torch.where(i_is_high, s_i - s_j, s_j - s_i)
        if norm:
            # score-distance term, only where the query's scores spread
            best = torch.where(msk_c, sc_c, -inf).amax(dim=1)
            worst = torch.where(msk_c, sc_c, inf).amin(dim=1)
            spread = (best != worst)[:, None, None]
            delta_pair = torch.where(spread, delta_pair / (0.01 + ds.abs()),
                                     delta_pair)
        p = 1.0 / (1.0 + torch.exp(sigmoid * ds))
        lam = -sigmoid * p * delta_pair
        hes = sigmoid * sigmoid * p * (1.0 - p) * delta_pair
        lam = torch.where(valid, lam, zero)
        hes = torch.where(valid, hes, zero)
        sign_i = torch.where(i_is_high, 1.0, -1.0)
        # position j collects from every i row; the first t positions also
        # their own rows' sums
        grad_s = _sum_in_order(-sign_i * lam, 1)
        grad_s[:, :t] += (sign_i * lam).sum(dim=2)
        hess_s = _sum_in_order(hes, 1)
        hess_s[:, :t] += hes.sum(dim=2)
        if norm:
            denom = 2.0 * lam.abs().sum(dim=(1, 2))[:, None]
            scale = torch.where(
                denom > 0.0, torch.log2(1.0 + denom)
                / torch.clamp(denom, min=1e-30), torch.ones_like(denom))
            grad_s = grad_s * scale
            hess_s = hess_s * scale
        # back to doc order
        grad[c0:c0 + chunk] = torch.zeros_like(sc_c).scatter_(1, order,
                                                              grad_s)
        hess[c0:c0 + chunk] = torch.zeros_like(sc_c).scatter_(1, order,
                                                              hess_s)
    return grad, hess


class RankXENDCG(LambdaRank):
    """XE-NDCG (reference: RankXENDCG, objectives.py:610-638). The
    reference draws Gumbel noise and adds it times 0.0 (:629); its uniforms
    lie in [1e-20, 1), so the noise is finite and phi is the gain exactly:
    the port leaves the draw out."""
    name = "rank_xendcg"

    def get_gradients(self, score):
        dev = score.device
        lab = self.label[self._idx] * self._msk
        big = torch.full((), -1e30, device=dev)
        sc = torch.where(self._msk, score[self._idx], big)
        z = torch.where(self._msk, sc, big)
        u = torch.exp(z - z.amax(dim=1, keepdim=True))
        rho = u / u.sum(dim=1, keepdim=True)
        gain = self._label_gain[lab.to(torch.int32).clamp(
            0, self._label_gain.shape[0] - 1).to(torch.int64)]
        phi = gain
        denom = torch.where(self._msk, phi, torch.zeros((), device=dev)
                            ).sum(dim=1, keepdim=True) + 1e-9
        grad_grid = rho - phi / denom
        hess_grid = rho * (1.0 - rho)
        return self._scatter(grad_grid, hess_grid, score)


# ---------------- percentile helpers (L1-family leaf renewal) ----------------

def weighted_percentile(values: torch.Tensor,
                        weights: Optional[torch.Tensor],
                        alpha: float) -> torch.Tensor:
    """The alpha-percentile of values (reference: _weighted_percentile):
    unweighted, the sorted value at int(alpha * n); weighted, the first
    sorted value whose cumulative weight reaches f32(alpha) * total."""
    v, order = torch.sort(values, stable=True)
    n = v.shape[0]
    if weights is None:
        return v[min(max(int(alpha * n), 0), n - 1)]
    cw = torch.cumsum(weights[order].to(torch.float64), 0)
    # a blocking copy of a Python scalar
    with span("sync.objective"):
        a = torch.tensor(_f32(alpha), dtype=torch.float32, device=v.device)
    cutoff = a * cw[-1].to(torch.float32)
    idx = torch.searchsorted(cw, cutoff.to(torch.float64).reshape(1))
    return v[idx.clamp(0, n - 1)][0]


def leaf_percentile(residual: torch.Tensor, leaf_id: torch.Tensor,
                    num_leaves: int, alpha: float,
                    weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-leaf weighted alpha-percentile of the residuals [N] f32: [L] f32,
    0 for an empty leaf (reference: _leaf_percentile).

    One stable sort of the reference's f32 key ``leaf * big * 2 +
    residual`` groups the rows by leaf, residual order within a leaf as
    that key rounds (ties keep row order, as jnp.argsort does). The
    cumulative weights run in f64, where sums of f32 weights are exact up
    to 2^29 rows of weight below 16, so the pick does not depend on the
    device's summation order; the cutoff is the reference's f32
    ``alpha * leaf total``. A leaf's pick is its row whose cumulative
    weight first reaches the cutoff: at most one row a leaf, so the rows
    picked are written without the reference's scatter-max, whose
    10.5M-row contention on one table cell cost the card 56 ms a tree."""
    dev = residual.device
    w = weight if weight is not None else torch.ones_like(residual)
    big = (residual.abs().max() + 1.0) * 2.0
    key = leaf_id.to(torch.float32) * big * 2 + residual
    order = torch.sort(key, stable=True).indices
    r_s, l_s = residual[order], leaf_id[order].to(torch.int64)
    w_s = w[order].to(torch.float64)
    cw = torch.cumsum(w_s, 0)
    # the rows of leaf l are [start[l], end[l]) of the sorted order
    leaves = torch.arange(num_leaves, device=dev)
    start = torch.searchsorted(l_s, leaves)
    end = torch.searchsorted(l_s, leaves, right=True)
    cw0 = torch.cat([cw.new_zeros(1), cw])
    before = cw0[start]
    # a blocking copy of a Python scalar, and the picked rows' count
    with span("sync.objective"):
        a = torch.tensor(_f32(alpha), dtype=torch.float32, device=dev)
    cutoff = a * (cw0[end] - before).to(torch.float32)
    cw_in = cw - before[l_s]
    c = cutoff.to(torch.float64)[l_s]
    with span("sync.objective"):
        hit = ((cw_in >= c) & (cw_in - w_s < c)).nonzero().squeeze(1)
    out = torch.zeros(num_leaves, dtype=torch.float32, device=dev)
    out[l_s[hit]] = r_s[hit]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


# ---------------- factory (objective_function.cpp:16) ----------------

_CLASSES: Dict[str, type] = {
    "regression": RegressionL2, "regression_l1": RegressionL1,
    "huber": Huber, "fair": Fair, "poisson": Poisson, "quantile": Quantile,
    "mape": Mape, "gamma": Gamma, "tweedie": Tweedie, "binary": Binary,
    "multiclass": MulticlassSoftmax, "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy, "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdaRank, "rank_xendcg": RankXENDCG,
}


def create_objective(name: str, config: Config
                     ) -> Optional[ObjectiveFunction]:
    """The objective of a configured name; None for a custom one ("none",
    "custom", ...). l2_root / rmse train as L2 (reg_sqrt off)."""
    name = str(name or "regression").lower()
    kind = objective_kind(name)
    if name in ("l2_root", "root_mean_squared_error", "rmse"):
        config.reg_sqrt = False
    if kind == "none":
        return None
    cls = _CLASSES[kind]
    obj = cls(config)
    obj.name = name if name not in ("l2", "mse") else cls.name
    return obj
