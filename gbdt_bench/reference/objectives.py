"""Gradients and hessians of the objectives the cells train, in f32.

``binary``: LightGBM's binary logloss (binary_objective.hpp) with sigmoid
1 and unit label weights: t = 2 y - 1, r = 1 / (1 + exp(t s)), g = -t r,
h = r (1 - r); the initial score is log(p / (1 - p)) of the positive share.

``lambdarank``: LightGBM's LambdaRank (rank_objective.hpp) with NDCG
lambdas: each query's documents sorted by score, descending, ties kept in
document order; every pair (i, j) with i among the first
``truncation_level`` sorted positions, j after i, and different labels;
delta = |gain_i - gain_j| |disc_i - disc_j| / maxDCG@T (the ideal DCG of
the first ``truncation_level`` = T positions), divided by (0.01 +
|s_high - s_low|) when the query's scores are not all equal (``norm``);
p = 1 / (1 + exp(s_high - s_low)); lambda = -p delta to the higher-labelled
document and +p delta to the other; hessian p (1 - p) delta to both; then,
with norm, every document of the query scaled by log2(1 + S) / S, S the
sum over the pairs of 2 |lambda|. Gains 2^label - 1, discounts
1 / log2(2 + position). Hessians are floored at 1e-16.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def binary_init_score(label: torch.Tensor) -> float:
    pos = float((label > 0).to(torch.float64).sum())
    p = pos / label.shape[0]
    return math.log(p / (1.0 - p))


def binary_gradients(score: torch.Tensor, label: torch.Tensor):
    t = 2.0 * (label > 0).to(torch.float32) - 1.0
    r = 1.0 / (1.0 + torch.exp(t * score))
    return -t * r, r * (1.0 - r)


class QueryGrid:
    """Queries of consecutive rows padded into a [Q, M] grid."""

    def __init__(self, sizes: np.ndarray, device: torch.device):
        sizes = np.asarray(sizes, dtype=np.int64)
        self.q, self.m = len(sizes), int(sizes.max())
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        col = np.arange(self.m)[None, :]
        self.mask = torch.as_tensor(col < sizes[:, None], device=device)
        self.rows = torch.as_tensor(
            np.where(col < sizes[:, None], starts[:, None] + col, 0),
            device=device)
        self.sizes = sizes


def max_dcg_inv(label: torch.Tensor, grid: QueryGrid, k: int) -> torch.Tensor:
    """1 / ideal DCG@k of each query (0 when none is relevant), f64: k is
    the truncation level (LightGBM's CalMaxDCGAtK(truncation_level_))."""
    gain = torch.where(grid.mask, 2.0 ** label.to(torch.float64)[grid.rows]
                       - 1.0, torch.zeros((), dtype=torch.float64,
                                          device=label.device))
    ideal = torch.sort(gain, dim=1, descending=True).values
    disc = 1.0 / torch.log2(torch.arange(grid.m, dtype=torch.float64,
                                         device=label.device) + 2.0)
    top = (torch.arange(grid.m, device=label.device) < k).to(torch.float64)
    dcg = (ideal * disc * top).sum(dim=1)
    return torch.where(dcg > 0, 1.0 / dcg.clamp(min=1e-300),
                       torch.zeros_like(dcg))


def lambdarank_gradients(score: torch.Tensor, label: torch.Tensor,
                         grid: QueryGrid, inv_max_dcg: torch.Tensor,
                         truncation_level: int = 20,
                         chunk_cells: int = 1 << 24):
    """(g, h) [N] f32 of LambdaRank at ``score`` [N] f32."""
    dev = score.device
    q, m = grid.q, grid.m
    t = min(truncation_level, m)
    g_out = torch.zeros_like(score)
    h_out = torch.zeros_like(score)
    disc = 1.0 / torch.log2(torch.arange(m, dtype=torch.float32,
                                         device=dev) + 2.0)
    step = max(1, chunk_cells // (t * m))
    pos_i = torch.arange(t, device=dev)[None, :, None]
    pos_j = torch.arange(m, device=dev)[None, None, :]
    for q0 in range(0, q, step):
        rows = grid.rows[q0:q0 + step]
        msk = grid.mask[q0:q0 + step]
        s = torch.where(msk, score[rows],
                        torch.full((), -math.inf, device=dev))
        order = torch.argsort(-s, dim=1, stable=True)
        srows = rows.gather(1, order)
        smsk = msk.gather(1, order)
        ss = torch.where(smsk, score[srows], torch.zeros((), device=dev))
        sg = torch.where(smsk, 2.0 ** label[srows] - 1.0,
                         torch.zeros((), device=dev))
        spread = (s.amax(dim=1) != torch.where(
            msk, s, torch.full((), math.inf, device=dev)).amin(dim=1))
        gi, gj = sg[:, :t, None], sg[:, None, :]
        si, sj = ss[:, :t, None], ss[:, None, :]
        pair = (smsk[:, :t, None] & smsk[:, None, :] & (pos_j > pos_i)
                & (gi != gj))
        hi_first = gi > gj
        ds = torch.where(hi_first, si - sj, sj - si)
        delta = ((gi - gj).abs() * (disc[None, :t, None]
                                   - disc[None, None, :]).abs()
                 * inv_max_dcg[q0:q0 + step, None, None].to(torch.float32))
        delta = torch.where(spread[:, None, None],
                            delta / (0.01 + ds.abs()), delta)
        p = 1.0 / (1.0 + torch.exp(ds))
        lam = torch.where(pair, p * delta, torch.zeros((), device=dev))
        hes = torch.where(pair, p * (1.0 - p) * delta,
                          torch.zeros((), device=dev))
        # the higher-labelled document of a pair is pushed up (g < 0)
        sign_i = torch.where(hi_first, -1.0, 1.0)
        g_s = (-sign_i * lam).sum(dim=1)
        g_s[:, :t] += (sign_i * lam).sum(dim=2)
        h_s = hes.sum(dim=1)
        h_s[:, :t] += hes.sum(dim=2)
        total = 2.0 * lam.sum(dim=(1, 2))
        scale = torch.where(total > 0, torch.log2(1.0 + total)
                            / total.clamp(min=1e-30), torch.ones_like(total))
        g_s = g_s * scale[:, None]
        h_s = h_s * scale[:, None]
        keep = smsk.reshape(-1)
        g_out[srows.reshape(-1)[keep]] = g_s.reshape(-1)[keep]
        h_out[srows.reshape(-1)[keep]] = h_s.reshape(-1)[keep]
    return g_out, torch.clamp(h_out, min=1e-16)
