"""The validation metrics, in f64 on the raw score.

``auc``: the Mann-Whitney statistic, tied scores sharing their mean rank.
``ndcg``: mean NDCG@k over the queries, gains 2^label - 1, discounts
1 / log2(2 + position), documents sorted by score descending with ties in
document order; a query without a relevant document counts 1.
"""
from __future__ import annotations

import torch

from .objectives import QueryGrid


def auc(label: torch.Tensor, score: torch.Tensor) -> float:
    s = score.to(torch.float64)
    y = (label > 0).to(torch.float64)
    order = torch.argsort(s)
    ss, ys = s[order], y[order]
    n = ss.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=s.device)
    first[1:] = ss[1:] != ss[:-1]
    tie = torch.cumsum(first.to(torch.int64), 0) - 1
    pos = torch.arange(1, n + 1, dtype=torch.float64, device=s.device)
    ntie = int(tie[-1]) + 1
    rank_sum = torch.zeros(ntie, dtype=torch.float64,
                           device=s.device).index_add_(0, tie, pos)
    cnt = torch.zeros(ntie, dtype=torch.float64,
                      device=s.device).index_add_(0, tie, torch.ones_like(pos))
    rank = (rank_sum / cnt)[tie]
    n_pos = float(ys.sum())
    n_neg = n - n_pos
    return float(((rank * ys).sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def ndcg(label: torch.Tensor, score: torch.Tensor, grid: QueryGrid,
         k: int) -> float:
    dev = score.device
    f64 = torch.float64
    s = torch.where(grid.mask, score.to(f64)[grid.rows],
                    torch.full((), -float("inf"), dtype=f64, device=dev))
    gain = torch.where(grid.mask, 2.0 ** label.to(f64)[grid.rows] - 1.0,
                       torch.zeros((), dtype=f64, device=dev))
    order = torch.argsort(-s, dim=1, stable=True)
    disc = 1.0 / torch.log2(torch.arange(grid.m, dtype=f64, device=dev) + 2.0)
    top = (torch.arange(grid.m, device=dev) < k).to(f64)
    dcg = (gain.gather(1, order) * disc * top).sum(dim=1)
    ideal = torch.sort(gain, dim=1, descending=True).values
    idcg = (ideal * disc * top).sum(dim=1)
    per_query = torch.where(idcg > 0, dcg / idcg.clamp(min=1e-300),
                            torch.ones_like(idcg))
    return float(per_query.mean())
