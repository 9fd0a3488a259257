"""Yahoo-LTR-shaped ranking rows.

The model is a copy of ``synth_ranking`` in ``scripts/parity_bench.py``:
700 standard normal features, of which the first 40 carry a linear score
(weights from the configuration's fixed ``weights_seed``, divided by
sqrt(40)) plus 0.7 normal noise; graded relevance 0-4 cuts that score at
its 55%, 80%, 93% and 98.5% quantiles; queries hold consecutive rows,
their sizes max(2, geometric(1 / 25)). The query sizes are drawn once from
``weights_seed``: whole queries up to ``rows_train`` rows train and the next
``queries_valid`` validate. The run's seed shuffles the order of each set's
sizes and draws the rows on the card with a ``torch.Generator``, so every
seed has the same rows, queries and pairs in another arrangement.
"""
from __future__ import annotations

import numpy as np
import torch

from .data import Data, generator


def query_sizes(cfg: dict):
    rng = np.random.RandomState(int(cfg["weights_seed"]))
    mean = float(cfg["mean_docs"])
    train, total = [], 0
    while True:
        s = max(2, int(rng.geometric(1.0 / mean)))
        if total + s > int(cfg["rows_train"]):
            break
        train.append(s)
        total += s
    valid = [max(2, int(rng.geometric(1.0 / mean)))
             for _ in range(int(cfg["queries_valid"]))]
    return np.asarray(train, np.int64), np.asarray(valid, np.int64)


def make(cfg: dict, seed: int, device) -> Data:
    f, rel = int(cfg["features"]), int(cfg["relevant_features"])
    g_train, g_valid = query_sizes(cfg)
    order = np.random.default_rng(int(seed))
    g_train = g_train[order.permutation(len(g_train))]
    g_valid = g_valid[order.permutation(len(g_valid))]
    n_train = int(g_train.sum())
    n = n_train + int(g_valid.sum())
    w = torch.zeros(f, dtype=torch.float64)
    w[:rel] = torch.randn(rel, generator=generator(cfg["weights_seed"],
                                                   "cpu"),
                          dtype=torch.float64)
    w = w.to(device)
    gen = generator(seed, device)
    x = torch.randn((n, f), generator=gen, device=device,
                    dtype=torch.float32)
    score = (x.to(torch.float64) @ w / rel ** 0.5
             + 0.7 * torch.randn(n, generator=gen, device=device,
                                 dtype=torch.float64))
    cuts = torch.quantile(score, torch.tensor([0.55, 0.8, 0.93, 0.985],
                                              dtype=torch.float64,
                                              device=device))
    y = torch.bucketize(score, cuts, right=True).to(torch.float32)
    return Data(x[:n_train], y[:n_train], x[n_train:], y[n_train:],
                g_train, g_valid)
