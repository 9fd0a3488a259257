"""HIGGS-shaped binary rows.

The model is a copy of ``synth_higgs`` in ``scripts/torch_ab_train.py``
(itself a copy of ``bench.py synth_higgs``): 28 standard normal features;
the label is drawn with probability sigmoid(0.7 x[:8] . w + 0.5 |x8| x9 -
0.4 x10^2 + 0.3). Here the rows are drawn on the card with a
``torch.Generator`` from the run's seed, while the 8 weights ``w`` come
from the configuration's fixed ``weights_seed``, so that every seed draws
rows of one problem and the work per tree does not move with the seed.
One draw of ``rows_train + rows_valid`` rows is made; the last
``rows_valid`` are the validation set, as HIGGS's test set is the last
500,000 rows of its file.
"""
from __future__ import annotations

import torch

from .data import Data, generator


def make(cfg: dict, seed: int, device) -> Data:
    n_train, n_valid = int(cfg["rows_train"]), int(cfg["rows_valid"])
    n, f = n_train + n_valid, int(cfg["features"])
    w = torch.randn(8, generator=generator(cfg["weights_seed"], "cpu"),
                    dtype=torch.float64).to(device)
    gen = generator(seed, device)
    x = torch.randn((n, f), generator=gen, device=device,
                    dtype=torch.float32)
    logit = ((x[:, :8].to(torch.float64) @ w) * 0.7
             + 0.5 * x[:, 8].abs().to(torch.float64) * x[:, 9]
             - 0.4 * x[:, 10].to(torch.float64) ** 2 + 0.3)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    y = (u < torch.sigmoid(logit)).to(torch.float32)
    return Data(x[:n_train], y[:n_train], x[n_train:], y[n_train:])
