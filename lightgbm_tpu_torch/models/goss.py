"""GOSS: Gradient-based One-Side Sampling.

Port of ``lightgbm_tpu/models/goss.py`` (reference: goss.hpp:25): each
iteration keeps the ``top_rate`` share of rows with the largest |g * h|
(every row tied with the k-th value too), samples ``other_rate`` of the
rest by the threefry replica's uniforms, the k2 smallest, and weights those
by ``(1 - top_rate) / other_rate``. The weights multiply g and h, and the
count channel is ``weight > 0``. GOSS hands the step materialized
gradients, so the fused front stays off and the quantized histograms keep
all three channels (``GBDT._custom_grad``).
"""
from __future__ import annotations

import torch

from ..log import LightGBMError, warning
from ..objectives import class_sum
from ..utils import threefry
from .gbdt import GBDT, _f32


class GOSS(GBDT):
    _custom_grad = True

    def __init__(self, config, train_set, objective, metrics=None):
        super().__init__(config, train_set, objective, metrics)
        if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
            warning("cannot use bagging in GOSS")
        self.top_rate = config.top_rate
        self.other_rate = config.other_rate
        if self.top_rate + self.other_rate > 1.0:
            raise LightGBMError("top_rate + other_rate <= 1.0 required in "
                                "GOSS")

    def _update_bag(self, iter_idx: int, grad, hess) -> None:
        n = self.train_set.num_data
        k1 = max(1, int(n * self.top_rate))
        k2 = max(1, int(n * self.other_rate))
        # a multiclass row's score sums its classes' |g * h|
        score = (grad * hess).abs()
        if score.dim() > 1:
            score = class_sum(score)
        # the top-k1 |g * h| rows keep weight 1
        kth = torch.topk(score, k1, sorted=False).values.min()
        top_mask = score >= kth
        # the k2 smallest uniforms of the other rows are sampled
        self._bag_key, sub = threefry.split(self._bag_key)
        u = threefry.uniform(sub, (n,), self.device)
        u = torch.where(top_mask, torch.full_like(u, 2.0), u)
        kth_u = torch.topk(-u, k2, sorted=False).values.min()
        other_mask = ~top_mask & (u <= -kth_u)
        multiply = _f32((1.0 - self.top_rate) / self.other_rate)
        self._bag_mask = torch.where(
            top_mask, torch.ones_like(u),
            torch.where(other_mask, torch.full_like(u, multiply),
                        torch.zeros_like(u)))
