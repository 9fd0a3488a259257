"""Random forest.

Port of ``lightgbm_tpu/models/rf.py`` (reference: rf.hpp:25): every tree
fits the gradients at the init score, taken once (no boosting), on its own
bag or feature sample, without shrinkage; the scores are the running mean
of the trees (``average_output``, written into the model text, where
prediction divides the sum of the trees by their iterations).
"""
from __future__ import annotations

import numpy as np
import torch

from ..log import LightGBMError
from ..obs.tracing import span
from .gbdt import GBDT


class RF(GBDT):
    average_output = True
    # every tree is handed the constant gradients as materialized rows:
    # the reference's custom step, no fused front
    _custom_grad = True

    def __init__(self, config, train_set, objective, metrics=None):
        if not (config.bagging_freq > 0
                and (config.bagging_fraction < 1.0
                     or config.feature_fraction < 1.0)):
            raise LightGBMError(
                "RF mode requires bagging (bagging_freq > 0 and "
                "bagging_fraction < 1.0) or feature_fraction < 1.0")
        super().__init__(config, train_set, objective, metrics)
        self._const_gh = None

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One tree a class on the constant gradients, handed to the step as
        materialized rows (the reference's custom step: no fused front)."""
        if grad is None:
            if self._const_gh is None:
                k = self.num_tree_per_iteration
                if self.config.boost_from_average:
                    for cls in range(k):
                        self.init_scores[cls] = \
                            self.objective.boost_from_score()
                with span("sync.init_score"):
                    shift = torch.as_tensor(
                        np.asarray(self.init_scores, dtype=np.float32),
                        device=self.device)
                const = torch.zeros(self._score_shape, dtype=torch.float32,
                                    device=self.device) \
                    + (shift[0] if k == 1 else shift)
                self._const_gh = self.objective.get_gradients(const)
            grad, hess = self._const_gh
        return super().train_one_iter(grad, hess)

    def _apply_tree_delta(self, score, delta, cls):
        """The running mean over the iter_ + 1 trees so far (rf.hpp
        TrainOneIter), train and valid scores alike."""
        with span("sync.rf_mean"):
            titer = torch.tensor(float(self.iter_ + 1), dtype=torch.float32,
                                 device=score.device)
        if self.num_tree_per_iteration == 1:
            return (score * (titer - 1.0) + delta) / titer
        score[:, cls] = (score[:, cls] * (titer - 1.0) + delta) / titer
        return score
