"""DART: Dropouts meet Multiple Additive Regression Trees.

Port of ``lightgbm_tpu/models/dart.py`` (reference: dart.hpp:23): before
each iteration a subset of the earlier iterations is dropped from the train
and valid scores, the new trees fit the residual, and then the new and the
dropped trees are rescaled (dart.hpp:58, :97-115). The drops come from a
numpy ``RandomState(drop_seed)``, so card and CPU draw the same lists; the
tree weights live on the host. A dropped or rescaled tree leaves and
re-enters the scores through ``route_bins`` and the ``take_small`` kernel.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .gbdt import GBDT, tree_delta


class DART(GBDT):

    def __init__(self, config, train_set, objective, metrics=None):
        super().__init__(config, train_set, objective, metrics)
        self.drop_rate = config.drop_rate
        self.max_drop = config.max_drop
        self.skip_drop = config.skip_drop
        self.uniform_drop = config.uniform_drop
        self.xgboost_dart_mode = config.xgboost_dart_mode
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weights: List[float] = []   # per stored tree
        self.drop_idx: List[int] = []         # this iteration's drops

    def train_one_iter(self, grad=None, hess=None) -> bool:
        self._select_and_drop()
        finished = super().train_one_iter(grad, hess)
        # rescaled trees make the host-tree cache stale
        self.models_host = []
        return finished

    def _end_iteration(self, finished: bool) -> bool:
        """Normalize every iteration, a finishing one too, before its
        stumps leave the model: the reference normalizes unconditionally
        (dart.py:38-39) and pops the stumps only when training ends. The
        stumps' weights leave with them."""
        self._normalize()
        finished = super()._end_iteration(finished)
        del self.tree_weights[len(self.models_dev):]
        return finished

    def _select_and_drop(self) -> None:
        """Choose this iteration's drops (dart.hpp:97-115 DroppingTrees) and
        take their trees out of the scores."""
        self.drop_idx = []
        k = self.num_tree_per_iteration
        n_iters = len(self.models_dev) // max(k, 1)
        if n_iters == 0 or self._drop_rng.rand() < self.skip_drop:
            return
        if self.uniform_drop:
            mask = self._drop_rng.rand(n_iters) < self.drop_rate
            drop = list(np.nonzero(mask)[0])
        else:
            w = np.array([self.tree_weights[i * k] for i in range(n_iters)])
            p = (1.0 - w) if self.xgboost_dart_mode else np.ones(n_iters)
            p = p / max(p.sum(), 1e-12)
            n_drop = max(1, int(round(n_iters * self.drop_rate)))
            n_drop = min(n_drop, self.max_drop if self.max_drop > 0
                         else n_drop)
            drop = list(self._drop_rng.choice(
                n_iters, size=min(n_drop, n_iters), replace=False, p=p))
        if self.max_drop > 0:
            drop = drop[: self.max_drop]
        self.drop_idx = sorted(int(d) for d in drop)
        for it in self.drop_idx:
            for cls in range(k):
                self._add_tree_score(it * k + cls, cls, -1.0)

    def _add_tree_score(self, tree_idx: int, cls: int, sign: float) -> None:
        """Add (sign 1) or remove (-1) a stored tree's contribution to the
        train and valid scores."""
        tree = self.models_dev[tree_idx]
        self.train_score = self._apply_tree_delta(
            self.train_score, tree_delta(tree, self.train_set) * sign, cls)
        for i, vs in enumerate(self.valid_sets):
            self.valid_scores[i] = self._apply_tree_delta(
                self.valid_scores[i], tree_delta(tree, vs) * sign, cls)

    def _normalize(self) -> None:
        """Weigh the new trees 1 / (drops + 1) and shrink the dropped ones
        by drops / (drops + 1) (lr-scaled in xgboost_dart_mode), then put
        the dropped trees back."""
        k = self.num_tree_per_iteration
        new_idx = list(range(len(self.models_dev) - k, len(self.models_dev)))
        n_drop = len(self.drop_idx)
        self.tree_weights.extend([1.0] * k)
        if n_drop == 0:
            return
        if self.xgboost_dart_mode:
            new_w = self.learning_rate / (n_drop + self.learning_rate)
            factor = n_drop / (n_drop + self.learning_rate)
        else:
            new_w = 1.0 / (n_drop + 1.0)
            factor = n_drop / (n_drop + 1.0)
        for ti in new_idx:
            self._scale_tree(ti, new_w, in_score=True)
            self.tree_weights[ti] = new_w
        for it in self.drop_idx:
            for cls in range(k):
                ti = it * k + cls
                self._scale_tree(ti, factor, in_score=False)
                self.tree_weights[ti] *= factor
                self._add_tree_score(ti, cls, 1.0)

    def _scale_tree(self, tree_idx: int, scale: float, in_score: bool) -> None:
        """Scale a stored tree's values; a tree in the scores leaves them
        and returns scaled."""
        cls = tree_idx % self.num_tree_per_iteration
        if in_score:
            self._add_tree_score(tree_idx, cls, -1.0)
        tree = self.models_dev[tree_idx]
        self.models_dev[tree_idx] = tree._replace(
            leaf_value=tree.leaf_value * scale,
            internal_value=tree.internal_value * scale)
        if in_score:
            self._add_tree_score(tree_idx, cls, 1.0)

    # ---- crash-safe resume (reference: dart.py:121-129) ----
    def _extra_resume_state(self, arrays, meta) -> None:
        arrays["dart_tree_weights"] = np.asarray(self.tree_weights,
                                                 dtype=np.float64)

    def _apply_extra_resume_state(self, arrays, meta) -> None:
        self.tree_weights = [float(w) for w in
                             arrays.get("dart_tree_weights", [])]
        self.drop_idx = []
