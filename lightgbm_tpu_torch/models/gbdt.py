"""GBDT boosting core: the serial eager step.

Port of the serial path of ``lightgbm_tpu/models/gbdt.py``: init score and
boost-from-average (:645-669), the quantized-gradient and const-hessian
resolution (:123-134, :737-766), the fused-front gate (``_fused_front``,
:714-727) and the unfused step's materialized gradients (:929-934,
:969-976), the per-tree dither seed ``qseed = iter * k + cls`` (:1504),
shrinkage (:952-954), the score update through ``take_small`` (:955-956)
and the first-iteration bias folded into the stored tree (:1326-1339). One
iteration grows one tree (one model per iteration on this slice) with the
grower ``_grow_fn`` picks (:1297-1304): ``grow_tree_depthwise`` for
``grow_policy=depthwise``, the leaf-wise ``grow_tree`` otherwise; train
and valid scores stay on the training device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..log import warning
from ..ops.gather import take_small
from ..ops.grow import GrowParams, TreeArrays, grow_tree
from ..ops.grow_depthwise import grow_tree_depthwise
from ..ops.histogram import ACC_ROWS_MAX
from ..ops.predict import route_bins
from ..ops.split import SplitParams
from .tree import Tree

K_EPSILON = 1e-15


def padded_bins(max_num_bins: int) -> int:
    """The reference's bin-axis padding (gbdt.py:110)."""
    return 64 if max_num_bins <= 64 else (128 if max_num_bins <= 128 else 256)


def resolve_quant(config: Config) -> bool:
    """use_quantized_grad as the reference resolves it (gbdt.py:123-134):
    true, or auto on the kernel path, turns the int8 histograms on, but
    only for the depthwise grower. The port always runs the kernel path
    (its CPU run stands in for the card), so auto means on."""
    uq = str(config.use_quantized_grad).lower()
    quant_on = uq in ("true", "1", "auto")
    if quant_on and config.grow_policy != "depthwise":
        if uq in ("true", "1"):
            warning("use_quantized_grad only applies to the depthwise "
                    f"grower; ignoring for grow_policy={config.grow_policy}")
        quant_on = False
    return quant_on


class GBDT:
    """Gradient Boosting Decision Tree trainer (reference: GBDT, gbdt.h:33)."""

    def __init__(self, config: Config, train_set, objective, metrics=None):
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.metrics = list(metrics or [])
        self.iter_ = 0
        self.learning_rate = float(config.learning_rate)
        self.device = train_set.device
        n = train_set.num_data
        f = train_set.num_features
        B = padded_bins(train_set.max_num_bins)
        objective.init(train_set.label)
        spec, self._aux = objective.fused_grad_spec()
        quant = resolve_quant(config)
        self.depthwise = config.grow_policy == "depthwise"
        # the reference's fused-front gate: the quantized depthwise grower
        # only, and the fused kernels hold an [F * B] root histogram of at
        # most 2048 cells; wider data materializes the gradients and takes
        # the unfused front
        if not (quant and self.depthwise) or f * B > ACC_ROWS_MAX:
            spec = None
        self.gp = GrowParams(
            num_leaves=config.num_leaves, max_depth=config.max_depth,
            max_bin=B,
            split=SplitParams(
                lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
                min_gain_to_split=config.min_gain_to_split,
                min_data_in_leaf=config.min_data_in_leaf,
                min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
                max_delta_step=config.max_delta_step),
            quant=quant,
            # constant-hessian elision is a property of the quantized
            # channels (gbdt.py:737-744)
            const_hess=quant and bool(objective.is_constant_hessian),
            fused_obj=spec)
        self.train_score = torch.zeros(n, dtype=torch.float32,
                                       device=self.device)
        self._bag = torch.ones(n, dtype=torch.float32, device=self.device)
        self._fmask = torch.ones(f, dtype=torch.bool, device=self.device)
        self.init_score = 0.0
        self.models_dev: List[TreeArrays] = []
        self.models_host: List[Tree] = []
        # histogram passes of each tree after its root: one per level
        # (depthwise) or per split (lossguide)
        self.hist_passes: List[int] = []
        self.valid_sets: List = []
        self.valid_names: List[str] = []
        self.valid_scores: List[torch.Tensor] = []

    def add_valid(self, valid_set, name: str) -> None:
        if self.models_dev:
            raise NotImplementedError("adding a valid set after training "
                                      "started is ROADMAP.md queue A14")
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        self.valid_scores.append(torch.zeros(
            valid_set.num_data, dtype=torch.float32, device=self.device))

    def train_one_iter(self) -> bool:
        """One boosting iteration; True when the tree could not split (the
        reference then stops without adding it, gbdt.cpp:430)."""
        if (self.iter_ == 0 and self.config.boost_from_average
                and not self.models_dev):
            init = self.objective.boost_from_score()
            if abs(init) > K_EPSILON:
                self.init_score = init
                shift = float(np.float32(init))
                self.train_score = self.train_score + shift
                self.valid_scores = [s + shift for s in self.valid_scores]
        ts = self.train_set
        bag = self._bag
        if self.gp.fused_obj is not None:
            # fused front: the kernels recompute the gradients from (score,
            # aux, bag) and never materialize them
            ghc = (None, None, None)
            fused = (self.train_score, self._aux, bag)
        else:
            grad, hess = self.objective.get_gradients(self.train_score)
            ghc = (grad * bag, hess * bag, (bag > 0).to(torch.float32))
            fused = None
        if self.depthwise:
            tree, leaf_id, passes = grow_tree_depthwise(
                ts.bins_T, *ghc, ts.num_bins_dev, ts.na_bin_dev, self._fmask,
                self.gp, qseed=self.iter_, fused=fused, bins=ts.bins)
        else:
            tree, leaf_id, passes = grow_tree(
                ts.bins_T, *ghc, ts.num_bins_dev, ts.na_bin_dev, self._fmask,
                self.gp, bins=ts.bins)
        self.hist_passes.append(passes)
        if tree.num_leaves <= 1:
            self.iter_ += 1
            return True
        shrink = torch.tensor(self.learning_rate, dtype=torch.float32,
                              device=self.device)
        tree = tree._replace(leaf_value=tree.leaf_value * shrink,
                             internal_value=tree.internal_value * shrink)
        self.train_score = self.train_score + take_small(tree.leaf_value,
                                                         leaf_id)
        bias = self.init_score if (self.iter_ == 0
                                   and abs(self.init_score) > K_EPSILON) \
            else 0.0
        if bias:
            tree = tree._replace(leaf_value=tree.leaf_value + bias,
                                 internal_value=tree.internal_value + bias)
        for i, vs in enumerate(self.valid_sets):
            leaf = route_bins(tree, vs.bins, vs.na_bin_dev)
            self.valid_scores[i] = self.valid_scores[i] + (
                take_small(tree.leaf_value, leaf) - bias)
        self.models_dev.append(tree)
        self.iter_ += 1
        return False

    # ---- evaluation ----
    def _eval(self, name: str, score: torch.Tensor, data
              ) -> List[Tuple[str, str, float, bool]]:
        conv = self.objective.convert_output(score.to(torch.float64))
        return [(name, m.name, m(data.label, conv if m.use_prob else score),
                 m.greater_is_better) for m in self.metrics]

    def eval_train(self):
        return self._eval("training", self.train_score, self.train_set)

    def eval_valid(self):
        out = []
        for name, score, vs in zip(self.valid_names, self.valid_scores,
                                   self.valid_sets):
            out.extend(self._eval(name, score, vs))
        return out

    # ---- finalize ----
    def finalize(self) -> List[Tree]:
        """Host Trees of every device tree not converted yet."""
        ts = self.train_set
        for tree in self.models_dev[len(self.models_host):]:
            arrays: Dict[str, np.ndarray] = {
                k: getattr(tree, k).cpu().numpy()
                for k in TreeArrays._fields if k != "num_leaves"}
            t = Tree.from_device(arrays, tree.num_leaves, ts.mappers,
                                 ts.feature_map)
            t.shrinkage = self.learning_rate
            self.models_host.append(t)
        return self.models_host

    def num_trees(self) -> int:
        return len(self.models_dev)
