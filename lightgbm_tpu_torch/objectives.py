"""Objective functions of the slice: L2 regression and binary logloss.

Port of ``RegressionL2`` and ``Binary`` of ``lightgbm_tpu/objectives.py``
(:81-119, :269-317): ``get_gradients``, ``fused_grad_spec`` (the static spec
the fused gradient front replays in-kernel), ``is_constant_hessian``,
``boost_from_score`` and ``convert_output``. Labels live on the training
device as f32 tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import BINARY_OBJECTIVES, L2_OBJECTIVES, Config
from .ops.hist_kernels import grad_rows


class ObjectiveFunction:
    """Base objective (reference: ObjectiveFunction, objective_function.h:19)."""

    name = "custom"
    is_constant_hessian = False

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.num_data = 0

    def init(self, label: torch.Tensor) -> None:
        self.label = label
        self.num_data = int(label.shape[0])

    def fused_grad_spec(self) -> Tuple[tuple, torch.Tensor]:
        raise NotImplementedError

    def get_gradients(self, score: torch.Tensor):
        spec, aux = self.fused_grad_spec()
        return grad_rows(spec, score, aux)

    def boost_from_score(self) -> float:
        return 0.0

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score


class RegressionL2(ObjectiveFunction):
    name = "regression"
    is_constant_hessian = True   # unweighted rows only (weights are not ported)

    def fused_grad_spec(self):
        return ("l2",), self.label

    def boost_from_score(self) -> float:
        # f32 sum / f32 count, as jnp.mean computes it
        return float(self.label.sum() / torch.tensor(
            float(self.num_data), dtype=torch.float32,
            device=self.label.device))


class Binary(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.label_weight_pos = 1.0
        self.label_weight_neg = 1.0

    def init(self, label: torch.Tensor) -> None:
        super().init(label)
        self.label_pos = (label > 0).to(torch.float32)
        cnt_pos = float(self.label_pos.to(torch.float64).sum())
        cnt_neg = float(self.num_data) - cnt_pos
        self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self.label_weight_neg = cnt_pos / cnt_neg
            else:
                self.label_weight_pos = cnt_neg / cnt_pos
        elif self.config.scale_pos_weight != 1.0:
            self.label_weight_pos = self.config.scale_pos_weight

    def fused_grad_spec(self):
        return (("logloss", self.sigmoid, float(self.label_weight_pos),
                 float(self.label_weight_neg)), self.label_pos)

    def boost_from_score(self) -> float:
        if self._cnt_pos <= 0 or self._cnt_neg <= 0:
            return 0.0
        p = self._cnt_pos * self.label_weight_pos / (
            self._cnt_pos * self.label_weight_pos
            + self._cnt_neg * self.label_weight_neg)
        return float(np.log(p / (1.0 - p)) / self.sigmoid)

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * score))


def create_objective(name: str, config: Config) -> ObjectiveFunction:
    n = str(name).lower()
    if n in L2_OBJECTIVES:
        return RegressionL2(config)
    if n in BINARY_OBJECTIVES:
        return Binary(config)
    raise NotImplementedError(f"objective {name!r} is not ported yet "
                              "(ROADMAP.md queue A11)")
