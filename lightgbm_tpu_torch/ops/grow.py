"""Tree-growing parameters and the flat device-side tree layout.

Port of ``GrowParams`` (:32), ``TreeArrays`` (:129) and ``_empty_tree``
(:173) of ``lightgbm_tpu/ops/grow.py``. Internal node ``i`` is created by
split ``i``; child pointers use the reference encoding: >= 0 an internal
node, < 0 ``~leaf``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from .split import SplitParams


@dataclass(frozen=True)
class GrowParams:
    num_leaves: int = 31
    max_depth: int = -1
    max_bin: int = 255            # padded bin axis length B
    split: SplitParams = field(default_factory=SplitParams)
    # constant-hessian channel elision (h = h_const * bag01): the level
    # passes carry (g, count) only and rebuild h = count * scale_h / 127
    const_hess: bool = False
    # fused_grad_spec of the objective: ("l2",) or
    # ("logloss", sigmoid, lw_pos, lw_neg)
    fused_obj: Optional[tuple] = None


class TreeArrays(NamedTuple):
    """Flat-array tree on the device (reference analog: Tree, tree.h:25)."""
    split_feature: torch.Tensor   # [L-1] i32
    threshold_bin: torch.Tensor   # [L-1] i32
    default_left: torch.Tensor    # [L-1] bool
    left_child: torch.Tensor      # [L-1] i32
    right_child: torch.Tensor     # [L-1] i32
    split_gain: torch.Tensor      # [L-1] f32
    leaf_value: torch.Tensor      # [L] f32
    leaf_weight: torch.Tensor     # [L] f32 (sum_hess)
    leaf_count: torch.Tensor      # [L] f32
    internal_value: torch.Tensor  # [L-1] f32
    internal_weight: torch.Tensor  # [L-1] f32
    internal_count: torch.Tensor  # [L-1] f32
    num_leaves: int


def empty_tree(L: int, device: torch.device) -> TreeArrays:
    m = max(L - 1, 1)

    def zi():
        return torch.zeros(m, dtype=torch.int32, device=device)

    def zf(k):
        return torch.zeros(k, dtype=torch.float32, device=device)

    return TreeArrays(
        split_feature=zi(), threshold_bin=zi(),
        default_left=torch.zeros(m, dtype=torch.bool, device=device),
        left_child=zi(), right_child=zi(), split_gain=zf(m),
        leaf_value=zf(L), leaf_weight=zf(L), leaf_count=zf(L),
        internal_value=zf(m), internal_weight=zf(m), internal_count=zf(m),
        num_leaves=1)
