"""The system under test, lightgbm_tpu_torch, as the benchmark drives it:
its Datasets, its own ``train`` entry, and what its run produced.

This is the only module of the benchmark that imports the port, and it
reads from it only the outputs a run produced (the trees, scores, bins and
bin bounds, and the reported metric) and its counters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .reference.trees import Tree


@dataclass
class Outputs:
    """What a training run produced, in the reference's terms."""
    trees: List[Tree]
    bias: float                      # the initial score
    train_score: torch.Tensor        # [N] f32
    valid_score: torch.Tensor        # [Nv] f32
    metric: float                    # the last reported validation metric
    iterations: int                  # boosting iterations the run made
    bounds: List[np.ndarray]         # each raw column's bin upper bounds
    bins_T: torch.Tensor             # [F, N] uint8, raw column order
    valid_bins_T: torch.Tensor
    # the trees the reference judges, by index: the iteration's (bag
    # weights [N] or None, raw columns searched)
    checked: Dict[int, Tuple[Optional[np.ndarray], np.ndarray]] = field(
        default_factory=dict)


def import_port():
    import lightgbm_tpu_torch as lt
    return lt


def datasets(lt, host, params):
    """The train and valid Datasets of the host rows (numpy in, as a user
    hands them)."""
    train = lt.Dataset(host.x_train.numpy(), label=host.y_train.numpy(),
                       group=host.group_train, params=params)
    valid = lt.Dataset(host.x_valid.numpy(), label=host.y_valid.numpy(),
                       group=host.group_valid, reference=train,
                       params=params)
    return train, valid


def load_library() -> dict:
    """Load (building on the first run in a checkout) the kernel library;
    its BUILD_INFO counters."""
    from lightgbm_tpu_torch.ops import cuda_lib
    cuda_lib.load()
    return {k: v for k, v in cuda_lib.BUILD_INFO.items() if k != "log"}


def launches() -> dict:
    from lightgbm_tpu_torch.ops import hist_kernels
    return {k: v for k, v in hist_kernels.LAUNCHES.items() if v}


def _tree(t, fmap: np.ndarray) -> Tree:
    L = int(t.num_leaves)
    m = max(L - 1, 0)

    def host(x, k):
        return x[:k].detach().cpu().numpy()
    return Tree(feature=fmap[host(t.split_feature, m).astype(np.int64)],
                threshold=host(t.threshold_bin, m).astype(np.int64),
                left=host(t.left_child, m).astype(np.int64),
                right=host(t.right_child, m).astype(np.int64),
                leaf_value=host(t.leaf_value, L),
                leaf_count=host(t.leaf_count, L).astype(np.float64),
                internal_count=host(t.internal_count, m).astype(np.float64),
                num_leaves=L)


def trees(booster, train) -> List[Tree]:
    fmap = np.asarray(train.feature_map, dtype=np.int64)
    return [_tree(t, fmap) for t in booster._gbdt.models_dev]


def tree_shape(booster) -> dict:
    """Mean leaves and level passes a tree so far."""
    g = booster._gbdt
    n = max(len(g.models_dev), 1)
    return {"trees": len(g.models_dev),
            "mean_leaves": sum(int(t.num_leaves) for t in g.models_dev) / n,
            "mean_level_passes": sum(g.hist_passes) / max(
                len(g.hist_passes), 1)}


def draws(booster) -> tuple:
    """The bag weights and the column mask of the iteration just made:
    the program's own draws, which the reference checks by what they must
    satisfy and then follows. The program makes both anew each iteration,
    so holding them copies nothing and waits for nothing."""
    g = booster._gbdt
    return g._bag_mask, g._fmask


def sampling_state(booster, drawn: tuple
                   ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """``draws`` on the host: the bag weights or None, and the searched
    columns in raw order."""
    bag, fmask = drawn
    fmap = np.asarray(booster._gbdt.train_set.feature_map, dtype=np.int64)
    cols = np.zeros(int(booster._gbdt.train_set.num_feature()), dtype=bool)
    cols[fmap[fmask.detach().cpu().numpy()]] = True
    return (None if bag is None else bag.detach().cpu().numpy()), cols


def outputs(booster, train, valid, metric: float, iterations: int,
            checked: Optional[dict] = None) -> Outputs:
    """The run's outputs; the bins come back in raw column order (every
    column of these cells is used)."""
    fmap = np.asarray(train.feature_map, dtype=np.int64)
    n_raw = int(train.num_feature())
    bounds = [np.array([np.inf])] * n_raw
    for k, j in enumerate(fmap):
        bounds[int(j)] = np.asarray(train.mappers[k].upper_bounds,
                                    dtype=np.float64)
    order = np.argsort(fmap)
    idx = torch.as_tensor(order, device=train.bins.device)
    g = booster._gbdt
    return Outputs(trees=trees(booster, train), bias=float(g.init_scores[0]),
                   train_score=g.train_score.detach().clone(),
                   valid_score=g.valid_scores[0].detach().clone(),
                   metric=float(metric), iterations=int(iterations),
                   bounds=bounds,
                   bins_T=train.bins_T.index_select(0, idx),
                   valid_bins_T=valid.bins_T.index_select(0, idx),
                   checked={t: sampling_state(booster, d)
                            for t, d in (checked or {}).items()})
