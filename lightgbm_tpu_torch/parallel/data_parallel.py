"""Data-parallel tree growing over a device mesh.

Port of ``lightgbm_tpu/parallel/data_parallel.py`` (``grow_tree_dp``,
:24; reference analog: DataParallelTreeLearner,
data_parallel_tree_learner.cpp): rows are blocked over the mesh's data
axis; each shard builds its histograms from its own rows on its device
with the same kernels as the serial grower, the shards' histograms are
summed (``ops/grow.py`` ``_hist_allreduce``, the reference's ``psum``
inside ``shard_map``) and the split search runs once on the sums, which
replaces the reference's ``SyncUpGlobalBestSplit``: every shard would
see the same sums, so no second collective is needed. The depthwise
growers run the serial grower's level pass over the shards
(``ops/grow_depthwise.py`` ``LevelRows``), which sums only the slots a
level fills.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops.grow import GrowParams, RowShard, ShardedRows, grow_tree
from .mesh import Mesh


def grow_tree_dp(bins: Sequence[torch.Tensor], g, h, c,
                 num_bins: torch.Tensor, na_bin: torch.Tensor,
                 feature_mask: torch.Tensor, gp: GrowParams, mesh: Mesh,
                 grow_fn=grow_tree, bundle=None, qseed=None,
                 bins_T: Optional[Sequence[torch.Tensor]] = None,
                 fused=None, data_used=None,
                 feature_devices: Tuple[torch.device, ...] = (),
                 **kw) -> Tuple:
    """Grow one tree with rows sharded over ``mesh``'s data axis.

    ``bins``: the per-shard row-major [n_s, F] uint8 blocks, each on its
    shard's device (``mesh.shard_rows`` / ``RowShardPlan.split``), and
    ``bins_T`` their [F, n_s] transposes (made here when None); ``g``,
    ``h``, ``c``: the per-shard f32 rows (None with ``fused``, the
    per-shard (score, aux, bag) of the fused front); ``data_used`` the
    per-shard blocks of the CEGB lazy bitset. ``grow_fn`` is
    ``ops.grow.grow_tree`` (leaf-wise) or
    ``ops.grow_depthwise.grow_tree_depthwise`` / ``_lean`` (level-wise);
    ``kw`` goes to it (forced, cegb). Returns the grower's tuple, its leaf
    ids a list of per-shard [n_s] i32 tensors."""
    axis = mesh.axis_names[0]
    gp_dp = gp if gp.axis_name == axis else \
        dataclasses.replace(gp, axis_name=axis)
    k = len(bins)
    if bins_T is None:
        bins_T = [b.t().contiguous() for b in bins]

    def nth(x, i):
        return None if x is None else x[i]

    shards = ShardedRows([
        RowShard(bins_T[i], bins[i], nth(g, i), nth(h, i), nth(c, i),
                 nth(fused, i), nth(data_used, i)) for i in range(k)],
        tuple(feature_devices))
    return grow_fn(None, None, None, None, num_bins, na_bin, feature_mask,
                   gp_dp, qseed=qseed, bundle=bundle, shards=shards, **kw)
