"""Feature-parallel tree learning.

Port of ``lightgbm_tpu/parallel/feature_parallel.py``
(``make_feature_mesh``, ``fp_grow_params``, ``shard_features_once``,
``grow_tree_fp``, :34-105; reference analog: FeatureParallelTreeLearner,
feature_parallel_tree_learner.cpp): every device holds all the rows and
builds the histograms of its own feature tile; the best split is elected
across the tiles. The reference lays its arrays out sharded over a
``feature`` mesh axis and lets XLA partition the one jitted grower. Here
the depthwise grower's level pass measures through the tiles
(``FeatureTiles``, held by ``ops/grow_depthwise.py`` ``LevelRows``):
each level's rows are routed once (``route_level`` on the first device,
which holds the whole bin matrix), and each tile's f32 histograms come from ``hist_f32``
on its device over the tile's columns, handed the route's slot vector and
counts. The tiles' histograms are gathered in feature order on the first
device, where one split search over the whole feature axis takes the
first maximum in feature order: the reference's argmax election of the
tiles' winners (SyncUpGlobalBestSplit), tile by tile in order.
Quantization is off (``fp_grow_params``), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import hist_kernels as K
from ..ops.grow import GrowParams, TreeArrays
from ..ops.split import BundleArrays
from .mesh import FEATURE_AXIS, Mesh, local_devices

# the missing bin of a padded (dead) feature: one that no uint8 bin takes
DEAD_NA_BIN = 256


def make_feature_mesh(num_devices: Optional[int] = None,
                      kind: str = "cpu") -> Mesh:
    devs = local_devices(kind)
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(devs, (FEATURE_AXIS,))


def fp_grow_params(gp: GrowParams) -> GrowParams:
    """Quantization off: the reference's feature-parallel learner runs the
    unquantized histograms (feature_parallel.py:52-54)."""
    if gp.quant:
        gp = dataclasses.replace(gp, quant=False, const_hess=False,
                                 fused_obj=None)
    return gp


class Tile(NamedTuple):
    """One device's feature tile: columns [lo, hi) of the padded matrix,
    its [hi - lo, N] bins and the row-major matrix its histogram reads at
    column ``col0``."""
    device: torch.device
    lo: int
    hi: int
    bins_T: torch.Tensor
    bins: torch.Tensor
    col0: int


class FeatureTiles:
    """The feature tiles of a feature-parallel trainer and the whole
    (padded) bin matrix on the first device, which routes the rows."""

    def __init__(self, tiles: List[Tile], bins_T: torch.Tensor,
                 bins: torch.Tensor):
        self.tiles = tiles
        self.bins_T = bins_T
        self.bins = bins
        self.home = bins_T.device
        self._rows: List[Tuple] = []

    def set_rows(self, g: torch.Tensor, h: torch.Tensor,
                 c: torch.Tensor) -> None:
        """The tree's (g, h, c) rows, replicated onto each tile's device."""
        self._rows = [tuple(x.to(t.device) for x in (g, h, c))
                      for t in self.tiles]

    def _gather(self, parts: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat([p.to(self.home) for p in parts], dim=-2)

    def root(self, num_bins: int) -> torch.Tensor:
        """[3, F_pad, B] f32 root histograms, each tile's on its device."""
        return self._gather([
            K.hist_f32(t.bins_T, *rows, None, 1, num_bins)[0]
            for t, rows in zip(self.tiles, self._rows)])

    def routed(self, leaf_id: torch.Tensor, tables, na_bin: torch.Tensor,
               num_slots: int, num_bins: int):
        """Route the rows through the level's splits once, then each
        tile's [S, 3, ft, B] slot histograms on its device. Returns the
        gathered [S, 3, F_pad, B] and the new leaf ids."""
        slot, lid2, counts = K.route_level(self.bins_T, leaf_id,
                                           tables.stacked(), na_bin,
                                           num_slots, tables.bitset())
        parts = []
        for t, rows in zip(self.tiles, self._rows):
            parts.append(K.hist_f32(t.bins_T, *rows, slot.to(t.device),
                                    num_slots, num_bins, t.bins,
                                    counts.to(t.device), col0=t.col0))
        return self._gather(parts), lid2


def pad_mask(feature_mask: torch.Tensor, pad: int) -> torch.Tensor:
    """A feature mask with the dead features masked out."""
    return torch.cat([feature_mask, torch.zeros(
        pad, dtype=torch.bool, device=feature_mask.device)])


def shard_features_once(bins_T: torch.Tensor, bins: torch.Tensor,
                        num_bins: torch.Tensor, na_bin: torch.Tensor,
                        bundle: Optional[BundleArrays], mesh: Mesh):
    """Pad the feature axis to a multiple of the mesh size with dead
    features (1 bin, missing bin 256: they can never win a split) and cut
    it into one tile a device, once at the trainer's set-up. A tile on the
    first device reads the padded matrix in place; a tile on another
    device gets its own copy. Returns (FeatureTiles, num_bins, na_bin,
    bundle, pad)."""
    devs = list(mesh.devices.flat)
    nd = len(devs)
    f = bins_T.shape[0]
    pad = (-f) % nd
    if pad:
        bins_T = F.pad(bins_T, (0, 0, 0, pad))
        bins = F.pad(bins, (0, pad)).contiguous()
        num_bins = F.pad(num_bins, (0, pad), value=1)
        na_bin = F.pad(na_bin, (0, pad), value=DEAD_NA_BIN)
        if bundle is not None:
            bundle = BundleArrays(*[
                torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                          dtype=a.dtype, device=a.device)])
                for a in bundle])
    ft = (f + pad) // nd
    home = bins_T.device
    tiles = []
    for j, d in enumerate(devs):
        lo, hi = j * ft, (j + 1) * ft
        if d == home:
            tiles.append(Tile(d, lo, hi, bins_T[lo:hi], bins, lo))
        else:
            tiles.append(Tile(d, lo, hi, bins_T[lo:hi].to(d),
                              bins[:, lo:hi].contiguous().to(d), 0))
    return FeatureTiles(tiles, bins_T, bins), num_bins, na_bin, bundle, pad


def grow_tree_fp(bins_T: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                 c: torch.Tensor, num_bins: torch.Tensor,
                 na_bin: torch.Tensor, feature_mask: torch.Tensor,
                 gp: GrowParams, mesh: Mesh,
                 bins: Optional[torch.Tensor] = None,
                 bundle: Optional[BundleArrays] = None,
                 qseed: int = 0, tiles: Optional[FeatureTiles] = None,
                 **kw) -> Tuple[TreeArrays, torch.Tensor, int]:
    """Grow one tree with the features tiled over ``mesh`` (rows
    replicated). A one-off entry tiles the matrix here; the trainer tiles
    it once at its set-up (``shard_features_once``) and passes ``tiles``
    with the padded num_bins, na_bin and feature mask."""
    from ..ops.grow_depthwise import grow_tree_depthwise
    gp = fp_grow_params(gp)
    if tiles is None:
        if bins is None:
            bins = bins_T.t().contiguous()
        tiles, num_bins, na_bin, bundle, pad = shard_features_once(
            bins_T, bins, num_bins, na_bin, bundle, mesh)
        if pad:
            feature_mask = pad_mask(feature_mask, pad)
    tiles.set_rows(g, h, c)
    return grow_tree_depthwise(tiles.bins_T, g, h, c, num_bins, na_bin,
                               feature_mask, gp, qseed, bins=tiles.bins,
                               bundle=bundle, fp_tiles=tiles, **kw)
