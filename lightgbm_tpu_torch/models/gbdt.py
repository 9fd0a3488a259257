"""GBDT boosting core: the serial eager step.

Port of the serial path of ``lightgbm_tpu/models/gbdt.py``: init score and
boost-from-average (:645-669), the quantized-gradient and const-hessian
resolution (:123-134, :737-766), the fused-front gate (``_fused_front``,
:714-727) and the unfused step's materialized gradients (:929-934,
:969-976), the per-tree dither seed ``qseed = iter * k + cls`` (:1504),
shrinkage (:952-954), the score update through ``take_small`` (:955-956)
and the first-iteration bias folded into the stored tree (:1326-1339); the
row and feature sampling of ``_update_bag`` (:606-628, bagging on the
threefry replica of ``utils/threefry.py``) and ``_feature_mask``
(:630-642), drawn in the reference's order each iteration (bag, then
feature mask, :671-677, :1114-1140). One
iteration grows K trees (``num_tree_per_iteration``: the objective's
model count, K classes for multiclass, or ``num_class`` for a custom
objective; :72-93), one per class on that class' contiguous gradient
column, with the grower ``_grow_fn`` picks (:1297-1304):
``grow_tree_depthwise`` for ``grow_policy=depthwise``, or
``grow_tree_depthwise_lean`` when ``histogram_pool_size`` gives it a
feature tile, the leaf-wise ``grow_tree`` otherwise, with a histogram pool
when ``histogram_pool_size`` caps its cached leaves (``pool_sizes``,
:136-184; the lean grower keeps the fused front off, :716). Each tree
is finished as ``_finish_tree`` (:1559-1578) does: the objective's leaf
renewal (L1 family) on the pre-tree score column, shrinkage, the first
iteration's bias. Scores are
[N] or [N, K] and stay on the training device, starting from the
Datasets' init scores (:99-104, :598-600), which turn boosting from the
average off (:651-652); an iteration whose K trees are all stumps ends
training, and trailing all-stump iterations are popped K trees at a time
(:1395-1404). A valid set added after training started replays the
trees so far on its bins (:591-604). On EFB-bundled data the grower works
on bundle columns with the plan's ``BundleArrays`` (:233-242), and every
replay of a tree on a Dataset's bins (valid sets, DART's drops, init
models) routes bundle splits by membership, where the reference's replays
route them by threshold (ROADMAP caveats). The split constraints
(A12c) reach the growers as the reference sets them up: the raw-column
monotone constraints and feature_contri mapped to the grower's columns
(``_monotone_tuple``, :533-554; ``_contri_tuple``, :556-590), the CEGB
penalty vectors likewise, a bundle charged its largest member's
(``_cegb_setup``, :404-441), with their bookkeeping kept across trees
(:247-267; depthwise only, lossguide warns and ignores CEGB), and the
forced-splits JSON as flat arrays of bins (``_build_forced``,
:476-531); CEGB and forced splits turn the fused front off
(:715-719). DART and RF (``dart.py``,
``rf.py``) override the score hooks: ``average_output`` (no shrinkage,
renewal or bias; :1126, :1571, :1681, :1703) and ``_apply_tree_delta``
(:1027). The non-finite guard (``nonfinite_policy``, :76-80) checks a
custom objective's gradients on the host before they reach the quantizer
(``guard_gradients``, :1705-1735) and each iteration's new train score
through one device flag, read once an iteration (:965-1005, :1297-1320,
:1430-1450): ``fatal`` raises, ``warn_skip_tree`` discards the iteration's
trees and their score, ``clip`` caps the score and the iteration's trees
at +-``_NF_CLIP`` and warns once. ``get_resume_state`` /
``set_resume_state`` carry the trainer's exact state through a snapshot
sidecar (:1747-1917), under the reference's npz key names, the CEGB
bookkeeping included. Accepted parameters that the port reads nowhere warn
(``warn_unconsumed``, :444-474). The tree learner (``_setup_learner``,
:278-392): a Dataset constructed over a row-shard plan, or
``tree_learner=data|voting`` with more than one local device, grows each
tree data-parallel (``parallel/data_parallel.grow_tree_dp``: each shard's
rows on its device, padding rows with zero g, h and count, the CEGB lazy
bitset in row blocks, the score update through take_small a shard, the
iteration behind the ``hist_allreduce`` fault point and its retry,
:1099-1200); ``tree_learner=feature`` with more than one device grows it
on feature tiles (``parallel/feature_parallel.py``, unquantized and
depthwise whatever the grow policy, as the reference's, :862-880). The
snapshot's state stays unsharded, so a resume takes any shard count. With telemetry on, the guard's trips, the
packed lattice's fallback (:763) and the train_iter event's tree stats
(``obs_lagged_stats``, :1277-1298) reach ``obs``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs, prewarm
from ..binning import BIN_CATEGORICAL
from ..objectives import ObjectiveFunction
from ..config import Config
from ..log import LightGBMError, fatal, info, warning
from ..parallel import mesh as M
from ..parallel import multihost
from ..parallel.data_parallel import grow_tree_dp
from ..parallel.feature_parallel import (grow_tree_fp, make_feature_mesh,
                                         pad_mask, shard_features_once)
from ..obs.tracing import span
from ..utils import faults, threefry
from ..ops.gather import take_small
from ..ops.grow import ForcedSplits, GrowParams, TreeArrays, grow_tree
from ..ops.grow_depthwise import (CEGBState, LevelGraphs,
                                  grow_tree_depthwise,
                                  grow_tree_depthwise_lean)
from ..ops.histogram import ACC_ROWS_MAX, pack_guard_bits
from ..ops.predict import bin_tree, route_bins
from ..ops.split import BundleArrays, SplitParams
from .tree import Tree

K_EPSILON = 1e-15
# score magnitude cap of nonfinite_policy=clip (reference: _NF_CLIP,
# gbdt.py:30): far beyond any sane boosted score, small enough that f32
# sums of clipped values stay finite
_NF_CLIP = 1e30


def _sanitize(a: torch.Tensor) -> torch.Tensor:
    """NaN to 0, then clamp to +-_NF_CLIP (nonfinite_policy=clip)."""
    return torch.clamp(torch.nan_to_num(a, nan=0.0, posinf=_NF_CLIP,
                                        neginf=-_NF_CLIP),
                       -_NF_CLIP, _NF_CLIP)


def _sanitize_np(a: np.ndarray) -> np.ndarray:
    return np.clip(np.nan_to_num(a, nan=0.0, posinf=_NF_CLIP,
                                 neginf=-_NF_CLIP), -_NF_CLIP, _NF_CLIP)


# accepted parameters that the port reads nowhere, with their defaults and
# why each has no effect on the H100 (reference: _warn_unconsumed,
# gbdt.py:444-474); device_type is the port's own device choice
# (config.py), not one of them
UNCONSUMED = (
    ("pred_early_stop", False,
     "Booster.predict walks every tree for all rows at once on the card "
     "(ops/predict.py); stopping a row early saves no time there"),
    ("pred_early_stop_freq", 10, "see pred_early_stop"),
    ("pred_early_stop_margin", 10.0, "see pred_early_stop"),
    ("force_col_wise", False,
     "the histogram kernels have one layout: each level's kept rows are "
     "grouped by slot and summed into a block's shared-memory table "
     "(csrc/slot_hist.cuh)"),
    ("force_row_wise", False, "see force_col_wise"),
    ("is_enable_sparse", True,
     "bins are a dense uint8 matrix on the card; EFB bundles compress "
     "sparse columns"),
    ("gpu_platform_id", -1,
     "no OpenCL platform: the port runs on torch's current CUDA device"),
    ("gpu_device_id", -1, "see gpu_platform_id"),
    ("gpu_use_dp", False,
     "the leaf sums (leaf_sums_grad, leaf_sums) already sum in f64, the "
     "unquantized histogram (hist_f32) sums in f32 and the quantized ones "
     "in int32"),
    ("hist_dtype", "float32",
     "histograms sum in int32 (quantized) or f32 (hist_f32); no other "
     "dtype is implemented"),
)


def warn_unconsumed(config: Config) -> None:
    """Warn, never silently ignore, for each UNCONSUMED parameter set away
    from its default."""
    for name, default, why in UNCONSUMED:
        if getattr(config, name, default) != default:
            warning(f"{name} is ignored: {why}")


def padded_bins(max_num_bins: int) -> int:
    """The reference's bin-axis padding (gbdt.py:110)."""
    return 64 if max_num_bins <= 64 else (128 if max_num_bins <= 128 else 256)


def resolve_quant(config: Config, log: bool = True) -> bool:
    """use_quantized_grad as the reference resolves it (gbdt.py:123-134):
    true, or auto on the kernel path, turns the int8 histograms on, but
    only for the depthwise grower. The port always runs the kernel path
    (its CPU run stands in for the card), so auto means on."""
    uq = str(config.use_quantized_grad).lower()
    quant_on = uq in ("true", "1", "auto")
    if quant_on and config.grow_policy != "depthwise":
        if log and uq in ("true", "1"):
            warning("use_quantized_grad only applies to the depthwise "
                    f"grower; ignoring for grow_policy={config.grow_policy}")
        quant_on = False
    return quant_on


def cegb_enabled(config: Config) -> bool:
    """Whether any cegb_* penalty is set."""
    return (config.cegb_penalty_split > 0.0
            or any(config.cegb_penalty_feature_coupled or [])
            or any(config.cegb_penalty_feature_lazy or []))


def device_kind(config: Config) -> str:
    """The torch device type of ``device_type``."""
    return "cuda" if str(config.device_type).lower() in ("cuda", "gpu") \
        else "cpu"


def voting_on(config: Config) -> bool:
    """tree_learner=voting, or voting_parallel (reference: gbdt.py:213)."""
    return (str(config.tree_learner).lower() == "voting"
            or bool(int(config.voting_parallel or 0)))


def feature_parallel_on(config: Config) -> bool:
    """tree_learner=feature with more than one local device (reference:
    gbdt.py:318-319)."""
    return (str(config.tree_learner).lower() in ("feature",
                                                 "feature_parallel")
            and M.device_count(device_kind(config)) > 1)


def pool_sizes(config: Config, f: int, B: int, cegb: bool,
               log: bool = True) -> Tuple[int, int]:
    """(hist_pool, lean_ft) of histogram_pool_size MB (reference:
    gbdt.py:136-184): when the whole frontier's [L, 3, F, B] f32
    histograms exceed the budget, the leaf-wise grower caches
    max(2, budget // one leaf's) of them, and the depthwise grower
    turns lean with a feature tile of width budget // (2 (L // 2) 3 B
    4), unless CEGB, forced splits, feature_fraction_bynode or
    extra_trees keep its whole frontier (a warning)."""
    if config.histogram_pool_size <= 0:
        return 0, 0
    per_leaf = 3 * f * B * 4
    budget = int(config.histogram_pool_size * (1 << 20))
    cap = budget // max(1, per_leaf)
    if cap >= config.num_leaves:
        return 0, 0
    if config.grow_policy != "depthwise":
        if log:
            info(f"histogram pool: {max(2, cap)} cached leaf histograms "
                 "(evicted parents rebuild)")
        return max(2, cap), 0
    incompat = [what for what, on in (
        ("voting-parallel", voting_on(config)),
        ("feature-parallel",
         str(config.tree_learner).lower() in ("feature",
                                              "feature_parallel")),
        ("CEGB", cegb),
        ("forced splits", bool(config.forcedsplits_filename)),
        ("feature_fraction_bynode", config.feature_fraction_bynode < 1.0),
        ("extra_trees", bool(config.extra_trees))) if on]
    if incompat:
        if log:
            warning("histogram_pool_size is ignored for the depthwise grower "
                    f"with {', '.join(incompat)}; the whole-frontier state "
                    "is kept")
        return 0, 0
    slots = 2 * max(1, config.num_leaves // 2)
    lean_ft = max(1, min(f, budget // max(1, slots * 3 * B * 4)))
    if log:
        info(f"histogram pool: lean depthwise mode, feature tile {lean_ft}/"
             f"{f} (budget {config.histogram_pool_size}MB < "
             f"{per_leaf * config.num_leaves >> 20}MB whole-frontier state)")
    return 0, lean_ft


# the CUDA kernels (ops/hist_kernels names) each trainer path launches
_FUSED_KERNELS = ("grad_quant_hist0", "hist_routed_fused", "leaf_sums_grad",
                  "take_small")
_Q8_KERNELS = ("hist_q8", "route_level", "leaf_sums", "take_small",
               "hist_routed_fused")
_F32_KERNELS = ("hist_f32", "route_level", "take_small")
_LOSSGUIDE_KERNELS = ("hist_f32", "take_small")


@dataclasses.dataclass(frozen=True)
class KernelPath:
    """What decides a trainer's kernel path: its grower, the int8
    histograms, CEGB, forced splits, the histogram pool, the fused front
    and the const-hessian elision."""
    depthwise: bool
    quant: bool
    cegb: bool
    forced: bool
    hist_pool: int
    lean_ft: int
    fused: bool
    const_hess: bool

    @property
    def kernels(self) -> Tuple[str, ...]:
        """The CUDA kernels this path launches."""
        if not self.depthwise:
            return _LOSSGUIDE_KERNELS
        if self.fused:
            return _FUSED_KERNELS
        return _Q8_KERNELS if self.quant else _F32_KERNELS


def kernel_path(config: Config, f: int, B: int, k: int, fused_obj: bool,
                const_hess_obj: bool, custom_grad: bool, forced: bool,
                log: bool = True) -> KernelPath:
    """The kernel path of a trainer of ``config`` on F grower columns of B
    padded bins with k trees an iteration, whose objective has a fused
    spec (``fused_obj``) and a constant hessian (``const_hess_obj``), and
    which is handed materialized gradients (``custom_grad``) or forced
    splits. The reference's fused-front gate (``_fused_front``,
    :695-729): one model an iteration of an objective with a fused spec
    (unweighted L2 or binary), the quantized depthwise grower, no CEGB or
    forced splits, no lean feature tile, and an [F * B] root histogram of
    at most 2048 cells; anything else materializes the gradients and takes
    the unfused front. ``GBDT.__init__`` and ``prewarm.expected_spec``
    both decide the path here."""
    fp = feature_parallel_on(config)
    # the feature-parallel learner grows depthwise, unquantized, whatever
    # the grow policy (reference: gbdt.py:862-880, feature_parallel.py:52)
    depthwise = config.grow_policy == "depthwise" or fp
    quant = resolve_quant(config, log) and not fp
    cegb = depthwise and cegb_enabled(config) and not fp
    hist_pool, lean_ft = pool_sizes(config, f, B, cegb, log)
    fused = (fused_obj and not custom_grad and k == 1 and quant
             and depthwise and f * B <= ACC_ROWS_MAX and not cegb
             and not forced and lean_ft == 0)
    # constant-hessian elision is a property of the quantized channels of
    # the objective's own gradients (gbdt.py:737-744)
    return KernelPath(depthwise=depthwise, quant=quant, cegb=cegb,
                      forced=forced, hist_pool=hist_pool, lean_ft=lean_ft,
                      fused=fused, const_hess=(quant and const_hess_obj
                                               and not custom_grad))


def forced_split_arrays(config: Config, train_set, log: bool = True
                        ) -> Optional[Tuple[List[int], ...]]:
    """The forcedsplits_filename JSON tree as flat lists (feature, bin,
    left, right), or None (reference: ``_build_forced``, gbdt.py:476-531):
    each node's feature in the grower's columns and its threshold as a bin
    through the feature's mapper. A forced feature that EFB bundled, or a
    categorical one, warns and drops its subtree."""
    if not config.forcedsplits_filename:
        return None
    with open(config.forcedsplits_filename) as fh:
        root = json.load(fh)
    inv = {int(o): u for u, o in enumerate(train_set.feature_map)}
    meta = train_set.bundle_meta
    col_of = None
    if meta is not None:
        col_of = {mem[0][0]: c for c, mem in enumerate(meta.members)
                  if len(mem) == 1}
    feats: List[int] = []
    bins_: List[int] = []
    lefts: List[int] = []
    rights: List[int] = []

    def rec(node) -> int:
        if node is None or "feature" not in node:
            return -1
        raw_f = int(node["feature"])
        used = inv.get(raw_f, raw_f)
        col = used
        if col_of is not None:
            if used not in col_of:
                if log:
                    warning(f"forced split feature {raw_f} was bundled by "
                            "EFB; ignoring this forced subtree")
                return -1
            col = col_of[used]
        m = train_set.mappers[used]
        if m.bin_type == BIN_CATEGORICAL:
            if log:
                warning("categorical forced splits are not supported; "
                        "ignoring this forced subtree")
            return -1
        b = int(m.values_to_bins(np.asarray([float(node["threshold"])]))[0])
        i = len(feats)
        feats.append(col)
        bins_.append(b)
        lefts.append(-1)
        rights.append(-1)
        lefts[i] = rec(node.get("left"))
        rights[i] = rec(node.get("right"))
        return i

    if rec(root) < 0:
        return None
    return feats, bins_, lefts, rights


def tree_delta(tree: TreeArrays, data) -> torch.Tensor:
    """A device tree's leaf value for each row of a Dataset's bins
    (route_bins, then the take_small kernel); for a train set over
    several processes, every process's rows (each process routes its
    own)."""
    delta = take_small(tree.leaf_value,
                       route_bins(tree, data.bins, data.na_bin_dev,
                                  data.routes_by_membership))
    plan = getattr(data, "shard_plan", None)
    if multihost.plan_spans_processes(plan):
        return multihost.gather_rows_tensor(delta, plan)
    return delta


def _f32(x: float) -> float:
    """x rounded to f32, as the reference's f32 comparisons see it."""
    return float(np.float32(x))


class GBDT:
    """Gradient Boosting Decision Tree trainer (reference: GBDT, gbdt.h:33)."""

    # the step is handed materialized gradients (GOSS samples by |g * h|
    # before growing): the reference's custom step, which keeps the fused
    # front off and all three quantized channels (gbdt.py:733-744)
    _custom_grad = False
    # the model's output is the mean of its trees, not their sum (RF)
    average_output = False

    def __init__(self, config: Config, train_set, objective, metrics=None):
        self.config = config
        self.train_set = train_set
        self.objective = objective     # None: custom gradients (fobj)
        self.metrics = list(metrics or [])
        self.iter_ = 0
        # non-finite guard: fatal | warn_skip_tree | clip
        self._nf_policy = config.nonfinite_policy
        self._nf_warned = False
        self._pack_checked = False
        self._obs_trees = None
        self.learning_rate = float(config.learning_rate)
        self.device = train_set.device
        # across processes: the group, then the fence before the first
        # collective of training (reference: gbdt.py:276-297)
        self._pod = multihost.plan_spans_processes(
            getattr(train_set, "shard_plan", None))
        if config.num_machines > 1:
            M.init_distributed(config)
            if multihost.process_count() > 1:
                from ..parallel.fence import consistency_fence
                consistency_fence(config, train_set)
        n = train_set.num_data
        f = train_set.num_features
        B = padded_bins(train_set.max_num_bins)
        k = self.num_tree_per_iteration = (
            objective.num_model_per_iteration if objective is not None
            else int(config.num_class))
        spec = self._aux = None
        # whether the objective renews leaf values from the rows' leaf ids
        # (the L1 family)
        self._renews = objective is not None and \
            type(objective).renew_leaf_values is not \
            ObjectiveFunction.renew_leaf_values
        if objective is not None:
            objective.init(train_set.label, train_set.weight,
                           train_set.group)
            fs = objective.fused_grad_spec()
            if fs is not None:
                spec, self._aux = fs
        # the grower's columns: the EFB plan's (bundles and single
        # features), else one a used feature
        meta = train_set.bundle_meta
        columns = (meta.members if meta is not None else
                   [[(j, 0, m.num_bins)] for j, m in
                    enumerate(train_set.mappers)])
        self.bundle = None
        if meta is not None:
            # the plan's per-position arrays on the grower's bin axis, the
            # range and prefix ends clamped to it (gbdt.py:233-242)
            def on_dev(a, dtype=torch.int64):
                return torch.as_tensor(a, device=self.device).to(dtype)
            self.bundle = BundleArrays(
                range_start=on_dev(meta.range_start[:, :B]),
                range_end=on_dev(np.minimum(meta.range_end[:, :B], B - 1)),
                prefix_end=on_dev(np.minimum(meta.prefix_end[:, :B], B - 1)),
                incl_default=on_dev(meta.incl_default[:, :B], torch.bool),
                valid=on_dev(meta.valid[:, :B], torch.bool),
                is_bundle=on_dev(meta.is_bundle, torch.bool))
        self._fp = feature_parallel_on(config)
        self.depthwise = config.grow_policy == "depthwise" or self._fp
        cegb_coupled, cegb_lazy = self._cegb_setup(config, train_set)
        self.forced = self._build_forced(config, train_set)
        # the serial depthwise grower's level passes, captured as CUDA
        # graphs across this trainer's trees where capture engages
        self._level_graphs = LevelGraphs()
        self.path = kernel_path(
            config, f, B, k, fused_obj=spec is not None,
            const_hess_obj=(objective is not None
                            and bool(objective.is_constant_hessian)),
            custom_grad=self._custom_grad, forced=self.forced is not None)
        if not self.path.fused:
            spec = None
        self.gp = GrowParams(
            num_leaves=config.num_leaves, max_depth=config.max_depth,
            max_bin=B,
            split=SplitParams(
                lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
                min_gain_to_split=config.min_gain_to_split,
                min_data_in_leaf=config.min_data_in_leaf,
                min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
                max_delta_step=config.max_delta_step,
                # the columns of one categorical feature (gbdt.py:111-121;
                # categorical features are never bundled)
                cat_features=tuple(
                    c for c, mem in enumerate(columns)
                    if len(mem) == 1 and train_set.mappers[mem[0][0]].bin_type
                    == BIN_CATEGORICAL),
                has_bundles=meta is not None,
                cat_l2=config.cat_l2, cat_smooth=config.cat_smooth,
                max_cat_threshold=config.max_cat_threshold,
                max_cat_to_onehot=config.max_cat_to_onehot,
                min_data_per_group=config.min_data_per_group,
                monotone_constraints=self._monotone_tuple(config, train_set),
                feature_contri=self._contri_tuple(config, train_set),
                extra_trees=bool(config.extra_trees),
                extra_seed=int(config.extra_seed),
                cegb_tradeoff=config.cegb_tradeoff,
                cegb_penalty_split=(config.cegb_penalty_split
                                    if self._cegb_ok else 0.0),
                cegb_coupled=cegb_coupled is not None,
                cegb_lazy=cegb_lazy is not None),
            quant=self.path.quant, const_hess=self.path.const_hess,
            fused_obj=spec, ff_bynode=float(config.feature_fraction_bynode),
            hist_pool=self.path.hist_pool, lean_ft=self.path.lean_ft,
            voting_top_k=int(config.top_k) if voting_on(config) else 0)
        if voting_on(config) and not self.depthwise:
            warning("tree_learner=voting is only implemented for the "
                    "depthwise grower; falling back to plain data-parallel "
                    "histogram exchange")
        self._setup_learner(config, train_set)
        # the step's parameters for gradients handed in (fobj): neither the
        # fused front nor the const-hessian elision
        self.gp_custom = dataclasses.replace(self.gp, fused_obj=None,
                                             const_hess=False)
        # CEGB bookkeeping across trees (gbdt.py:246-267)
        self.cegb: Optional[CEGBState] = None
        if self.gp.split.has_cegb:
            if cegb_lazy is not None and n * f > 1 << 30:
                warning("cegb_penalty_feature_lazy allocates a per-(row, "
                        f"feature) bitset: {n * f / 1e9:.1f} GB of device "
                        "memory at this dataset size")

            def vec(v):
                return torch.as_tensor(np.zeros(f) if v is None else v,
                                       dtype=torch.float32,
                                       device=self.device)
            self.cegb = CEGBState(
                feature_used=torch.zeros(f, dtype=torch.bool,
                                         device=self.device),
                data_used=(torch.zeros((n, f), dtype=torch.bool,
                                       device=self.device)
                           if cegb_lazy is not None else None),
                coupled_pen=vec(cegb_coupled), lazy_pen=vec(cegb_lazy),
                lazy_cols=(None if cegb_lazy is None else torch.as_tensor(
                    np.flatnonzero(cegb_lazy), device=self.device)))
        self._shard_cegb()
        warn_unconsumed(config)
        if str(config.packed_levels).lower() in ("true", "1"):
            # the reference's wording (models/gbdt.py:221-226)
            warning("packed_levels was an experiment falsified on this "
                    "runtime (10-24x slower; see docs/PERF_NOTES.md) and its "
                    "implementation is archived on branch "
                    "archive/packed-levels; the flag is ignored")
        self._score_shape = (n,) if k == 1 else (n, k)
        self.train_score = torch.zeros(self._score_shape, dtype=torch.float32,
                                       device=self.device)
        self._has_init_score = train_set.init_score is not None
        if self._has_init_score:
            self.train_score = self.train_score + \
                train_set.init_score.reshape(self._score_shape)
        # an init model's trees on this Dataset's bins (engine._warm_start):
        # their score is the train score's init score and replays into
        # each valid set added later
        self.init_model_dev: List[TreeArrays] = []
        # sampling state (gbdt.py:272-274): the bag mask (None when bagging
        # is off, f32 row weights otherwise), its threefry key, the feature
        # mask and its RandomState
        self._bag_ones = torch.ones(n, dtype=torch.float32,
                                    device=self.device)
        self._bag_mask: Optional[torch.Tensor] = None
        self._bag_key = threefry.prng_key(config.bagging_seed)
        # the reference's bagging RandomState, which nothing draws from:
        # carried in the snapshot sidecar as the reference carries it
        self._bag_rng = np.random.RandomState(config.bagging_seed)
        self._feat_rng = np.random.RandomState(config.feature_fraction_seed)
        self._fmask_ones = torch.ones(f, dtype=torch.bool, device=self.device)
        self._fmask = self._fmask_ones
        self.init_scores = [0.0] * k
        self.models_dev: List[TreeArrays] = []
        self.models_host: List[Tree] = []
        # histogram passes of each tree after its root: one per level
        # (depthwise) or per split (lossguide); and the lossguide pool's
        # rebuilds of evicted parents
        self.hist_passes: List[int] = []
        self.hist_rebuilds: List[int] = []
        self.valid_sets: List = []
        self.valid_names: List[str] = []
        self.valid_scores: List[torch.Tensor] = []
        # the background kernel warm-up of the Dataset's construct
        # (prewarm.py): joined here, before the first launch
        handle = getattr(train_set, "_prewarm", None)
        self.prewarm_adopted = (handle is not None
                                and prewarm.adopt(handle, self))

    def _cegb_setup(self, config: Config, train_set):
        """The CEGB penalty vectors in the grower's columns, or None each
        (reference: ``_cegb_setup``, gbdt.py:404-441): a vector is given
        per raw feature (another length is fatal), taken at the used
        features, and a bundle column is charged its largest member's
        penalty. CEGB rides the depthwise grower only: lossguide warns and
        ignores it. Sets ``self._cegb_ok``."""
        cp = list(config.cegb_penalty_feature_coupled or [])
        lp = list(config.cegb_penalty_feature_lazy or [])
        enabled = cegb_enabled(config)
        self._cegb_ok = enabled and config.grow_policy == "depthwise"
        if not enabled:
            return None, None
        if feature_parallel_on(config):
            # the feature-parallel learner tiles the columns; the reference
            # ignores CEGB there (gbdt.py:334-341)
            warning("CEGB is not supported with the feature-parallel tree "
                    "learner; ignoring cegb_* parameters")
            self._cegb_ok = False
            return None, None
        if not self._cegb_ok:
            warning("CEGB is only supported with grow_policy=depthwise "
                    "(the default); ignoring cegb_* parameters")
            return None, None
        n_raw = train_set.num_features_raw or train_set.num_features

        def map_vec(vec, name):
            if not any(vec):
                return None
            if len(vec) != n_raw:
                raise LightGBMError(f"{name} should be the same size as "
                                    f"feature number ({len(vec)} vs "
                                    f"{n_raw})")
            used = np.asarray(vec, np.float64)[
                np.asarray(train_set.feature_map, np.int64)]
            meta = train_set.bundle_meta
            if meta is None:
                return used
            return np.asarray([used[[m[0] for m in mem]].max()
                               for mem in meta.members])

        return (map_vec(cp, "cegb_penalty_feature_coupled"),
                map_vec(lp, "cegb_penalty_feature_lazy"))

    def _setup_learner(self, config: Config, train_set) -> None:
        """The tree learner (reference: gbdt.py:278-392). A Dataset
        constructed over a ``RowShardPlan`` trains data-parallel whatever
        ``tree_learner`` says; ``data`` and ``voting`` shard the rows over
        every local device (the plan made here, the bins split once);
        ``feature`` tiles the columns over every local device. One device
        trains serially. Sets ``_dp``, ``_fp``, ``_shard_plan``, the
        per-shard bins (``_dp_bins``, ``_dp_bins_T``) or the feature tiles
        (``_fp_tiles``), and the mesh axes of ``gp``."""
        kind = self.device.type
        nd = M.device_count(kind)
        plan = getattr(train_set, "shard_plan", None)
        learner = str(config.tree_learner).lower()
        self._dp = ((learner in ("data", "data_parallel", "voting")
                     and nd > 1) or plan is not None)
        if self._fp and plan is not None:
            fatal("tree_learner=feature cannot train on a row-sharded "
                  "Dataset; construct with num_shards=1")
        if self._fp:
            self._dp = False
        self._shard_plan = None
        if self._fp:
            self._fmesh = make_feature_mesh(kind=kind)
            (self._fp_tiles, self._fp_num_bins, self._fp_na_bin,
             self._fp_bundle, self._fp_pad) = shard_features_once(
                 train_set.bins_T, train_set.bins, train_set.num_bins_dev,
                 train_set.na_bin_dev, self.bundle, self._fmesh)
            info(f"feature-parallel tree learner over {self._fmesh.size} "
                 "devices")
            return
        if not self._dp:
            return
        if plan is not None:
            # the construct committed each row block to its shard's device
            self._shard_plan = plan
            self._dp_bins = list(train_set.shard_bins)
            self._dp_bins_T = train_set.shard_bins_T
        else:
            # tree_learner=data on an unsharded Dataset: a plan over every
            # local device, the bins split once here
            self._shard_plan = M.plan_row_sharding(
                train_set.num_data, nd, axis_name=config.mesh_axis,
                kind=kind)
            self._dp_bins = self._shard_plan.split(train_set.bins)
            self._dp_bins_T = [b.t().contiguous() for b in self._dp_bins]
        sp = self._shard_plan
        feat_kw = ({} if sp.feature_shards <= 1 else
                   dict(feature_axis_name=sp.feature_axis,
                        feature_shards=sp.feature_shards))
        self.gp = dataclasses.replace(self.gp, axis_name=sp.axis_name,
                                      processes=sp.process_count, **feat_kw)
        info(f"data-parallel tree learner over {sp.num_shards} shards "
             f"(axis '{sp.axis_name}', "
             f"{'mesh-native' if plan is not None else 'resharded'}"
             + (f", {sp.process_count} processes, {sp.shards_global} "
                "shards in all)" if self._pod else ")"))
        if plan is not None:
            # fail before step 0 on a dead device or a stale plan
            from ..parallel.fence import mesh_preflight
            mesh_preflight(config, train_set, plan)
        self._emit_hist_allreduce_probe()

    def _shard_cegb(self) -> None:
        """Under the data-parallel learner the CEGB lazy bitset lives in
        row blocks, one on each shard's device (reference: gbdt.py:371-381;
        padding rows never pay: their count is zero)."""
        if self._shard_plan is not None and self.cegb is not None and \
                self.cegb.data_used is not None:
            self.cegb = dataclasses.replace(
                self.cegb, data_used=self._shard_plan.split(
                    self.cegb.data_used))

    def _cegb_data_used(self) -> Optional[torch.Tensor]:
        """The CEGB lazy bitset [N, F] (gathered from its row blocks)."""
        du = None if self.cegb is None else self.cegb.data_used
        if isinstance(du, list):
            return self._gather_rows(du)
        return du

    def _gather_rows(self, parts) -> torch.Tensor:
        """The shards' blocks of a per-row tensor as the trainer's rows,
        every process's across processes."""
        local = self._shard_plan.gather(parts, self.device)
        if self._pod:
            return multihost.gather_rows_tensor(local, self._shard_plan)
        return local

    def _emit_hist_allreduce_probe(self) -> None:
        """One timed shard sum of a root-histogram-shaped [3, F, B] f32
        tensor at set-up (reference: gbdt.py:1059-1097), as the
        ``hist_allreduce`` event; with telemetry on only."""
        if not obs.enabled():
            return
        import time
        from ..ops import grow as G
        sp = self._shard_plan
        shape = (3, self.train_set.num_features, self.gp.max_bin)
        parts = [torch.ones(shape, dtype=torch.float32, device=d)
                 for d in sp.devices]
        saved = dict(G.ALLREDUCE)   # the probe is not training traffic
        G._hist_allreduce(parts, self.gp, 1, sp.feature_devices)  # warm-up
        self._sync()
        t0 = time.perf_counter()
        G._hist_allreduce(parts, self.gp, 1, sp.feature_devices)
        self._sync()
        dt = time.perf_counter() - t0
        G.ALLREDUCE.update(saved)
        obs.emit("hist_allreduce", shards=int(sp.num_shards),
                 bytes=int(np.prod(shape)) * 4, psum_s=float(dt))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_forced(self, config: Config, train_set
                      ) -> Optional[ForcedSplits]:
        """``forced_split_arrays`` on the training device."""
        arrays = forced_split_arrays(config, train_set)
        if arrays is None:
            return None

        def dev(v):
            return torch.as_tensor(np.asarray(v, np.int64),
                                   device=self.device)
        return ForcedSplits(*(dev(v) for v in arrays))

    @staticmethod
    def _monotone_tuple(config: Config, train_set) -> tuple:
        """Raw-column monotone constraints in the grower's columns
        (reference: gbdt.py:533-554): the used features', and under EFB 0
        for a merged bundle (constrained features are never bundled)."""
        mc = list(config.monotone_constraints or [])
        if not any(mc):
            return ()
        used = [mc[int(o)] if int(o) < len(mc) else 0
                for o in train_set.feature_map]
        meta = train_set.bundle_meta
        if meta is not None:
            used = [used[mem[0][0]] if len(mem) == 1 else 0
                    for mem in meta.members]
        return tuple(int(v) for v in used)

    @staticmethod
    def _contri_tuple(config: Config, train_set) -> tuple:
        """Raw-column feature_contri in the grower's columns, clamped at 0
        (reference: gbdt.py:556-590); another length than the raw
        features' is fatal. A Dataset constructed before the parameter
        arrived may hold bundles: a single column keeps its feature's
        contri, a merged one takes 1.0 with a warning."""
        fc = list(config.feature_contri or [])
        if not fc or all(float(v) == 1.0 for v in fc):
            return ()
        nraw = train_set.num_features_raw or len(fc)
        if len(fc) != nraw:
            raise LightGBMError(f"feature_contri has {len(fc)} entries but "
                                f"the data has {nraw} features")
        used = [fc[int(o)] if int(o) < len(fc) else 1.0
                for o in train_set.feature_map]
        meta = train_set.bundle_meta
        if meta is not None:
            merged = [i for i, mem in enumerate(meta.members) if len(mem) > 1]
            if merged and any(float(used[m[0]]) != 1.0
                              for i in merged for m in meta.members[i]):
                warning("feature_contri on EFB-merged bundle columns is "
                        "approximated as 1.0 (construct the Dataset with "
                        "feature_contri in params to disable bundling)")
            used = [used[mem[0][0]] if len(mem) == 1 else 1.0
                    for mem in meta.members]
        return tuple(max(0.0, float(v)) for v in used)

    def add_valid(self, valid_set, name: str) -> None:
        """A valid set's score: its init score, an init model's trees, and
        the trees so far replayed on its bins (route_bins + take_small)."""
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        shape = (valid_set.num_data,) + self._score_shape[1:]
        score = torch.zeros(shape, dtype=torch.float32, device=self.device)
        if valid_set.init_score is not None:
            score = score + valid_set.init_score.reshape(shape)
        for trees, avg in ((self.init_model_dev, False),
                           (self.models_dev, self.average_output)):
            if trees:
                score = score + self.predict_bins(trees, valid_set, avg)
        self.valid_scores.append(score)

    def warm_start(self, trees: List[Tree]) -> None:
        """Continue from an init model's host trees (reference:
        engine._warm_start, :337-351): they are put into the train
        Dataset's bin space and their raw score on its bins joins the train
        score as an init score (no boosting from the average); valid sets
        added later replay them too."""
        ts = self.train_set
        self.init_model_dev = [bin_tree(t, ts.mappers, ts.feature_map,
                                        self.device, ts.bundle_meta)
                               for t in trees]
        if self.init_model_dev:
            self.train_score = self.train_score + self.predict_bins(
                self.init_model_dev, ts)
        self._has_init_score = True

    def predict_bins(self, trees: List[TreeArrays], data,
                     average: bool = False) -> torch.Tensor:
        """Raw f32 score of device trees (K an iteration) on a Dataset's
        bins, tree by tree in order (reference: _predict_bins_dev,
        :1688-1706); the mean over iterations with ``average``."""
        k = self.num_tree_per_iteration
        out = torch.zeros((data.num_data,) + self._score_shape[1:],
                          dtype=torch.float32, device=self.device)
        for i, tree in enumerate(trees):
            delta = tree_delta(tree, data)
            if k == 1:
                out = out + delta
            else:
                out[:, i % k] += delta
        if average:
            out = out / (len(trees) // k)
        return out

    # ---- sampling ----
    @property
    def _bag(self) -> torch.Tensor:
        """The rows' bag weights of this iteration (all ones unbagged)."""
        return self._bag_ones if self._bag_mask is None else self._bag_mask

    def _update_bag(self, iter_idx: int, grad, hess) -> None:
        """Bagging (reference: _update_bag, gbdt.py:606-628): a fresh mask
        every bagging_freq iterations from a split of the bagging key,
        balanced by label under pos_/neg_bagging_fraction."""
        c = self.config
        need = c.bagging_freq > 0 and (c.bagging_fraction < 1.0
                                       or c.pos_bagging_fraction < 1.0
                                       or c.neg_bagging_fraction < 1.0)
        if not need:
            self._bag_mask = None
            return
        if iter_idx % c.bagging_freq != 0 and self._bag_mask is not None:
            return
        self._bag_key, sub = threefry.split(self._bag_key)
        u = threefry.uniform(sub, (self.train_set.num_data,), self.device)
        # the reference compares f32 uniforms with f32 fractions
        if c.pos_bagging_fraction < 1.0 or c.neg_bagging_fraction < 1.0:
            keep = torch.where(self.train_set.label > 0,
                               u < _f32(c.pos_bagging_fraction),
                               u < _f32(c.neg_bagging_fraction))
        else:
            keep = u < _f32(c.bagging_fraction)
        self._bag_mask = keep.to(torch.float32)

    def _feature_mask(self) -> torch.Tensor:
        """feature_fraction (reference: _feature_mask, gbdt.py:630-642):
        k of the F used features, drawn on the host once a tree."""
        f = self.train_set.num_features
        frac = self.config.feature_fraction
        if frac >= 1.0:
            return self._fmask_ones
        k = max(1, int(round(f * frac)))
        idx = self._feat_rng.choice(f, k, replace=False)
        mask = np.zeros(f, dtype=bool)
        mask[idx] = True
        # a blocking copy from the host: it waits for the stream
        with span("sync.column_mask"):
            return torch.as_tensor(mask, device=self.device)

    def train_one_iter(self, grad: Optional[torch.Tensor] = None,
                       hess: Optional[torch.Tensor] = None) -> bool:
        """One boosting iteration of K trees; True when none of them could
        split (the reference then stops without adding them,
        gbdt.cpp:430). ``grad``/``hess``: custom gradients ([N] or [N, K]
        f32, fobj), which take the unfused front with all three quantized
        channels, as the reference's custom step does."""
        k = self.num_tree_per_iteration
        if (self.iter_ == 0 and self.objective is not None
                and self.config.boost_from_average and not self._has_init_score
                and not self.models_dev and not self.average_output):
            # boost from average (gbdt.cpp:345,372-377); the multiclass
            # objectives have no init score
            for cls in range(k):
                init = self.objective.boost_from_score()
                if abs(init) > K_EPSILON:
                    self.init_scores[cls] = init
            if any(abs(v) > K_EPSILON for v in self.init_scores):
                with span("sync.init_score"):
                    shift = torch.as_tensor(
                        np.asarray(self.init_scores, dtype=np.float32),
                        device=self.device)
                shift = shift[0] if k == 1 else shift
                self.train_score = self.train_score + shift
                self.valid_scores = [s + shift for s in self.valid_scores]
        if grad is None and self.objective is None:
            raise LightGBMError("a custom objective (objective='none') "
                                "trains on the gradients of fobj")
        ts = self.train_set
        gp = self.gp if grad is None else self.gp_custom
        if grad is None and not self._pack_checked:
            self._check_pack_budget()
        # warn_skip_tree discards a non-finite iteration whole: what the
        # iteration mutates is kept aside until its flag is read
        saved = (self._iteration_state()
                 if self._nf_policy == "warn_skip_tree" else None)
        if grad is None and self._custom_grad:
            with span("iter.gradients"):
                grad, hess = self.objective.get_gradients(self.train_score)
        with span("iter.sample"):
            self._update_bag(self.iter_, grad, hess)
            bag = self._bag
            self._fmask = self._feature_mask()
        if gp.fused_obj is None and grad is None:
            with span("iter.gradients"):
                grad, hess = self.objective.get_gradients(self.train_score)

        def grow_all() -> bool:
            any_split = False
            for cls in range(k):
                if gp.fused_obj is not None:
                    # fused front: the kernels recompute the gradients from
                    # (score, aux, bag) and never materialize them
                    ghc = (None, None, None)
                    fused = (self.train_score, self._aux, bag)
                else:
                    # the class' contiguous gradient column (the kernels
                    # take no strided view)
                    g = grad if k == 1 else grad[:, cls].contiguous()
                    h = hess if k == 1 else hess[:, cls].contiguous()
                    ghc = (g * bag, h * bag, (bag > 0).to(torch.float32))
                    fused = None
                qseed = self.iter_ * k + cls     # gbdt.py:1504
                with span("grow.tree"):
                    tree, leaf_id, passes, rebuilds = self._grow(
                        gp, ghc, fused, qseed)
                self.hist_passes.append(passes)
                self.hist_rebuilds.append(rebuilds)
                any_split = any_split or tree.num_leaves > 1
                self._add_tree(tree, leaf_id, cls)
            return any_split

        any_split = (self._dp_dispatch(grow_all) if self._dp
                     else grow_all())
        # the non-finite guard: one device flag on the new train score, read
        # once an iteration (the level loop syncs once a level anyway)
        with span("sync.finite"):
            # tpu-lint: disable=host-sync-in-jit
            ok = bool(torch.isfinite(self.train_score).all())
        if self._nf_policy == "clip":
            self.train_score = _sanitize(self.train_score)
        if not ok:
            if saved is not None:
                warning(f"non-finite scores at iteration {self.iter_}; "
                        "discarding this iteration's tree(s) "
                        "(nonfinite_policy=warn_skip_tree)")
                obs.emit("nonfinite_guard", where="train_score",
                         policy=self._nf_policy, iteration=int(self.iter_),
                         action="skip_tree")
                self._restore_iteration_state(saved)
                self.iter_ += 1
                return False
            self._nonfinite_scores(self.iter_)
        self.iter_ += 1
        # the iteration's trees for the train_iter event's stats
        self._obs_trees = (self.iter_, self.models_dev[-k:])
        return self._end_iteration(not any_split)

    def _grow(self, gp: GrowParams, ghc, fused, qseed: int):
        """One class tree from the grower of the trainer's learner:
        (tree, leaf ids, passes, pool rebuilds); under the data-parallel
        learner the leaf ids are a list, one a shard."""
        ts = self.train_set
        # the leaf-wise grower draws only for bynode and extra_trees
        lossguide_q = qseed if (gp.ff_bynode < 1.0 or gp.split.extra_trees) \
            else None
        if self._fp:
            g, h, c = ghc
            tree, leaf_id, passes = grow_tree_fp(
                None, g, h, c, self._fp_num_bins, self._fp_na_bin,
                (pad_mask(self._fmask, self._fp_pad) if self._fp_pad
                 else self._fmask), gp, self._fmesh, bundle=self._fp_bundle,
                qseed=qseed, tiles=self._fp_tiles, forced=self.forced)
            return tree, leaf_id, passes, 0
        if self._dp:
            sp = self._shard_plan
            if fused is not None:
                fused_parts = list(zip(*(sp.split(x) for x in fused)))
                g_p = h_p = c_p = None
            else:
                fused_parts = None
                g_p, h_p, c_p = (sp.split(x) for x in ghc)
            if self.depthwise and gp.lean_ft > 0:
                fn, kw = grow_tree_depthwise_lean, {}
            elif self.depthwise:
                fn, kw = grow_tree_depthwise, dict(forced=self.forced,
                                                   cegb=self.cegb)
            else:
                fn, kw = grow_tree, dict(forced=self.forced)
                qseed = lossguide_q
            out = grow_tree_dp(
                self._dp_bins, g_p, h_p, c_p, ts.num_bins_dev,
                ts.na_bin_dev, self._fmask, gp, sp.mesh, grow_fn=fn,
                bundle=self.bundle, qseed=qseed, bins_T=self._dp_bins_T,
                fused=fused_parts,
                data_used=(self.cegb.data_used if self.cegb is not None
                           and fn is grow_tree_depthwise else None),
                feature_devices=sp.feature_devices, **kw)
            return out if len(out) == 4 else out + (0,)
        if self.depthwise and gp.lean_ft > 0:
            tree, leaf_id, passes = grow_tree_depthwise_lean(
                ts.bins_T, *ghc, ts.num_bins_dev, ts.na_bin_dev,
                self._fmask, gp, qseed=qseed, bins=ts.bins,
                bundle=self.bundle)
            return tree, leaf_id, passes, 0
        if self.depthwise:
            tree, leaf_id, passes = grow_tree_depthwise(
                ts.bins_T, *ghc, ts.num_bins_dev, ts.na_bin_dev,
                self._fmask, gp, qseed=qseed, fused=fused, bins=ts.bins,
                bundle=self.bundle, forced=self.forced, cegb=self.cegb,
                graphs=self._level_graphs)
            return tree, leaf_id, passes, 0
        return grow_tree(ts.bins_T, *ghc, ts.num_bins_dev, ts.na_bin_dev,
                         self._fmask, gp, bins=ts.bins, qseed=lossguide_q,
                         bundle=self.bundle, forced=self.forced)

    def _dp_dispatch(self, grow_all):
        """An iteration's trees under the data-parallel learner, behind the
        ``hist_allreduce`` fault point (reference: _fused_step's dispatch,
        gbdt.py:1148-1200): a device fault there, or in the growth, is
        retried with backoff from the iteration's saved state under a
        policy other than ``fatal``, as the reference retries its step."""
        policy = self.config.on_device_fault
        saved = self._iteration_state() if policy != "fatal" else None

        def attempt():
            # chaos point: the iteration's shard sums
            faults.fault_point("hist_allreduce")
            return grow_all()

        try:
            return attempt()
        except BaseException as e:
            if policy == "fatal" or not faults.is_device_fault(e):
                raise
            obs.emit("device_fault",
                     point=faults.classify_point(e, default="hist_allreduce"),
                     policy=policy, action="retry",
                     error=f"{type(e).__name__}: {e}", attempt=1)
            warning(f"device fault during the sharded step "
                    f"({type(e).__name__}: {e}); retrying")

        def again():
            nonlocal saved
            self._restore_iteration_state(saved)
            saved = self._iteration_state()
            return attempt()

        from ..utils.retry import call_with_backoff
        return call_with_backoff(
            again, attempts=max(2, int(self.config.network_retries)),
            base_delay=0.05, max_delay=1.0,
            should_retry=faults.is_device_fault, name="sharded step")

    def _check_pack_budget(self) -> None:
        """The reference's packed g/h lattice (hist_packed, resolved once
        a booster at its first step, gbdt.py:745-766): the port's kernels
        always sum separate channels, which unpacking gives bit for bit,
        but where the reference would fall back because the guard-bit
        budget does not fit the row count, the port records the same
        hist_pack_fallback event."""
        self._pack_checked = True
        mode = str(self.config.hist_packed).lower()
        if mode in ("false", "0") or not self.gp.quant:
            return
        n_rows = int(self.train_set.num_data)
        if pack_guard_bits(n_rows, self.gp.const_hess) == 0:
            obs.emit("hist_pack_fallback", n_rows=n_rows,
                     reason="guard_budget", requested=mode,
                     const_hess=bool(self.gp.const_hess))

    def obs_lagged_stats(self) -> Optional[Dict]:
        """{lagged_iteration, leaf_count, best_gain} of the newest
        iteration that kept its trees, for the train_iter event
        (reference: obs_lagged_stats, gbdt.py:1277-1298, whose stats lag 8
        iterations behind its asynchronous queue; the port's level loop
        syncs every level, so they describe the iteration just run unless
        it was skipped). None before the first such iteration or with
        telemetry off; reads the trees' split gains from the device."""
        if not obs.enabled() or self._obs_trees is None:
            return None
        it_no, trees = self._obs_trees
        best = 0.0
        for t in trees:
            if t.num_leaves > 1:
                best = max(best, float(t.split_gain[:t.num_leaves - 1].max()))
        return {"lagged_iteration": int(it_no),
                "leaf_count": int(sum(t.num_leaves for t in trees)),
                "best_gain": best}

    def _iteration_state(self):
        """What one iteration mutates: the scores (copied, since a K-class
        score updates in place), the tree count and the CEGB bookkeeping."""
        du = None if self.cegb is None else self.cegb.data_used
        cegb = None if self.cegb is None else dataclasses.replace(
            self.cegb, feature_used=self.cegb.feature_used.clone(),
            data_used=(None if du is None else
                       [b.clone() for b in du] if isinstance(du, list)
                       else du.clone()))
        return (self.train_score.clone(), [v.clone() for v in
                                           self.valid_scores],
                len(self.models_dev), len(self.hist_passes), cegb)

    def _restore_iteration_state(self, saved) -> None:
        (self.train_score, self.valid_scores, n_trees, n_passes,
         self.cegb) = saved
        del self.models_dev[n_trees:]
        del self.models_host[n_trees:]
        del self.hist_passes[n_passes:]
        del self.hist_rebuilds[n_passes:]

    def _nonfinite_scores(self, it_no: int) -> None:
        """Iteration ``it_no`` left a non-finite train score (reference:
        _check_nf_flag, gbdt.py:1432-1450): fatal raises, clip warns
        once."""
        obs.emit("nonfinite_guard", where="train_score",
                 policy=self._nf_policy, iteration=int(it_no))
        if self._nf_policy != "fatal":
            if not self._nf_warned:
                self._nf_warned = True
                warning(f"non-finite scores around iteration {it_no} "
                        f"(nonfinite_policy={self._nf_policy})")
            return
        fatal(f"non-finite scores detected at iteration {it_no} "
              "(nonfinite_policy=fatal): gradients, hessians or leaf "
              "values overflowed — lower learning_rate / check the "
              "objective, or set nonfinite_policy=warn_skip_tree|clip")

    def guard_gradients(self, grad: np.ndarray, hess: np.ndarray):
        """The non-finite guard on a custom objective's gradients, on the
        host before they reach the quantizer (reference: guard_gradients,
        gbdt.py:1705-1735); returns (grad, hess, skip)."""
        if bool(np.isfinite(grad).all() and np.isfinite(hess).all()):
            return grad, hess, False
        obs.emit("nonfinite_guard", where="custom_gradients",
                 policy=self._nf_policy, iteration=int(self.iter_))
        if self._nf_policy == "clip":
            if not self._nf_warned:
                self._nf_warned = True
                warning(f"custom objective produced non-finite gradients "
                        f"at iteration {self.iter_}; clipping "
                        "(nonfinite_policy=clip)")
            return _sanitize_np(grad), _sanitize_np(hess), False
        if self._nf_policy == "fatal":
            fatal(f"custom objective produced non-finite gradients at "
                  f"iteration {self.iter_} (nonfinite_policy=fatal)")
        warning(f"custom objective produced non-finite gradients at "
                f"iteration {self.iter_}; skipping this iteration "
                "(nonfinite_policy=warn_skip_tree)")
        return grad, hess, True

    def skip_one_iter(self) -> bool:
        """Advance the iteration count without growing trees (the
        warn_skip_tree policy discarded this iteration's gradients)."""
        self.iter_ += 1
        return False

    def _end_iteration(self, finished: bool) -> bool:
        """Close an iteration: one whose trees are all stumps ends
        training and leaves the model."""
        if finished:
            self._pop_trailing_stumps()
        return finished

    def _add_tree(self, tree: TreeArrays, leaf_id: torch.Tensor,
                  cls: int) -> None:
        """Finish one class tree (reference: the fused step's one_class,
        :914-959, and _grow_and_update, :1326-1341): renew the live leaves
        from the pre-tree score column (L1 family), shrink, fold its delta
        into the train score through take_small, fold the first
        iteration's bias into the stored tree, and fold it into the valid
        scores. Averaged models (RF) skip the renewal, the shrinkage and
        the bias."""
        k = self.num_tree_per_iteration
        lv = tree.leaf_value
        shard_ids = leaf_id if isinstance(leaf_id, list) else None
        if shard_ids is not None:
            # across processes the leaf ids cross only for a renewal
            leaf_id = (self._gather_rows(shard_ids)
                       if not self._pod or self._renews else None)
        if self.objective is not None and not self.average_output:
            with span("grow.leaf_renew"):
                renewed = self.objective.renew_leaf_values(
                    self.train_score if k == 1 else self.train_score[:, cls],
                    leaf_id, self.gp.num_leaves)
                if renewed is not None:
                    live = torch.arange(lv.shape[0], device=lv.device) \
                        < tree.num_leaves
                    lv = torch.where(live, renewed.to(lv.dtype), lv)
        with span("iter.score_update"):
            with span("sync.shrink"):
                shrink = torch.tensor(1.0 if self.average_output
                                      else self.learning_rate,
                                      dtype=torch.float32, device=self.device)
            tree = tree._replace(leaf_value=lv * shrink,
                                 internal_value=tree.internal_value * shrink)
            if shard_ids is None:
                delta = take_small(tree.leaf_value, leaf_id)
            else:
                # the score update runs on each shard's rows
                delta = self._gather_rows(
                    [take_small(tree.leaf_value.to(i.device), i)
                     for i in shard_ids])
            self.train_score = self._apply_tree_delta(self.train_score, delta,
                                                      cls)
            if self._nf_policy == "clip":
                # the stored tree and its valid-set deltas are capped, as in
                # the reference's fused step (:1006-1018)
                tree = tree._replace(
                    leaf_value=_sanitize(tree.leaf_value),
                    internal_value=_sanitize(tree.internal_value))
            bias = self.init_scores[cls] if self.iter_ == 0 else 0.0
            if abs(bias) > K_EPSILON and not self.average_output:
                tree = tree._replace(leaf_value=tree.leaf_value + bias,
                                     internal_value=tree.internal_value + bias)
            else:
                bias = 0.0
            for i, vs in enumerate(self.valid_sets):
                self.valid_scores[i] = self._apply_tree_delta(
                    self.valid_scores[i], tree_delta(tree, vs) - bias, cls)
            self.models_dev.append(tree)

    def _apply_tree_delta(self, score: torch.Tensor, delta: torch.Tensor,
                          cls: int) -> torch.Tensor:
        """Fold one class tree's row deltas into a score (reference:
        _apply_tree_delta, :1027-1036): boosting adds; RF averages."""
        if self.num_tree_per_iteration == 1:
            return score + delta
        score[:, cls] += delta
        return score

    def _pop_trailing_stumps(self) -> None:
        """Drop trailing all-stump iterations, K trees at a time (their
        score deltas stay in the scores, as in the reference)."""
        k = self.num_tree_per_iteration
        while len(self.models_dev) >= k and all(
                t.num_leaves <= 1 for t in self.models_dev[-k:]):
            del self.models_dev[-k:]
        del self.models_host[len(self.models_dev):]

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's K trees (reference: rollback_one_iter,
        gbdt.py:1601-1643): each tree's replay on the train and valid
        Datasets' bins (route_bins + take_small, by membership as every
        replay of the port; the reference routes categorical and bundle
        nodes by threshold there) comes off their scores. As in the
        reference, the first iteration's bias folded into its stored trees
        comes off too."""
        if self.iter_ <= 0:
            return
        k = self.num_tree_per_iteration
        for cls in reversed(range(k)):
            tree = self.models_dev.pop()
            # a plain subtraction whatever the booster (the reference's)
            self.train_score = GBDT._apply_tree_delta(
                self, self.train_score, -tree_delta(tree, self.train_set),
                cls)
            for i, vs in enumerate(self.valid_sets):
                self.valid_scores[i] = GBDT._apply_tree_delta(
                    self, self.valid_scores[i], -tree_delta(tree, vs), cls)
        del self.models_host[len(self.models_dev):]
        self.iter_ -= 1

    # ---- evaluation ----
    def _eval(self, name: str, score: torch.Tensor, data
              ) -> List[Tuple[str, str, float, bool]]:
        score = score.to(torch.float64)
        conv = (self.objective.convert_output(score)
                if self.objective is not None else score)
        # the ranking metrics read the Dataset's kept grid of its queries
        group = (data.query_grid(score.device)
                 if any(m.eval_at is not None for m in self.metrics)
                 else None)
        return [(name, m.name,
                 m(data.label, conv if m.use_prob else score, data.weight,
                   group),
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
                                 ts.feature_map, ts.bundle_meta)
            t.shrinkage = 1.0 if self.average_output else self.learning_rate
            self.models_host.append(t)
        return self.models_host

    def num_trees(self) -> int:
        return len(self.models_dev)

    # ---- crash-safe resume (the snapshot sidecar; snapshot.py) ----
    # the config fields that decide the training trajectory: a snapshot
    # resumes only under a config that agrees on all of them (reference:
    # _RESUME_FP_KEYS, gbdt.py:1747-1760)
    _RESUME_FP_KEYS = (
        "objective", "boosting", "num_class", "num_leaves", "max_depth",
        "learning_rate", "max_bin", "min_data_in_leaf",
        "min_sum_hessian_in_leaf", "lambda_l1", "lambda_l2",
        "min_gain_to_split", "max_delta_step", "bagging_fraction",
        "pos_bagging_fraction", "neg_bagging_fraction", "bagging_freq",
        "bagging_seed", "feature_fraction", "feature_fraction_bynode",
        "feature_fraction_seed", "extra_trees", "extra_seed", "grow_policy",
        "tree_learner", "use_quantized_grad", "seed", "data_random_seed",
        "boost_from_average", "drop_rate", "skip_drop", "max_drop",
        "uniform_drop", "xgboost_dart_mode", "drop_seed", "top_rate",
        "other_rate")
    _RNGS = ("_feat_rng", "_bag_rng", "_drop_rng")

    def _resume_fingerprint(self) -> Dict:
        c = self.config
        out = {}
        for key in self._RESUME_FP_KEYS:
            v = getattr(c, key, None)
            out[key] = list(v) if isinstance(v, (list, tuple)) else v
        out["boosting_class"] = type(self).__name__
        out["num_data"] = int(self.train_set.num_data)
        out["num_features"] = int(self.train_set.num_features)
        return out

    def get_resume_state(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """The trainer's exact state for the snapshot sidecar (reference:
        get_resume_state, gbdt.py:1778-1836): the device trees, the f32
        train score read back from the device, the init scores in f64, the
        threefry bag key and the bag mask, every RandomState and the CEGB
        bookkeeping, under the reference's key names. The model text
        cannot serve: the first tree's bias is folded in f32 and the text
        has no bins, so a resume from text would leave the uninterrupted
        run's path."""
        arrays: Dict[str, np.ndarray] = {}
        meta: Dict = {
            "format_version": 1,
            "iter": int(self.iter_),
            "num_trees": len(self.models_dev),
            "learning_rate": float(self.learning_rate),
            "has_init_score": bool(self._has_init_score),
            "has_bag_mask": self._bag_mask is not None,
            # informational: the state is stored unsharded, so a resume
            # re-shards onto any shard count (reference: gbdt.py:1784-1792)
            "num_shards": (self._shard_plan.shards_global
                           if self._shard_plan is not None else 1),
            "fingerprint": self._resume_fingerprint(),
        }
        arrays["train_score"] = self.train_score.cpu().numpy()
        arrays["init_scores"] = np.asarray(self.init_scores,
                                           dtype=np.float64)
        arrays["bag_key"] = np.asarray(self._bag_key, dtype=np.uint32)
        if self._bag_mask is not None:
            arrays["bag_mask"] = self._bag_mask.cpu().numpy()
        for nm in self._RNGS:
            r = getattr(self, nm, None)
            if isinstance(r, np.random.RandomState):
                st = r.get_state()
                arrays[f"rng{nm}_keys"] = np.asarray(st[1], dtype=np.uint32)
                arrays[f"rng{nm}_pos"] = np.asarray([st[2], st[3]],
                                                    dtype=np.int64)
                arrays[f"rng{nm}_gauss"] = np.asarray([st[4]],
                                                      dtype=np.float64)
        if self.models_dev:
            for f in TreeArrays._fields:
                arrays[f"trees_{f}"] = (
                    np.asarray([t.num_leaves for t in self.models_dev],
                               dtype=np.int32) if f == "num_leaves"
                    else torch.stack([getattr(t, f) for t in
                                      self.models_dev]).cpu().numpy())
        if self.cegb is not None:
            # the reference's four CEGBState fields, its [1, 1] placeholder
            # for an absent lazy bitset included (gbdt.py:1822-1828)
            du = self._cegb_data_used()
            for f, t in (("feature_used", self.cegb.feature_used),
                         ("data_used", du),
                         ("coupled_pen", self.cegb.coupled_pen),
                         ("lazy_pen", self.cegb.lazy_pen)):
                arrays[f"cegb_{f}"] = (np.zeros((1, 1), dtype=bool)
                                       if t is None else t.cpu().numpy())
        self._extra_resume_state(arrays, meta)
        return arrays, meta

    def set_resume_state(self, arrays: Dict[str, np.ndarray],
                         meta: Dict) -> None:
        """Restore what ``get_resume_state`` saved (reference:
        set_resume_state, gbdt.py:1838-1908). Raises ValueError, before any
        state changes, when the snapshot was taken under another config or
        Dataset (naming the fields that differ)."""
        fp = self._resume_fingerprint()
        got = dict(meta.get("fingerprint") or {})
        diff = sorted(k for k in set(fp) | set(got)
                      if fp.get(k) != got.get(k))
        if diff:
            raise ValueError(
                "snapshot was taken under a different configuration; "
                "mismatched field(s): " + ", ".join(diff))
        if tuple(arrays["train_score"].shape) != tuple(self.train_score.shape):
            raise ValueError(
                f"snapshot score shape {arrays['train_score'].shape} != "
                f"trainer score shape {tuple(self.train_score.shape)}")
        cegb = self._resumed_cegb(arrays)
        dev = self.device
        self.iter_ = int(meta["iter"])
        self.learning_rate = float(meta["learning_rate"])
        self._has_init_score = bool(meta["has_init_score"])
        self.init_scores = [float(v) for v in arrays["init_scores"]]
        self.train_score = torch.as_tensor(
            np.asarray(arrays["train_score"], np.float32), device=dev)
        self._bag_key = tuple(int(v) for v in arrays["bag_key"])
        self._bag_mask = (torch.as_tensor(arrays["bag_mask"], device=dev)
                          if "bag_mask" in arrays else None)
        for nm in self._RNGS:
            r = getattr(self, nm, None)
            key = f"rng{nm}_keys"
            if isinstance(r, np.random.RandomState) and key in arrays:
                pos = arrays[f"rng{nm}_pos"]
                r.set_state(("MT19937", arrays[key], int(pos[0]),
                             int(pos[1]),
                             float(arrays[f"rng{nm}_gauss"][0])))
        self.models_dev = []
        self.models_host = []
        for t in range(int(meta["num_trees"])):
            self.models_dev.append(TreeArrays(**{
                f: (int(arrays[f"trees_{f}"][t]) if f == "num_leaves"
                    else torch.as_tensor(arrays[f"trees_{f}"][t],
                                         device=dev))
                for f in TreeArrays._fields}))
        self.cegb = cegb
        self._apply_extra_resume_state(arrays, meta)

    def _resumed_cegb(self, arrays: Dict[str, np.ndarray]
                      ) -> Optional[CEGBState]:
        """The CEGB bookkeeping of a sidecar (the reference's cegb_* keys):
        which columns were split on and which (row, column) pairs paid the
        lazy penalty, over this trainer's own penalty vectors and lazy
        columns, which its config gives. Raises ValueError when the
        sidecar's penalties or bitset shape are another run's."""
        c = self.cegb
        if c is None or "cegb_feature_used" not in arrays:
            return c
        for f in ("coupled_pen", "lazy_pen"):
            key = f"cegb_{f}"
            if key in arrays and not np.array_equal(
                    np.asarray(arrays[key], np.float32),
                    getattr(c, f).cpu().numpy()):
                raise ValueError(f"snapshot was taken under other CEGB "
                                 f"penalties ({key})")
        du = self._cegb_data_used()
        if du is not None:
            got = np.asarray(arrays.get("cegb_data_used",
                                        np.zeros((1, 1), bool)))
            if got.shape != tuple(du.shape):
                raise ValueError(f"snapshot's cegb_data_used {got.shape} "
                                 f"!= the trainer's {tuple(du.shape)}")
            du = torch.as_tensor(got.astype(bool), device=self.device)
            if self._shard_plan is not None:
                du = self._shard_plan.split(du)
        return dataclasses.replace(c, feature_used=torch.as_tensor(
            np.asarray(arrays["cegb_feature_used"], bool),
            device=self.device), data_used=du)

    def _extra_resume_state(self, arrays: Dict[str, np.ndarray],
                            meta: Dict) -> None:
        """Subclass hook: a booster's own state (DART's tree weights)."""

    def _apply_extra_resume_state(self, arrays: Dict[str, np.ndarray],
                                  meta: Dict) -> None:
        """Subclass hook: restore what ``_extra_resume_state`` saved."""
