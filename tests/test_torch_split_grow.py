"""Split search and depthwise grower of the PyTorch/CUDA port
(lightgbm_tpu_torch) against the JAX reference (lightgbm_tpu), on the CPU.

Exact: the fixed-order prefix sum and window sum against XLA's, the split
records (gain, feature, bin, missing direction, left sums) on random and
near-tie histograms, and the grown tree's structure and final leaf ids,
through the fused front (B = 64) and through the unfused one from
materialized rows (B = 256, F * B > 2048). Tolerance: the grown tree's leaf
values, renewed from leaf sums whose reference keeps 16 significant bits
per row (bf16 hi + lo): rtol 1e-4. Unquantized (the leaf-wise grower and
the depthwise one with quantization off) on exact-sum data, gradients and
hessians on a 1/8 grid whose every partial sum is exact in f32: every
array of the grown tree and the leaf ids, exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.ops import grow as ref_grow
from lightgbm_tpu.ops import grow_depthwise as ref_gd
from lightgbm_tpu.ops import split as ref_split
from lightgbm_tpu_torch.ops import grow as t_grow
from lightgbm_tpu_torch.ops import grow_depthwise as t_gd
from lightgbm_tpu_torch.ops import scan, split as t_split

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b", [16, 64, 256])
def test_blocked_cumsum_matches_xla(b):
    # exact: XLA:CPU scans 16-wide blocks plus a block-total carry
    rng = np.random.default_rng(b)
    x = (rng.normal(size=(4, 3, 5, b)) * 50).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    np.testing.assert_array_equal(scan.blocked_cumsum(_t(x)).numpy(), ref)


@pytest.mark.parametrize("n", [64, 128, 256])
def test_tree_sum_matches_xla(n):
    # exact: XLA:CPU reduces 32-element windows, then the window sums
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(6, n)) * 50).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: a.sum(-1))(x))
    np.testing.assert_array_equal(scan.tree_sum(_t(x)).numpy(), ref)


def _hist(rng, L, F, B, num_bins, na_bin):
    cnt = rng.integers(0, 12, size=(L, F, B)).astype(np.float32)
    cnt[:, np.arange(B)[None, :] >= num_bins[:, None]] = 0.0
    g = (rng.normal(size=(L, F, B)) * cnt).astype(np.float32)
    h = (rng.uniform(0.1, 0.3, size=(L, F, B)) * cnt).astype(np.float32)
    return np.stack([g, h, cnt], axis=1)


def _compare_split(hist, num_bins, na_bin, params, fmask=None, allow=None):
    L = hist.shape[0]
    pg = hist[:, 0, 0].sum(-1).astype(np.float32)
    ph = hist[:, 1, 0].sum(-1).astype(np.float32)
    pc = hist[:, 2, 0].sum(-1).astype(np.float32)
    if allow is None:
        allow = np.ones(L, bool)
        allow[-1] = False
    if fmask is None:
        fmask = np.ones(hist.shape[2], bool)
    ref = ref_split.best_split(
        jnp.asarray(hist), jnp.asarray(num_bins), jnp.asarray(na_bin),
        jnp.asarray(pg), jnp.asarray(ph), jnp.asarray(pc), jnp.asarray(fmask),
        ref_split.SplitParams(**params), jnp.asarray(allow))
    got = t_split.best_split(
        _t(hist), _t(num_bins), _t(na_bin), _t(pg), _t(ph), _t(pc),
        _t(fmask), t_split.SplitParams(**params), _t(allow))
    for name in ("gain", "feature", "bin", "default_left", "left_g",
                 "left_h", "left_cnt"):
        # bit for bit: a -0.0 against +0.0 fails too
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(ref, name)).astype(a.dtype)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert not got.is_cat.any() and not got.cat_member.any()
    return got


@pytest.mark.parametrize("params", [
    {"min_data_in_leaf": 5},
    {"min_data_in_leaf": 2, "lambda_l1": 0.5, "lambda_l2": 1.5,
     "min_gain_to_split": 0.1},
    {"min_data_in_leaf": 3, "max_delta_step": 0.4,
     "min_sum_hessian_in_leaf": 2.0},
])
@pytest.mark.parametrize("B", [16, 64, 128, 256])
def test_best_split_exact_random(params, B):
    # exact split records, with missing bins (both directions searched) and
    # features whose bin count is below the padded axis
    rng = np.random.default_rng(B)
    L, F = 9, 6
    num_bins = rng.integers(3, B + 1, size=F).astype(np.int32)
    na_bin = np.full(F, 256, np.int32)
    na_bin[1] = num_bins[1] - 1
    na_bin[4] = 0
    _compare_split(_hist(rng, L, F, B, num_bins, na_bin), num_bins, na_bin,
                   params)


def test_best_split_exact_near_ties():
    # exact: duplicated features give exactly tied gains and a scaled copy
    # gives gains inside the TIE_RTOL band; the lowest flat index must win
    rng = np.random.default_rng(5)
    L, F, B = 6, 5, 16
    num_bins = np.full(F, B, np.int32)
    na_bin = np.full(F, 256, np.int32)
    hist = _hist(rng, L, F, B, num_bins, na_bin)
    hist[:, :, 3] = hist[:, :, 1]
    hist[:, 0, 4] = hist[:, 0, 1] * np.float32(1 + 3e-7)
    hist[:, 1:, 4] = hist[:, 1:, 1]
    _compare_split(hist, num_bins, na_bin, {"min_data_in_leaf": 3})


@pytest.mark.parametrize("B", [64, 128, 256])
def test_best_split_exact_near_ties_at_the_kernel_widths(B):
    # the near-tie case at the bin axes the card's kernel takes, with a
    # missing bin on the tied features, so that the band spans both planes
    rng = np.random.default_rng(B + 5)
    L, F = 6, 5
    num_bins = np.full(F, B - 3, np.int32)
    na_bin = np.full(F, 256, np.int32)
    na_bin[[1, 3]] = B - 4
    hist = _hist(rng, L, F, B, num_bins, na_bin)
    hist[:, :, 3] = hist[:, :, 1]
    hist[:, 0, 4] = hist[:, 0, 1] * np.float32(1 + 3e-7)
    hist[:, 1:, 4] = hist[:, 1:, 1]
    _compare_split(hist, num_bins, na_bin, {"min_data_in_leaf": 3})


SPLIT_CASES = ("leaf_mask", "allow_partly", "all_masked", "empty_child",
               "neg_zero")


@pytest.mark.parametrize("B", [64, 128, 256])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_best_split_exact_cases(case, B):
    # the edges of the numerical search the card's kernel must equal: a
    # feature mask per leaf; allow_split partly false; a leaf whose every
    # candidate is masked (flat index 0: feature 0, bin 0, missing right);
    # an empty child (h = 0 on one side, 0 / eps); a -0.0 in the first bin
    # (the first block's + 0.0 makes it +0.0)
    rng = np.random.default_rng(B * 7 + SPLIT_CASES.index(case))
    L, F = 8, 6
    num_bins = rng.integers(3, B + 1, size=F).astype(np.int32)
    na_bin = np.full(F, 256, np.int32)
    na_bin[1] = num_bins[1] - 1
    na_bin[4] = 0
    hist = _hist(rng, L, F, B, num_bins, na_bin)
    params = {"min_data_in_leaf": 2, "lambda_l2": 0.5}
    fmask = allow = None
    if case == "leaf_mask":
        fmask = rng.random((L, F)) < 0.6
        fmask[2] = False
    elif case == "allow_partly":
        allow = rng.random(L) < 0.5
        allow[0], allow[1] = True, False
    elif case == "all_masked":
        fmask = np.ones((L, F), bool)
        fmask[3] = False
        hist[5] = 0.0
    elif case == "empty_child":
        # each leaf's rows lie in the bins below num_bins // 2: every
        # threshold from there on leaves the right child empty
        for f in range(F):
            hist[:, :, f, num_bins[f] // 2:] = 0.0
        # lambda_l2 > 0: at 0 the denominator of an empty side is the
        # 1e-38 guard alone, a subnormal that XLA:CPU flushes to zero
        # (an infinite gain) and torch keeps (the card's test takes it)
        params = {"min_data_in_leaf": 0, "min_sum_hessian_in_leaf": 0.0,
                  "lambda_l2": 0.5}
    else:
        hist[:, 0, :, 0] = -0.0
        hist[:, 1, :, 0] = -0.0
    got = _compare_split(hist, num_bins, na_bin, params, fmask, allow)
    if case == "all_masked":
        assert got.feature[3] == 0 and got.bin[3] == 0
        assert not got.default_left[3] and got.gain[3] == t_split.NEG_INF
        assert got.gain[5] == t_split.NEG_INF
    if case == "neg_zero":
        # the first block's + 0.0: the prefix sum at bin 0 is +0.0
        cum = scan.blocked_cumsum(_t(hist))
        assert not torch.signbit(cum[:, :2, :, 0]).any()


def test_numerical_only_takes_the_kernel_paths():
    # the card's dispatch: only searches without categorical columns (in
    # range), bundles, monotone constraints, feature_contri or extra_trees
    # take S1; CEGB's penalty is checked at the call
    assert t_split.numerical_only(t_split.SplitParams(), 6)
    assert t_split.numerical_only(t_split.SplitParams(cat_features=(7,)), 6)
    assert t_split.numerical_only(
        t_split.SplitParams(monotone_constraints=(0, 0)), 6)
    assert t_split.numerical_only(
        t_split.SplitParams(feature_contri=(1.0,)), 6)
    for kw in ({"cat_features": (3,)}, {"has_bundles": True},
               {"monotone_constraints": (1, 0)}, {"monotone_clamp": True},
               {"feature_contri": (0.5,)}, {"contri_active": True},
               {"extra_trees": True}):
        assert not t_split.numerical_only(t_split.SplitParams(**kw), 6), kw


@pytest.mark.parametrize("objective", ["l2", "logloss"])
def test_grow_tree_depthwise_matches_reference(objective):
    # exact tree structure and leaf ids of one grown tree through the fused
    # front; leaf values rtol 1e-4 (hi/lo leaf sums, see module docstring)
    rng = np.random.default_rng(11)
    N, F, B, L = 300, 6, 64, 15
    nb = 20
    bins = rng.integers(0, nb, size=(N, F)).astype(np.uint8)
    bins[rng.random(N) < 0.1, 2] = nb - 1          # feature 2: NaN bin
    num_bins = np.full(F, nb, np.int32)
    na_bin = np.full(F, 256, np.int32)
    na_bin[2] = nb - 1
    score = (rng.normal(size=N) * 0.3).astype(np.float32)
    if objective == "l2":
        spec = ("l2",)
        aux = (np.round((bins[:, 0] * 0.1 + bins[:, 3] * 0.05
                         + rng.normal(size=N)) * 8) / 8).astype(np.float32)
    else:
        spec = ("logloss", 1.0, 1.0, 1.0)
        aux = ((bins[:, 0] + rng.integers(0, 8, N)) > 12).astype(np.float32)
    bag = np.ones(N, np.float32)
    const_hess = objective == "l2"
    sp = dict(min_data_in_leaf=5)
    ref_gp = ref_grow.GrowParams(
        num_leaves=L, max_bin=B, split=ref_split.SplitParams(**sp),
        hist_impl="pallas", quant=True, const_hess=const_hess, fused_obj=spec)
    dummy = jnp.zeros(N, jnp.float32)
    ref_tree, ref_lid = ref_gd.grow_tree_depthwise(
        jnp.asarray(bins), dummy, dummy, dummy, jnp.asarray(num_bins),
        jnp.asarray(na_bin), jnp.ones(F, bool), ref_gp, qseed=jnp.int32(3),
        bins_T=jnp.asarray(bins.T),
        fused=(jnp.asarray(score), jnp.asarray(aux), jnp.asarray(bag)))
    gp = t_grow.GrowParams(num_leaves=L, max_bin=B,
                           split=t_split.SplitParams(**sp), quant=True,
                           const_hess=const_hess, fused_obj=spec)
    tree, lid, passes = t_gd.grow_tree_depthwise(
        _t(bins.T), None, None, None, _t(num_bins), _t(na_bin),
        torch.ones(F, dtype=torch.bool), gp, qseed=3,
        fused=(_t(score), _t(aux), _t(bag)))
    _compare_tree(tree, lid, passes, ref_tree, ref_lid)


def _compare_tree(tree, lid, passes, ref_tree, ref_lid):
    nl = int(ref_tree.num_leaves)
    assert tree.num_leaves == nl and nl > 4 and passes >= 2
    m = nl - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(
            getattr(tree, name).numpy()[:m],
            np.asarray(getattr(ref_tree, name))[:m], err_msg=name)
    np.testing.assert_array_equal(lid.numpy(), np.asarray(ref_lid))
    np.testing.assert_allclose(tree.leaf_value.numpy()[:nl],
                               np.asarray(ref_tree.leaf_value)[:nl],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(tree.leaf_count.numpy()[:nl],
                                  np.asarray(ref_tree.leaf_count)[:nl])


@pytest.mark.parametrize("objective", ["l2", "logloss"])
def test_grow_tree_depthwise_unfused_matches_reference(objective):
    # exact tree structure and leaf ids of one tree grown from materialized
    # (g, h, c) rows at B = 256 (F * B = 2304 > 2048: make_quant, the root
    # hist_q8, route_level + hist_q8 per level, leaf_sums renewal); leaf
    # values rtol 1e-4 (hi/lo leaf sums, see module docstring)
    from lightgbm_tpu.ops.pallas_hist import _grad_rows
    rng = np.random.default_rng(17)
    N, F, B, L = 400, 9, 256, 15
    nb = 200
    bins = rng.integers(0, nb, size=(N, F)).astype(np.uint8)
    bins[rng.random(N) < 0.1, 4] = nb - 1          # feature 4: NaN bin
    num_bins = np.full(F, nb, np.int32)
    na_bin = np.full(F, 256, np.int32)
    na_bin[4] = nb - 1
    score = (rng.normal(size=N) * 0.3).astype(np.float32)
    if objective == "l2":
        spec = ("l2",)
        aux = (np.round((bins[:, 0] * 0.01 + bins[:, 3] * 0.005
                         + rng.normal(size=N)) * 8) / 8).astype(np.float32)
    else:
        spec = ("logloss", 1.0, 1.0, 1.0)
        aux = ((bins[:, 0] + rng.integers(0, 80, N)) > 120).astype(np.float32)
    bag = (rng.random(N) < 0.9).astype(np.float32)
    grad, hess = _grad_rows(spec, jnp.asarray(score), jnp.asarray(aux))
    g = np.asarray(grad) * bag
    h = np.asarray(hess) * bag
    c = (bag > 0).astype(np.float32)
    const_hess = objective == "l2"
    sp = dict(min_data_in_leaf=5)
    ref_gp = ref_grow.GrowParams(
        num_leaves=L, max_bin=B, split=ref_split.SplitParams(**sp),
        hist_impl="pallas", quant=True, const_hess=const_hess)
    ref_tree, ref_lid = ref_gd.grow_tree_depthwise(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(c),
        jnp.asarray(num_bins), jnp.asarray(na_bin), jnp.ones(F, bool),
        ref_gp, qseed=jnp.int32(5), bins_T=jnp.asarray(bins.T))
    gp = t_grow.GrowParams(num_leaves=L, max_bin=B,
                           split=t_split.SplitParams(**sp), quant=True,
                           const_hess=const_hess)
    tree, lid, passes = t_gd.grow_tree_depthwise(
        _t(bins.T), _t(g), _t(h), _t(c), _t(num_bins), _t(na_bin),
        torch.ones(F, dtype=torch.bool), gp, qseed=5)
    _compare_tree(tree, lid, passes, ref_tree, ref_lid)


@pytest.mark.parametrize("grower,B,max_depth", [
    ("lossguide", 64, -1), ("lossguide", 256, 3), ("depthwise", 64, -1),
    ("depthwise", 256, -1)])
def test_unquantized_growers_match_reference_exactly(grower, B, max_depth):
    # exact-sum data (g = score - label with both on a 1/8 grid, h = 1, a
    # 0/1 bag): the reference's hi/lo histograms and the port's f32 ones
    # are the same numbers, so every TreeArrays field and the leaf ids
    # must be identical, leaf values included (no leaf renewal without
    # quantization)
    rng = np.random.default_rng(23 + B)
    N, F, L = 400, 9, 11
    nb = 40 if B == 64 else 200
    bins = rng.integers(0, nb, size=(N, F)).astype(np.uint8)
    bins[rng.random(N) < 0.1, 4] = nb - 1          # feature 4: NaN bin
    num_bins = np.full(F, nb, np.int32)
    na_bin = np.full(F, 256, np.int32)
    na_bin[4] = nb - 1
    label = np.clip(np.floor((bins[:, 0] / nb * 2 + rng.random(N)) * 8) / 8,
                    0, 3.875).astype(np.float32)
    score = (np.round(rng.normal(size=N) * 2) / 8).astype(np.float32)
    bag = (rng.random(N) < 0.9).astype(np.float32)
    g = (score - label) * bag
    h = bag.copy()
    c = bag.copy()
    sp = dict(min_data_in_leaf=5)
    ref_gp = ref_grow.GrowParams(
        num_leaves=L, max_depth=max_depth, max_bin=B,
        split=ref_split.SplitParams(**sp), hist_impl="pallas", quant=False)
    ref_fn = ref_grow.grow_tree if grower == "lossguide" \
        else ref_gd.grow_tree_depthwise
    ref_tree, ref_lid = ref_fn(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(c),
        jnp.asarray(num_bins), jnp.asarray(na_bin), jnp.ones(F, bool),
        ref_gp, bins_T=jnp.asarray(bins.T))
    gp = t_grow.GrowParams(num_leaves=L, max_depth=max_depth, max_bin=B,
                           split=t_split.SplitParams(**sp))
    args = (_t(bins.T), _t(g), _t(h), _t(c), _t(num_bins), _t(na_bin),
            torch.ones(F, dtype=torch.bool), gp)
    if grower == "lossguide":
        tree, lid, passes, rebuilds = t_grow.grow_tree(*args)
        assert passes == tree.num_leaves - 1 and rebuilds == 0
    else:
        tree, lid, passes = t_gd.grow_tree_depthwise(*args, qseed=0)
        assert passes >= 2
    assert tree.num_leaves == int(ref_tree.num_leaves) > 4
    for name in t_grow.TreeArrays._fields[:-1]:
        np.testing.assert_array_equal(
            getattr(tree, name).numpy(),
            np.asarray(getattr(ref_tree, name)).astype(
                getattr(tree, name).numpy().dtype), err_msg=name)
    np.testing.assert_array_equal(lid.numpy(), np.asarray(ref_lid))


@pytest.mark.parametrize("L,max_levels", [(7, 6), (255, 254), (63, 5)])
def test_level_widths_match_reference_schedule(L, max_levels):
    # the per-level selection caps reproduce the reference's bucketed
    # schedule on its kernel path (slot floor 32, master widths)
    import math
    from lightgbm_tpu.ops.pallas_hist import floor_slot_width
    max_slots = max(1, L // 2)
    n_unroll = min(max_levels, max(1, math.ceil(math.log2(max(L - 1, 2))))
                   + 1)
    ref = [floor_slot_width(max(min(2 ** k, max_slots), ref_gd._SLOT_FLOOR),
                            max_slots) for k in range(n_unroll)]
    ref += [max_slots] * (max_levels - n_unroll)
    assert t_gd.level_widths(L, max_levels) == ref
