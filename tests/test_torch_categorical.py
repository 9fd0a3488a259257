"""Categorical features in the PyTorch/CUDA port (lightgbm_tpu_torch),
held against the JAX reference (lightgbm_tpu) on the CPU.

The reference runs its Pallas kernels in interpret mode
(histogram_impl=pallas); the port runs each kernel wrapper on CPU tensors,
i.e. through the kernel's plain PyTorch version. Inputs are made from a
seed with numpy and handed to both as the same arrays.

Tolerances (each stated where it is asserted):
- exact: categorical mappers (cat_values, num_bins, missing type,
  feature info) and bins, NaN, negative, unseen and non-integer values
  included; every field of ``best_split``'s record with categorical
  features (one-hot, ascending and descending subsets, max_cat_threshold,
  cat_smooth, min_data_per_group, ties, -0.0 sums); the level routing
  (route_level) and the fused level pass (hist_routed_fused) with
  categorical membership; the structure and cat_threshold bitsets of the
  first binary tree (queue C1) and of every tree of L2 models on labels
  whose sums are exact, on the fused quantized, unquantized and lossguide
  paths;
- leaf values and predictions rtol 1e-4 (queue C2: the reference renews
  leaves from bf16 hi/lo sums).

The card-side checks of the two kernels' membership are in
tests/test_torch_cuda.py.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu import binning as ref_binning
from lightgbm_tpu.ops import histogram as ref_hist
from lightgbm_tpu.ops import pallas_hist as ph
from lightgbm_tpu.ops import split as ref_split
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import binning as t_binning
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import split as t_split

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 5,
        "verbosity": -1, "prewarm": 0, "histogram_impl": "pallas",
        "min_data_per_group": 10, "cat_smooth": 5.0}
CATS = [0, 1, 3]
NAMES = ["month", "station", "x", "kind", "z"]
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child", "is_cat_node")
TEXT_KEYS = ("split_feature=", "threshold=", "decision_type=",
             "left_child=", "right_child=", "num_cat=", "cat_boundaries=",
             "cat_threshold=")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cat_data(n=2000, seed=0, valid=False):
    """Five columns: month (12 categories), station (a Zipf-skewed code
    with a rare tail, some NaN), a numeric one, kind (3 categories, the
    one-hot scan) and a numeric one with NaN. The label follows random
    per-category effects that are not monotone in the code. A valid set
    (valid=True) adds unseen and negative categories and NaN."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 5), np.float32)
    X[:, 0] = rng.randint(0, 12, n)
    X[:, 1] = np.minimum(rng.zipf(1.4, n) - 1, 150)
    X[:, 2] = rng.rand(n)
    X[:, 3] = rng.randint(0, 3, n)
    X[:, 4] = rng.rand(n)
    X[rng.rand(n) < 0.03, 1] = np.nan
    X[rng.rand(n) < 0.05, 4] = np.nan
    if valid:
        X[rng.rand(n) < 0.05, 0] = 12 + rng.randint(0, 3)
        X[rng.rand(n) < 0.05, 1] = 500.0
        X[rng.rand(n) < 0.02, 3] = -1.0
    eff = np.random.RandomState(99).normal(size=(2, 160))
    st = np.nan_to_num(X[:, 1], nan=0).astype(int) % 160
    lat = (eff[0, X[:, 0].astype(int) % 12] + eff[1, st]
           + (X[:, 3] == 1) + X[:, 2] + 0.5 * rng.randn(n))
    yb = (lat > 0.6).astype(np.float32)
    # L2 labels on a 1/8 grid: their f32 mean is exact in any order
    yr = (np.round(np.clip(lat, -3, 3) * 8) / 8).astype(np.float32)
    return X, yb, yr


# ---- binning ----

@pytest.mark.parametrize("use_missing", [True, False])
@pytest.mark.parametrize("max_bin", [7, 63])
def test_categorical_mappers_and_bins_match_reference(max_bin, use_missing):
    # exact: the count-ordered category bins (ties by ascending category),
    # the cap of max_bin - 1 categories, the rare-tail cut, the missing
    # type, the feature info of the model text, and the bins of NaN,
    # negative, unseen and non-integer values (numpy and torch encodes)
    X, _, _ = _cat_data()
    kw = dict(max_bin=max_bin, min_data_in_bin=3, categorical=CATS,
              use_missing=use_missing)
    ref = ref_binning.find_bin_mappers(X, **kw)
    port = t_binning.find_bin_mappers(X, **kw)
    probe = np.concatenate([[np.nan, -1.0, -0.5, -0.0, 0.0, 0.4, 2.7, 11.0,
                             12.0, 149.0, 150.0, 1e9], X[:300, 1]])
    for j, (a, b) in enumerate(zip(ref, port)):
        for name in ("bin_type", "num_bins", "missing_type", "is_trivial",
                     "na_bin", "default_bin"):
            assert getattr(b, name) == getattr(a, name), (j, name)
        np.testing.assert_array_equal(b.cat_values, a.cat_values)
        assert b.to_feature_info() == a.to_feature_info()
        if j in CATS:
            want = a.values_to_bins(probe)
            np.testing.assert_array_equal(b.values_to_bins(probe), want)
            got = b.values_to_bins_torch(torch.tensor(probe,
                                                      dtype=torch.float64))
            np.testing.assert_array_equal(got.numpy(), want)
            for bb in range(b.num_bins + 1):
                assert b.bin_to_value(bb) == a.bin_to_value(bb)
    # the station code has more categories than max_bin - 1 keeps
    assert len(port[1].cat_values) == max_bin - 1


@pytest.mark.parametrize("distinct,counts,max_bin,want", [
    # equal counts keep ascending category order (and the last, under
    # min_data_in_bin past 99% of the rows, is cut)
    ([1, 3, 5, 9, 12], [4, 4, 2, 4, 2], 8, [1, 3, 9, 5]),
    ([1, 3, 5, 9, 12], [4, 4, 3, 4, 3], 8, [1, 3, 9, 5, 12]),
    # the rare tail past 99% of the rows (under min_data_in_bin each) goes
    # to bin 0
    (list(range(15)), [500] * 10 + [1] * 5, 63, list(range(10))),
    # the cap of max_bin - 1 categories
    (list(range(15)), list(range(15, 0, -1)), 5, [0, 1, 2, 3]),
    # one category: a trivial mapper
    ([7], [40], 63, [7]),
])
def test_categorical_mapper_from_counts(distinct, counts, max_bin, want):
    # exact against the reference's weighted mapper
    kw = dict(max_bin=max_bin, min_data_in_bin=3, use_missing=True)
    a = ref_binning.BinMapper._categorical_from_weighted(
        np.array(distinct), np.array(counts), **kw)
    b = t_binning.BinMapper._categorical_from_weighted(
        np.array(distinct), np.array(counts), **kw)
    np.testing.assert_array_equal(b.cat_values, a.cat_values)
    np.testing.assert_array_equal(b.cat_values, want)
    assert (b.num_bins, b.is_trivial) == (a.num_bins, a.is_trivial)


def test_dataset_bins_and_valid_rebinning_match_reference():
    # exact: the train Dataset's bins and a valid set binned with its
    # mappers (unseen categories, negatives and NaN into bin 0)
    X, yb, _ = _cat_data()
    Xv, yv, _ = _cat_data(600, seed=1, valid=True)
    p = dict(BASE, objective="binary")
    ref = lgb.Dataset(X, label=yb, categorical_feature=CATS, params=p)
    ref_v = lgb.Dataset(Xv, label=yv, reference=ref).construct()
    port = lt.Dataset(X, label=yb, categorical_feature=CATS,
                      params=dict(p, **CPU))
    port_v = lt.Dataset(Xv, label=yv, reference=port,
                        params=CPU).construct()
    assert ref.construct().bundle_meta is None
    np.testing.assert_array_equal(port.bins.numpy(), np.asarray(ref.bins))
    np.testing.assert_array_equal(port_v.bins.numpy(),
                                  np.asarray(ref_v.bins))
    np.testing.assert_array_equal(port.na_bin_dev.numpy(),
                                  np.asarray(ref.na_bin_dev))
    assert (port_v.bins[Xv[:, 1] == 500.0, 1] == 0).all()
    assert port.has_categorical


# ---- the split search ----

def _hists(seed, L=6, F=5, B=64, nb=(3, 40, 64, 9, 30)):
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 40, size=(L, F, B)).astype(np.float32)
    nb = np.asarray(nb, np.int32)
    for j in range(F):
        cnt[:, j, nb[j]:] = 0
    g = np.round(rng.normal(size=(L, F, B)) * cnt * 8) / 8
    g = g.astype(np.float32)
    g[0, 1, 5] = -0.0
    g[1, F - 1, 7] = -0.0
    h = (cnt * 0.25).astype(np.float32)
    hist = np.stack([g, h, cnt], 1)
    na = np.array([B, 0, 0, B, nb[-1] - 1][:F], np.int32)
    return hist, nb, na


SPLIT_CASES = {
    "onehot4": dict(cat_features=(0, 1, 3)),
    "onehot8": dict(cat_features=(1, 2, 3), max_cat_to_onehot=8),
    "max_cat_threshold": dict(cat_features=(1, 2), max_cat_threshold=2,
                              cat_smooth=1.0),
    "cat_smooth": dict(cat_features=(1, 2, 4), cat_smooth=25.0,
                       cat_l2=1.0),
    "all_cat_no_smooth": dict(cat_features=(0, 1, 2, 3, 4),
                              min_data_per_group=10, cat_smooth=0.0),
    "l1_l2": dict(cat_features=(1, 2), lambda_l1=2.0, lambda_l2=1.0,
                  max_delta_step=3.0, min_data_per_group=50),
}


def _split_both(hist, nb, na, sp, fm=None, allow=None):
    L, _, f, _ = hist.shape
    pg, ph_, pc = (hist[:, k, 0].sum(-1) for k in range(3))
    fm = np.ones(f, bool) if fm is None else fm
    allow = np.ones(L, bool) if allow is None else allow
    ref = ref_split.best_split(
        jnp.asarray(hist), jnp.asarray(nb), jnp.asarray(na), jnp.asarray(pg),
        jnp.asarray(ph_), jnp.asarray(pc), jnp.asarray(fm),
        ref_split.SplitParams(min_data_in_leaf=3, **sp), jnp.asarray(allow))
    port = t_split.best_split(
        _t(hist), _t(nb), _t(na), _t(pg), _t(ph_), _t(pc), _t(fm),
        t_split.SplitParams(min_data_in_leaf=3, **sp), _t(allow))
    return ref, port


def _assert_records_equal(ref, port):
    for name in ref._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(port, name).numpy()
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.signbit(b), np.signbit(a),
                                          err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_best_split_categorical_planes_exact(case, seed):
    # exact, bit for bit on every field (signs of zero included): the
    # one-hot, ascending and descending subset planes and their decode
    hist, nb, na = _hists(seed)
    ref, port = _split_both(hist, nb, na, SPLIT_CASES[case])
    _assert_records_equal(ref, port)


def test_best_split_categorical_per_leaf_mask_and_allow_exact():
    # exact: a per-leaf feature mask (feature_fraction_bynode) and leaves
    # that may not split
    hist, nb, na = _hists(3)
    rng = np.random.default_rng(3)
    fm = rng.random((hist.shape[0], hist.shape[2])) < 0.6
    allow = np.array([True, True, False, True, True, False])
    ref, port = _split_both(hist, nb, na, SPLIT_CASES["onehot4"], fm, allow)
    _assert_records_equal(ref, port)
    assert np.asarray(ref.is_cat).any()


@pytest.mark.parametrize("masked", [False, True])
def test_best_split_numerical_categorical_tie(masked):
    # exact: a numerical and a categorical (one-hot) candidate with the
    # same stats tie, and the lower flat index (the numerical plane) wins;
    # with the numerical feature masked the categorical one wins
    hist, nb, na = _hists(5, L=2, F=2, B=64, nb=(2, 3))
    hist[:, :, 1] = 0.0
    hist[:, :, 1, 1] = hist[:, :, 0, 0]
    hist[:, :, 1, 2] = hist[:, :, 0, 1]
    na = np.array([64, 64], np.int32)
    fm = np.array([not masked, True])
    ref, port = _split_both(hist, nb, na, dict(cat_features=(1,)), fm)
    _assert_records_equal(ref, port)
    assert np.asarray(ref.is_cat).tolist() == [masked, masked]


# ---- the two kernels' membership: route_level and hist_routed_fused ----

NK, FK, BK, LK, SK = 900, 5, 64, 8, 3


def _route_case(seed=7):
    """Leaves 0..5 split: 0 and 3 numerically (3 on a feature with a NaN
    bin), 1, 2, 4 and 5 by membership (2 with bin 0 a member while its
    feature's missing bin is 0 and dleft says right; 4 on bins past 32; 5
    with no member, every row right); 6 and 7 do not split."""
    rng = np.random.default_rng(seed)
    nb = np.array([40, 64, 12, 30, 64], np.int32)
    bins = np.stack([rng.integers(0, k, NK) for k in nb], 1).astype(np.uint8)
    lid = rng.integers(0, LK, NK).astype(np.int32)
    feat = np.array([0, 1, 2, 3, 4, 1, -1, -1], np.int32)
    thr = np.array([17, 3, 0, 11, 5, 0, 0, 0], np.int32)
    dleft = np.array([1, 0, 0, 1, 0, 0, 0, 0], np.int32)
    new_leaf = np.arange(LK, 2 * LK, dtype=np.int32)
    slot_left = np.array([0, SK, 1, SK, 2, SK, SK, SK], np.int32)
    slot_right = np.array([SK, 0, SK, 1, SK, 2, SK, SK], np.int32)
    is_cat = np.array([0, 1, 1, 0, 1, 1, 0, 0], np.int32)
    member = np.zeros((LK, BK), bool)
    member[1, rng.choice(np.arange(1, 64), 20, replace=False)] = True
    member[2, [0, 3, 7]] = True
    member[4, [33, 40, 63, 31, 32]] = True
    na_bin = np.array([BK, 0, 0, 29, BK], np.int32)
    cols = (feat, thr, dleft, new_leaf, slot_left, slot_right)
    return bins, lid, cols, is_cat, member, na_bin


def test_member_bitset_layout():
    # exact: bit b of word b // 32, bit 31 as the sign bit of an int32
    rng = np.random.default_rng(1)
    member = rng.random((6, 70)) < 0.4
    member[0, 31] = True
    bits = hk.member_bitset(_t(member))
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (6, 3)
    words = bits.numpy().view(np.uint32).astype(np.int64)
    got = (words[:, np.arange(96) // 32] >> (np.arange(96) % 32)) & 1
    np.testing.assert_array_equal(got[:, :70].astype(bool), member)
    assert not got[:, 70:].any()


def test_route_level_with_membership_exact():
    # exact: per-row slot and new leaf id against route_level_pallas with
    # is_cat and member set, and the per-slot counts of its slots
    bins, lid, cols, is_cat, member, na_bin = _route_case()
    ref_slot, ref_lid = ph.route_level_pallas(
        jnp.asarray(bins.T), jnp.asarray(lid),
        ref_hist.RouteTables(*[jnp.asarray(c) for c in cols],
                             is_cat=jnp.asarray(is_cat),
                             member=jnp.asarray(member, jnp.float32)),
        jnp.asarray(na_bin), SK, LK, interpret=True)
    tabs = th.RouteTables(*[_t(c) for c in cols], is_cat=_t(is_cat),
                          member=_t(member))
    slot, lid2, counts = hk.route_level(_t(bins.T), _t(lid), tabs.stacked(),
                                        _t(na_bin), SK, tabs.bitset())
    np.testing.assert_array_equal(slot.numpy(), np.asarray(ref_slot))
    np.testing.assert_array_equal(lid2.numpy(), np.asarray(ref_lid))
    rs = np.asarray(ref_slot)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(rs[rs < SK], minlength=SK))
    # leaf 2: bin 0 is a member, so its missing rows go left
    in2 = (lid == 2) & (bins[:, 2] == 0)
    assert in2.any() and (lid2.numpy()[in2] == 2).all()
    # leaf 5: no member, every row right
    assert (lid2.numpy()[lid == 5] == 5 + LK).all()


@pytest.mark.parametrize("const_hess", [False, True])
def test_hist_routed_fused_with_membership_exact(const_hess):
    # exact: the fused level pass's dequantized slot histogram and new
    # leaf ids with categorical leaves, 3 channels and 2 (const-hessian),
    # against hist_routed_fused_q8 in interpret mode
    bins, lid, cols, is_cat, member, na_bin = _route_case(11)
    rng = np.random.default_rng(2)
    gq = rng.integers(-127, 128, NK).astype(np.int8)
    hq = rng.integers(0, 128, NK).astype(np.int8)
    cq = (rng.random(NK) < 0.9).astype(np.int8)
    scale_g, scale_h = np.float32(3.5), np.float32(0.75)
    ref_h, ref_lid = ph.hist_routed_fused_q8(
        jnp.asarray(bins.T), jnp.asarray(gq),
        jnp.asarray(cq if const_hess else hq), jnp.asarray(cq),
        jnp.asarray(lid),
        ref_hist.RouteTables(*[jnp.asarray(c) for c in cols],
                             is_cat=jnp.asarray(is_cat),
                             member=jnp.asarray(member, jnp.float32)),
        jnp.asarray(na_bin), SK, BK, scale_g, scale_h, LK,
        const_hess=const_hess, interpret=True)
    quant = th.QuantChannels(_t(gq), None if const_hess else _t(hq), _t(cq),
                             torch.tensor(scale_g), torch.tensor(scale_h))
    tabs = th.RouteTables(*[_t(c) for c in cols], is_cat=_t(is_cat),
                          member=_t(member))
    hist, lid2 = th.hist_routed(_t(bins.T), _t(lid), tabs, _t(na_bin), SK,
                                BK, quant, bins=_t(bins))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(lid2.numpy(), np.asarray(ref_lid))


def test_route_wrappers_check_the_categorical_tables():
    bins, lid, cols, is_cat, member, na_bin = _route_case()
    tabs = th.RouteTables(*[_t(c) for c in cols], is_cat=_t(is_cat),
                          member=_t(member))
    six = th.RouteTables(*[_t(c) for c in cols]).stacked()
    assert tuple(six.shape) == (6, LK)
    assert tuple(tabs.stacked().shape) == (7, LK)
    with pytest.raises(ValueError, match="tables"):
        hk.route_level(_t(bins.T), _t(lid), six, _t(na_bin), SK,
                       tabs.bitset())
    with pytest.raises(TypeError, match="catbits"):
        hk.route_level(_t(bins.T), _t(lid), tabs.stacked(), _t(na_bin), SK,
                       tabs.bitset().to(torch.int64))
    with pytest.raises(ValueError, match="catbits"):
        hk.route_level(_t(bins.T), _t(lid), tabs.stacked(), _t(na_bin), SK,
                       tabs.bitset()[:3].contiguous())


# ---- whole models ----

MODEL_CASES = {
    "binary_fused": dict(objective="binary", use_quantized_grad="true"),
    "l2_fused": dict(objective="regression", use_quantized_grad="true"),
    "l2_f32": dict(objective="regression", use_quantized_grad="false"),
    "l2_lossguide": dict(objective="regression", grow_policy="lossguide"),
}


@pytest.fixture(scope="module")
def cat_models():
    X, yb, yr = _cat_data()
    Xv, ybv, yrv = _cat_data(600, seed=1, valid=True)
    out = {}
    for case, extra in MODEL_CASES.items():
        p = dict(BASE, **extra)
        binary = extra["objective"] == "binary"
        y, yv = (yb, ybv) if binary else (yr, yrv)
        ev_r, ev_p = {}, {}
        ds = lgb.Dataset(X, label=y, categorical_feature=CATS, params=p)
        ref = lgb.train(p, ds, 3, valid_sets=[ds.create_valid(Xv, yv)],
                        evals_result=ev_r, verbose_eval=False)
        pt = dict(p, **CPU)
        tds = lt.Dataset(X, label=y, categorical_feature=CATS, params=pt)
        port = lt.train(pt, tds, 3,
                        valid_sets=[lt.Dataset(Xv, label=yv, reference=tds)],
                        evals_result=ev_p, verbose_eval=False)
        out[case] = (ref, port, ev_r, ev_p)
    return X, Xv, out


def _tree_lines(text, tree):
    block = text.split(f"Tree={tree}\n", 1)[1].split("\n\n", 1)[0]
    return [ln for ln in block.splitlines() if ln.startswith(TEXT_KEYS)]


def _metric(objective, y, raw):
    if objective == "binary":
        prob = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1 - 1e-15)
        return -np.mean(y * np.log(prob) + (1 - y) * np.log(1 - prob))
    return np.mean((raw - y) ** 2)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_categorical_model_matches_reference(cat_models, case):
    # exact: the structure, categories and cat_threshold bitsets of every
    # tree of the L2 models and of the first binary tree (queue C1); leaf
    # values rtol 1e-4 with an absolute 1e-5 of the largest leaf,
    # predictions (with unseen categories and NaN) rtol 1e-4 (queue C2).
    # The valid metric is held against the metric of the reference's own
    # predictions: the reference's valid-set replay routes categorical
    # nodes by threshold (ROADMAP caveats), so its recorded one differs
    X, Xv, out = cat_models
    ref, port, ev_r, ev_p = out[case]
    rt, pt = ref._gbdt.finalize(), port._host_trees()
    assert len(rt) == len(pt) == 3
    exact = 1 if case.startswith("binary") else 3
    rtext, ptext = ref.model_to_string(), port.model_to_string()
    for i in range(exact):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(pt[i], name),
                                          getattr(rt[i], name),
                                          err_msg=f"tree {i} {name}")
        for a, b in zip(rt[i].cat_sets, pt[i].cat_sets):
            np.testing.assert_array_equal(b, a)
        assert _tree_lines(ptext, i) == _tree_lines(rtext, i)
        np.testing.assert_allclose(
            pt[i].leaf_value, rt[i].leaf_value, rtol=1e-4,
            atol=1e-5 * np.abs(rt[i].leaf_value).max())
    assert sum(t.is_cat_node.sum() for t in pt) > 0
    for data in (X, Xv):
        np.testing.assert_allclose(port.predict(data, raw_score=True),
                                   ref.predict(data, raw_score=True),
                                   rtol=1e-4, atol=1e-6)
    objective = MODEL_CASES[case]["objective"]
    yv = _cat_data(600, seed=1, valid=True)[1 if objective == "binary"
                                            else 2]
    (metric, vals), = ev_p["valid_0"].items()
    assert len(vals) == 3
    np.testing.assert_allclose(
        vals[-1], _metric(objective, yv, ref.predict(Xv, raw_score=True)),
        rtol=1e-4)
    np.testing.assert_allclose(
        port._gbdt.valid_scores[0].numpy(),
        port.predict(Xv, raw_score=True), rtol=1e-5, atol=1e-5)


def test_reference_valid_replay_ignores_categorical_nodes(cat_models):
    # a defect of the reference that the port does not mirror: its valid
    # score routes categorical nodes by threshold (gbdt.py
    # _update_valid_scores calls route_bins without is_cat / cat_mask), so
    # it disagrees with its own predictions, where the port's agrees
    X, Xv, out = cat_models
    ref, port, ev_r, ev_p = out["l2_fused"]
    rv = ref.predict(Xv, raw_score=True)
    assert np.abs(np.asarray(ref._gbdt.valid_scores[0]) - rv).max() > 1e-2
    np.testing.assert_allclose(port._gbdt.valid_scores[0].numpy(), rv,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("how", ["names", "params", "params_by_name",
                                 "train"])
def test_categorical_feature_given_by_name_or_params(how):
    # exact: naming the categorical columns (through feature_name), the
    # categorical_feature parameter in LightGBM's forms ("0,1,3",
    # "name:a,b"), or train(categorical_feature=) give the model of the
    # indices, which is held against the reference above
    X, yb, _ = _cat_data()
    p = dict(BASE, objective="binary", **CPU)
    by_index = lt.train(p, lt.Dataset(X, label=yb, feature_name=NAMES,
                                      categorical_feature=CATS, params=p), 2)
    cat_names = [NAMES[j] for j in CATS]
    if how == "names":
        ds = lt.Dataset(X, label=yb, feature_name=NAMES,
                        categorical_feature=cat_names, params=p)
        bst = lt.train(p, ds, 2)
    elif how == "train":
        ds = lt.Dataset(X, label=yb, params=p)
        bst = lt.train(p, ds, 2, feature_name=NAMES,
                       categorical_feature=CATS)
    else:
        value = ("0,1,3" if how == "params"
                 else "name:" + ",".join(cat_names))
        pp = dict(p, categorical_feature=value)
        bst = lt.train(pp, lt.Dataset(X, label=yb, feature_name=NAMES,
                                      params=pp), 2)
    strip = lambda s: [ln for ln in s.splitlines()  # noqa: E731
                       if not ln.startswith(("[categorical_feature",
                                             "parameters", "["))]
    assert strip(bst.model_to_string()) == strip(by_index.model_to_string())


def test_categorical_model_roundtrip_and_raw_predict(cat_models, tmp_path):
    # exact: the model text round-trips (cat_threshold and predictions);
    # predictions from raw values agree with the training scores within
    # f32 rounding
    X, Xv, out = cat_models
    _, port, _, _ = out["l2_fused"]
    path = os.path.join(tmp_path, "m.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    assert loaded.model_to_string() == port.model_to_string()
    np.testing.assert_array_equal(loaded.predict(Xv), port.predict(Xv))
    train_score = port._gbdt.train_score.numpy()
    np.testing.assert_allclose(port.predict(X, raw_score=True), train_score,
                               rtol=1e-5, atol=1e-5)


def test_continued_categorical_model_replays_its_trees():
    # within f32 rounding: a valid set's score after continuing a
    # categorical model (its trees put into bin space by bin_tree) is the
    # init model's prediction plus the new trees'
    X, yb, _ = _cat_data()
    Xv, ybv, _ = _cat_data(600, seed=1, valid=True)
    p = dict(BASE, objective="binary", **CPU)
    init = lt.train(p, lt.Dataset(X, label=yb, categorical_feature=CATS,
                                  params=p), 2)
    tds = lt.Dataset(X, label=yb, categorical_feature=CATS, params=p)
    vds = lt.Dataset(Xv, label=ybv, reference=tds)
    more = lt.train(p, tds, 1, valid_sets=[vds], init_model=init,
                    verbose_eval=False)
    want = init.predict(Xv, raw_score=True) + more.predict(Xv,
                                                          raw_score=True)
    np.testing.assert_allclose(more._gbdt.valid_scores[0].numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_categorical_path_calls_its_kernels_with_bitsets(monkeypatch):
    # the fused path with categorical splits calls the fused kernels only,
    # and hands hist_routed_fused a bitset on the levels with a
    # categorical split; the unquantized path likewise route_level
    seen = {"hist_routed_fused": [], "route_level": []}
    for name in seen:
        fn = getattr(hk, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            bits = kw.get("catbits", args[-1] if len(args) > 5 else None)
            seen[_name].append(isinstance(bits, torch.Tensor))
            return _fn(*args, **kw)
        monkeypatch.setattr(hk, name, spy)
    X, yb, _ = _cat_data()
    for extra in ({}, {"use_quantized_grad": "false"}):
        p = dict(BASE, objective="binary", **extra, **CPU)
        lt.train(p, lt.Dataset(X, label=yb, categorical_feature=CATS,
                               params=p), 1)
    assert any(seen["hist_routed_fused"]) and any(seen["route_level"])


def test_dominant_categorical_column_trains_unbundled_as_reference():
    # the EFB replay skips categorical columns as the reference's plan
    # does: a dominant categorical column with use_missing=false (a
    # MISSING_NONE mapper) beside a sparse numeric column that is nonzero
    # only where it is 0 would be a bundle if it were a candidate; the
    # reference trains it unbundled and so does the port (first tree
    # exact, queue C1)
    rng = np.random.RandomState(4)
    n = 3000
    X = np.zeros((n, 4), np.float32)
    hot = rng.rand(n) < 0.06
    X[hot, 0] = rng.randint(1, 6, hot.sum())
    sparse = ~hot & (rng.rand(n) < 0.05)
    X[sparse, 1] = rng.rand(sparse.sum()) + 0.5
    X[:, 2] = rng.rand(n)
    X[:, 3] = rng.rand(n)
    y = ((X[:, 0] % 2 == 1) | (X[:, 2] > 0.7)).astype(np.float32)
    p = dict(BASE, objective="binary", use_missing=False,
             use_quantized_grad="true")
    ds = lgb.Dataset(X, label=y, categorical_feature=[0], params=p)
    ref = lgb.train(p, ds, 1)
    assert ds.bundle_meta is None
    pt = dict(p, **CPU)
    port = lt.train(pt, lt.Dataset(X, label=y, categorical_feature=[0],
                                   params=pt), 1)
    rt, ptr = ref._gbdt.finalize(), port._host_trees()
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(ptr[0], name),
                                      getattr(rt[0], name), err_msg=name)
    assert ptr[0].is_cat_node.any()
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)


def test_reference_categorical_model_and_mappers_convert(cat_models):
    # convert.py carries categorical models and mappers across: the
    # reference's model text predicts the same in the port (rtol 1e-6:
    # the reference sums leaf values in f32, the port in f64), and its
    # categorical mappers become the port's own, field for field
    import dataclasses
    from lightgbm_tpu_torch.convert import (booster_from_model_text,
                                            mappers_from_reference)
    X, Xv, out = cat_models
    ref, port, _, _ = out["binary_fused"]
    conv = booster_from_model_text(ref.model_to_string(), params=CPU)
    for data in (X, Xv):
        np.testing.assert_allclose(conv.predict(data, raw_score=True),
                                   ref.predict(data, raw_score=True),
                                   rtol=1e-6, atol=1e-7)
    ref_ds = ref._gbdt.train_set
    got = mappers_from_reference([dataclasses.asdict(m)
                                  for m in ref_ds.mappers])
    for a, b in zip(got, port.train_set.mappers):
        assert (a.bin_type, a.num_bins, a.missing_type) == \
            (b.bin_type, b.num_bins, b.missing_type)
        np.testing.assert_array_equal(a.cat_values, b.cat_values)
