"""Exclusive Feature Bundling, scipy-sparse and pandas input in the
PyTorch/CUDA port (lightgbm_tpu_torch), held against the JAX reference
(lightgbm_tpu) on the CPU.

The reference runs its Pallas kernels in interpret mode
(histogram_impl=pallas); the port runs each kernel wrapper on CPU tensors,
i.e. through the kernel's plain PyTorch version. Inputs are made from a
seed with numpy and handed to both as the same arrays.

Tolerances (each stated where it is asserted):
- exact: every field of the bundle plan (one-hot blocks, exclusive sparse
  columns, max_conflict_rate > 0, a bundle that overflows 255 bins, a
  default bin that is not the zero bin, default bin == bins - 1, fewer
  than 3 columns, a sampled plan), the bundled bins of dense, CSR and CSC
  input and of valid sets built with ``reference=``, the sparse mappers
  and bins, every field of ``best_split``'s record with bundle columns
  (the range-end "t == default" candidate, the empty prefix at default 0,
  default == bins - 1, a tie with a numerical candidate, beside
  categorical columns), the structure and model text of the first binary
  tree (queue C1) and of every tree of L2 models on exact-sum labels;
- leaf values and predictions rtol 1e-4 (queue C2);
- the replays of a tree on a Dataset's bins (valid sets, DART's drops,
  init models) against the reference's predictions rtol 1e-4, or against
  the port's own predictions within f32 rounding (1e-5): the reference
  replays bundle nodes by threshold (ROADMAP caveats), which these tests
  show.

The card-side checks (route_level with bundle bitsets, hist_q8 fed its
counts, bundled models card against CPU) are in tests/test_torch_cuda.py.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu import binning as ref_binning
from lightgbm_tpu import efb as ref_efb
from lightgbm_tpu import engine as ref_engine
from lightgbm_tpu.ops import split as ref_split
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import binning as t_binning
from lightgbm_tpu_torch import efb as t_efb
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.models.gbdt import padded_bins
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops import split as t_split
from lightgbm_tpu_torch.ops.histogram import ACC_ROWS_MAX

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 5,
        "verbosity": -1, "prewarm": 0, "histogram_impl": "pallas"}
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child", "is_cat_node")
TEXT_KEYS = ("split_feature=", "threshold=", "decision_type=",
             "left_child=", "right_child=", "num_cat=")
META_ARRAYS = ("default_bin", "pos_feat", "pos_bin", "range_start",
               "range_end", "prefix_end", "incl_default", "valid",
               "is_bundle", "num_bins")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _efb_data(n=3000, seed=0, blocks=(12, 8, 6), n_num=3, levels=1,
              valid=False):
    """Numeric columns first (n_num, uniform; the second with NaN), then
    one block a group of mutually exclusive sparse columns: each row holds
    one non-zero in each block, in the column of its code, drawn from
    ``levels`` values (1: one-hot). A valid set (valid=True) leaves about
    3% of a block's rows all zero (an unseen code). The label follows
    random per-code effects and the first numeric column; L2 labels lie on
    a 1/8 grid, so their sums are exact in any order."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, n_num + sum(blocks)), np.float32)
    X[:, :n_num] = rng.rand(n, n_num)
    if n_num > 1:
        X[rng.rand(n) < 0.05, 1] = np.nan
    eff = np.random.RandomState(99)
    lat = X[:, 0] * 1.5
    off = n_num
    for k in blocks:
        code = rng.randint(0, k, n)
        val = rng.randint(1, levels + 1, n).astype(np.float32)
        rows = np.arange(n)
        if valid:
            keep = rng.rand(n) >= 0.03
            rows, code, val = rows[keep], code[keep], val[keep]
        X[rows, off + code] = val
        e = eff.normal(size=(k, levels + 1))
        lat[rows] += e[code, val.astype(int)]
        off += k
    lat = lat + 0.3 * rng.randn(n)
    yb = (lat > np.median(lat)).astype(np.float32)
    yr = (np.round(np.clip(lat, -4, 4) * 8) / 8).astype(np.float32)
    return X, yb, yr


def _default_not_zero(n=2000, seed=3):
    """Sparse columns whose most frequent value is not zero: column 0 is
    5.0 but on the rows of set A (0.0 or 1.0 there), column 1 is 9.0 (its
    largest value, so its default bin is its last) but on set B (1.0 to
    8.0), and columns 2-5 are one-hot codes on the remaining rows; A, B
    and the codes are disjoint, so all six bundle."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 6), np.float32)
    part = rng.randint(0, 6, n)
    X[:, 0] = np.where(part == 0, rng.randint(0, 2, n), 5.0)
    X[:, 1] = np.where(part == 1, rng.randint(1, 9, n), 9.0)
    for j in range(2, 6):
        X[part == j, j] = 1.0
    y = (part + rng.rand(n) > 2.5).astype(np.float32)
    return X, y


PLAN_CASES = {
    "onehot": (lambda: _efb_data()[0], {}),
    "exclusive": (lambda: _efb_data(blocks=(14,), levels=10)[0], {}),
    "conflict": (lambda: _efb_data(blocks=(12, 8))[0],
                 {"max_conflict_rate": 0.05}),
    "overflow": (lambda: _efb_data(n=6000, blocks=(30,), levels=10)[0], {}),
    "default_not_zero": (lambda: _default_not_zero()[0], {}),
    "two_columns": (lambda: _efb_data(blocks=(2,), n_num=0)[0], {}),
}


def _meta_equal(port, ref):
    assert (port is None) == (ref is None)
    if ref is None:
        return
    assert port.members == [[tuple(int(v) for v in m) for m in col]
                            for col in ref.members]
    for name in META_ARRAYS:
        a, b = getattr(ref, name), getattr(port, name)
        np.testing.assert_array_equal(b, np.asarray(a).astype(b.dtype),
                                      err_msg=name)


def _datasets(X, y, params, kind="dense", **kw):
    """The reference's and the port's constructed Datasets of X as
    ``kind`` (dense, csr or csc) input."""
    data = {"dense": X, "csr": sps.csr_matrix(X),
            "csc": sps.csc_matrix(X)}[kind]
    ref = lgb.Dataset(data, label=y, params=params, **kw).construct()
    port = lt.Dataset(data, label=y, params=dict(params, **CPU),
                      **kw).construct()
    return ref, port


# ---- the plan ----

@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_reference(case):
    # exact: every BundleMeta field of the plan the two Datasets make
    # (members, default bins and the per-position arrays), and the plan
    # itself on the same bins with a 1000-row sample (the RandomState draw)
    make, extra = PLAN_CASES[case]
    X = make()
    y = np.zeros(len(X), np.float32)
    p = dict(BASE, **extra)
    ref, port = _datasets(X, y, p)
    _meta_equal(port.bundle_meta, ref.bundle_meta)
    if case == "two_columns":
        assert port.bundle_meta is None
        return
    meta = port.bundle_meta
    assert meta is not None and meta.is_bundle.any()
    if case == "overflow":
        assert meta.is_bundle.sum() >= 2
        assert (meta.num_bins[meta.is_bundle] <= 255).all()
    if case == "default_not_zero":
        zero_bins = [m.values_to_bins(np.zeros(1))[0] for m in port.mappers]
        assert (meta.default_bin[:2] != np.asarray(zero_bins[:2])).all()
        assert meta.default_bin[1] == port.mappers[1].num_bins - 1
    rb = ref_binning.bin_data(X, ref_binning.find_bin_mappers(X, 63))
    mappers = t_binning.find_bin_mappers(X, 63)
    used = t_binning.used_features(mappers)
    assert used == list(rb.feature_map)
    kw = dict(max_conflict_rate=extra.get("max_conflict_rate", 0.0),
              sample_cnt=1000, seed=7)
    _meta_equal(t_efb.plan_bundles(rb.bins, [mappers[j] for j in used],
                                   **kw),
                ref_efb.plan_bundles(rb.bins, rb.mappers, **kw))


def test_identity_and_merged_meta_match_reference():
    # exact: identity_meta and merge_bundle_meta field for field
    X = _efb_data()[0]
    ref, port = _datasets(X, np.zeros(len(X), np.float32), BASE)
    t_id = t_efb.identity_meta(port.mappers)
    r_id = ref_efb.identity_meta(ref.mappers)
    _meta_equal(t_id, r_id)
    n_used = len(port.mappers)
    _meta_equal(t_efb.merge_bundle_meta(port.bundle_meta, t_id, n_used),
                ref_efb.merge_bundle_meta(ref.bundle_meta, r_id, n_used))


# ---- encoding ----

@pytest.mark.parametrize("kind", ["dense", "csr", "csc"])
@pytest.mark.parametrize("case", ["onehot", "exclusive", "default_not_zero"])
def test_bundled_bins_match_reference(case, kind):
    # exact: the bundled uint8 bins (dense: bins on the device, then the
    # bundle step; sparse: each CSC column straight into its bundle
    # column), the columns' bins and missing bins, and a valid set's bins
    # through reference= (with unseen codes for the one-hot data)
    X = PLAN_CASES[case][0]()
    y = np.zeros(len(X), np.float32)
    ref, port = _datasets(X, y, BASE, kind)
    assert port.bundle_meta is not None
    np.testing.assert_array_equal(port.bins.numpy(), np.asarray(ref.bins))
    np.testing.assert_array_equal(port.num_bins_dev.numpy(),
                                  np.asarray(ref.num_bins_dev))
    np.testing.assert_array_equal(port.na_bin_dev.numpy(),
                                  np.asarray(ref.na_bin_dev))
    assert port.max_num_bins == ref.max_num_bins
    Xv = _efb_data(800, seed=1, valid=True)[0] if case == "onehot" else X
    vdata = {"dense": Xv, "csr": sps.csr_matrix(Xv),
             "csc": sps.csc_matrix(Xv)}[kind]
    rv = lgb.Dataset(vdata, reference=ref).construct()
    pv = lt.Dataset(vdata, reference=port, params=CPU).construct()
    np.testing.assert_array_equal(pv.bins.numpy(), np.asarray(rv.bins))


def test_sparse_encoder_equals_bundling_the_sparse_bins():
    # exact: efb.encode_sparse (each CSC column into its bundle column)
    # equals apply_bundles of bin_data_sparse, and the reference's
    # apply_bundles of its bin_data_sparse, with members whose bin of 0.0
    # is not their default
    X, _ = _default_not_zero()
    csc = sps.csc_matrix(X)
    port = lt.Dataset(csc, params=dict(BASE, **CPU)).construct()
    meta, mappers, fm = port.bundle_meta, port.mappers, port.feature_map
    dev = torch.device("cpu")
    direct = t_efb.encode_sparse(csc, mappers, fm, meta, dev)
    via = t_efb.apply_bundles(
        t_binning.bin_data_sparse(csc, mappers, fm, dev), meta)
    ref_meta = lgb.Dataset(csc, params=BASE).construct().bundle_meta
    ref = ref_efb.apply_bundles(ref_binning.bin_data_sparse(
        csc, ref_binning.find_bin_mappers_sparse(csc, 63)).bins, ref_meta)
    np.testing.assert_array_equal(direct.numpy(), via.numpy())
    np.testing.assert_array_equal(direct.numpy(), ref)


@pytest.mark.parametrize("sample_cnt", [200000, 500])
def test_sparse_mappers_and_bins_match_reference(sample_cnt):
    # exact: find_bin_mappers_sparse (only stored values sampled, the rest
    # as implicit zeros; sampled rows at sample_cnt=500) and
    # bin_data_sparse, with stored NaN, stored zeros, negative values, a
    # categorical column and a column that is all zero (trivial)
    rng = np.random.RandomState(4)
    n = 1500
    X = np.zeros((n, 6), np.float64)
    for j in range(4):
        rows = rng.rand(n) < 0.3
        X[rows, j] = rng.randn(rows.sum()) * (j + 1)
    X[rng.rand(n) < 0.05, 1] = np.nan
    X[:, 4] = np.where(rng.rand(n) < 0.4, rng.randint(1, 7, n), 0)
    csc = sps.csc_matrix(X)
    csc.data[::17] = 0.0          # explicit stored zeros
    kw = dict(max_bin=31, sample_cnt=sample_cnt, categorical=[4], seed=2)
    ref_m = ref_binning.find_bin_mappers_sparse(csc, **kw)
    port_m = t_binning.find_bin_mappers_sparse(csc, **kw)
    assert len(ref_m) == len(port_m) == 6
    for a, b in zip(ref_m, port_m):
        assert (a.num_bins, a.missing_type, a.default_bin, a.is_trivial,
                a.bin_type) == (b.num_bins, b.missing_type, b.default_bin,
                                b.is_trivial, b.bin_type)
        assert a.to_feature_info() == b.to_feature_info()
        np.testing.assert_array_equal(b.upper_bounds, a.upper_bounds)
        np.testing.assert_array_equal(b.cat_values, a.cat_values)
    assert port_m[5].is_trivial
    ref_b = ref_binning.bin_data_sparse(csc, ref_m)
    used = t_binning.used_features(port_m)
    assert used == list(ref_b.feature_map)
    port_b = t_binning.bin_data_sparse(csc, [port_m[j] for j in used], used,
                                       torch.device("cpu"))
    np.testing.assert_array_equal(port_b.numpy(), ref_b.bins)


# ---- the split search ----

# the test columns: 0 numerical (10 bins), 1 a bundle of three features
# (offsets 1, 3, 6; default bins 0, 1 and 2 = bins - 1), 2 categorical
# (6 bins), 3 a bundle of two (default bins 0 and 1 = bins - 1)
SPLIT_COLUMNS = [[(0, 0, 10)], [(1, 1, 3), (2, 3, 4), (3, 6, 3)],
                 [(4, 0, 6)], [(5, 1, 5), (6, 5, 2)]]
SPLIT_DEFAULTS = np.array([0, 0, 1, 2, 0, 0, 1], np.int32)
# the rows of each target go left of the split under test: (column,
# position, the bundle bins that go left)
SPLIT_TARGETS = {
    "prefix": (1, 3, {3}),
    "t_default_end": (1, 5, {0, 1, 2, 3, 6, 7}),
    "empty_prefix": (1, 2, {0, 3, 4, 5, 6, 7}),
    "default_last": (1, 7, {6, 7}),
    "second_bundle": (3, 2, {0, 1, 2, 5}),
    "two_bins_default_last": (3, 5, {5}),
}


def _bundle_hists(target, seed, L=4, n=4000, tie=False):
    """[L, 3, 4, 16] histograms of rows binned into SPLIT_COLUMNS whose
    gradient is -1 left of the target split and +1 right of it (plus
    noise on a 1/8 grid, h = 0.25: every sum exact); with ``tie`` the
    numerical column 0 holds the target's partition (bin 0 left), so its
    threshold 0 ties with the bundle candidate."""
    rng = np.random.default_rng(seed)
    nb = np.array([10, 8, 6, 6], np.int32)
    bins = np.stack([rng.integers(0, b, n) for b in nb], 1)
    col, _, left = SPLIT_TARGETS[target]
    is_left = np.isin(bins[:, col], sorted(left))
    if tie:
        bins[:, 0] = np.where(is_left, 0, 1 + rng.integers(0, 9, n))
    g = (np.where(is_left, -1.0, 1.0)
         + np.round(rng.normal(size=n) * 4) / 8).astype(np.float32)
    leaf = rng.integers(0, L, n)
    hist = np.zeros((L, 3, 4, 16), np.float32)
    for j in range(4):
        for ch, v in enumerate((g, np.full(n, 0.25, np.float32),
                                np.ones(n, np.float32))):
            np.add.at(hist[:, ch, j], (leaf, bins[:, j]), v)
    return hist, nb


def _bundle_arrays(B=16):
    meta = t_efb._columns_meta(SPLIT_COLUMNS, SPLIT_DEFAULTS)
    fields = {k: getattr(meta, k)[:, :B] for k in (
        "range_start", "range_end", "prefix_end", "incl_default", "valid")}
    fields["range_end"] = np.minimum(fields["range_end"], B - 1)
    fields["prefix_end"] = np.minimum(fields["prefix_end"], B - 1)
    fields["is_bundle"] = meta.is_bundle
    port = t_split.BundleArrays(**{k: _t(v.astype(np.int64))
                                   if v.dtype.kind == "i" else _t(v)
                                   for k, v in fields.items()})
    ref = ref_split.BundleArrays(**{k: jnp.asarray(v)
                                    for k, v in fields.items()})
    return port, ref


def _split_both(hist, nb, sp, fm=None):
    L = hist.shape[0]
    na = np.array([16, 16, 0, 16], np.int32)
    pg, ph, pc = (hist[:, k, 0].sum(-1) for k in range(3))
    fm = np.ones(4, bool) if fm is None else fm
    allow = np.ones(L, bool)
    tb, rb = _bundle_arrays()
    ref = ref_split.best_split(
        jnp.asarray(hist), jnp.asarray(nb), jnp.asarray(na),
        jnp.asarray(pg), jnp.asarray(ph), jnp.asarray(pc), jnp.asarray(fm),
        ref_split.SplitParams(min_data_in_leaf=3, has_bundles=True, **sp),
        jnp.asarray(allow), bundle=rb)
    port = t_split.best_split(
        _t(hist), _t(nb), _t(na), _t(pg), _t(ph), _t(pc), _t(fm),
        t_split.SplitParams(min_data_in_leaf=3, has_bundles=True, **sp),
        _t(allow), tb)
    return ref, port


def _records_equal(ref, port):
    for name in ref._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(port, name).numpy()
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.signbit(b), np.signbit(a),
                                          err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cat", [False, True])
@pytest.mark.parametrize("target", sorted(SPLIT_TARGETS))
def test_best_split_bundle_plane_exact(target, cat, seed):
    # exact, bit for bit on every field: the bundle plane's candidates
    # (a range prefix; "t == default" at the range end; the empty prefix
    # at default 0; default == bins - 1) win and decode into the bundle
    # column, position and left bins, beside a categorical column's
    # sections (cat=True) that come before the bundle section
    hist, nb = _bundle_hists(target, seed)
    sp = {"cat_features": (2,)} if cat else {}
    ref, port = _split_both(hist, nb, sp)
    _records_equal(ref, port)
    col, pos, left = SPLIT_TARGETS[target]
    assert port.is_cat.all() and not port.default_left.any()
    assert (port.feature == col).all() and (port.bin == pos).all()
    want = np.zeros(16, bool)
    want[sorted(left)] = True
    np.testing.assert_array_equal(port.cat_member.numpy()[:, :nb[col]],
                                  np.broadcast_to(want[:nb[col]],
                                                  (4, nb[col])))


@pytest.mark.parametrize("masked", [False, True])
def test_best_split_bundle_numerical_tie(masked):
    # exact: a numerical candidate with the bundle candidate's partition
    # ties with it; the numerical plane comes first, so it wins, as in the
    # reference; with the numerical column masked the bundle wins
    hist, nb = _bundle_hists("t_default_end", 0, tie=True)
    fm = np.array([not masked, True, True, True])
    ref, port = _split_both(hist, nb, {}, fm)
    _records_equal(ref, port)
    if masked:
        assert port.is_cat.all() and (port.feature == 1).all()
    else:
        assert not port.is_cat.any() and (port.feature == 0).all()


# ---- whole models ----

MODEL_CASES = {
    # F_b * B <= 2048: the fused front with membership in the level pass
    "binary_fused": ({"objective": "binary"}, {}),
    # a bundle of > 128 bins (B = 256) and 9 columns: the unfused front
    "binary_unfused": ({"objective": "binary"},
                       {"blocks": (14,), "levels": 10, "n_num": 8}),
    "l2_fused": ({"objective": "regression"}, {}),
    "l2_unfused": ({"objective": "regression"},
                   {"blocks": (14,), "levels": 10, "n_num": 8}),
    "l2_unquantized": ({"objective": "regression",
                        "use_quantized_grad": "false"}, {}),
    "l2_lossguide": ({"objective": "regression",
                      "grow_policy": "lossguide"}, {}),
}


@pytest.fixture(scope="module")
def efb_models():
    out = {}
    for case, (extra, shape) in MODEL_CASES.items():
        X, yb, yr = _efb_data(**shape)
        Xv, ybv, yrv = _efb_data(800, seed=1, valid=True, **shape)
        binary = extra["objective"] == "binary"
        y, yv = (yb, ybv) if binary else (yr, yrv)
        p = dict(BASE, **extra)
        if extra.get("grow_policy") != "lossguide":
            p["use_quantized_grad"] = extra.get("use_quantized_grad", "true")
        ev_r, ev_p = {}, {}
        ds = lgb.Dataset(X, label=y, params=p)
        ref = lgb.train(p, ds, 3, valid_sets=[ds.create_valid(Xv, yv)],
                        evals_result=ev_r, verbose_eval=False)
        pt = dict(p, **CPU)
        tds = lt.Dataset(sps.csr_matrix(X), label=y, params=pt)
        port = lt.train(pt, tds, 3, valid_sets=[
            lt.Dataset(sps.csr_matrix(Xv), label=yv, reference=tds)],
            evals_result=ev_p, verbose_eval=False)
        out[case] = (X, Xv, yv, ref, port, ev_r, ev_p)
    return out


def _tree_lines(text, tree):
    block = text.split(f"Tree={tree}\n", 1)[1].split("\n\n", 1)[0]
    return [ln for ln in block.splitlines() if ln.startswith(TEXT_KEYS)]


def _metric(objective, y, raw):
    if objective == "binary":
        prob = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1 - 1e-15)
        return -np.mean(y * np.log(prob) + (1 - y) * np.log(1 - prob))
    return np.mean((raw - y) ** 2)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_bundled_model_matches_reference(efb_models, case):
    # exact: the Dataset bundles, the path is the one the case names, and
    # the structure and model text of every tree of the L2 models and of
    # the first binary tree (queue C1), which split on bundle columns;
    # leaf values rtol 1e-4 with an absolute 1e-5 of the largest leaf,
    # predictions of those trees on sparse input rtol 1e-4 (queue C2).
    # The valid metric of those trees
    # is held against the metric of the reference's predictions: the
    # reference's valid-set replay routes bundle nodes by threshold
    # (ROADMAP caveats); the port's valid score equals its predictions
    X, Xv, yv, ref, port, ev_r, ev_p = efb_models[case]
    ts = port.train_set
    assert ts.bundle_meta is not None and ts.routes_by_membership
    gp = port._gbdt.gp
    fused = ts.num_features * padded_bins(ts.max_num_bins) <= ACC_ROWS_MAX
    assert fused == ("unfused" not in case)
    assert (gp.fused_obj is not None) == (fused and gp.quant)
    rt, pt = ref._gbdt.finalize(), port._host_trees()
    assert len(rt) == len(pt) == 3
    exact = 1 if case.startswith("binary") else 3
    rtext, ptext = ref.model_to_string(), port.model_to_string()
    for i in range(exact):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(pt[i], name),
                                          getattr(rt[i], name),
                                          err_msg=f"tree {i} {name}")
        assert _tree_lines(ptext, i) == _tree_lines(rtext, i)
        np.testing.assert_allclose(
            pt[i].leaf_value, rt[i].leaf_value, rtol=1e-4,
            atol=1e-5 * np.abs(rt[i].leaf_value).max())
    # the first tree splits on bundled features (decoded to their own)
    bundled = {int(ts.feature_map[j]) for mem in ts.bundle_meta.members
               if len(mem) > 1 for j, _, _ in mem}
    assert bundled & set(pt[0].split_feature.tolist())
    for data in (X, Xv):
        np.testing.assert_allclose(
            port.predict(sps.csr_matrix(data), raw_score=True,
                         num_iteration=exact),
            ref.predict(data, raw_score=True, num_iteration=exact),
            rtol=1e-4, atol=1e-6)
    objective = "binary" if case.startswith("binary") else "regression"
    (_, vals), = ev_p["valid_0"].items()
    np.testing.assert_allclose(
        vals[exact - 1], _metric(objective, yv, ref.predict(
            Xv, raw_score=True, num_iteration=exact)), rtol=1e-4)
    np.testing.assert_allclose(port._gbdt.valid_scores[0].numpy(),
                               port.predict(Xv, raw_score=True),
                               rtol=1e-5, atol=1e-5)


def test_reference_valid_replay_routes_bundles_by_threshold(efb_models):
    # a defect of the reference that the port does not mirror: its valid
    # score routes bundle nodes by threshold on the bundle position (gbdt.py
    # _update_valid_scores calls route_bins without is_cat / cat_mask), so
    # it disagrees with its own predictions, where the port's agrees
    X, Xv, yv, ref, port, ev_r, ev_p = efb_models["l2_fused"]
    rv = ref.predict(Xv, raw_score=True)
    assert np.abs(np.asarray(ref._gbdt.valid_scores[0]) - rv).max() > 1e-2
    assert abs(ev_r["valid_0"]["l2"][-1] - _metric("regression", yv, rv)) \
        > 1e-4
    np.testing.assert_allclose(port._gbdt.valid_scores[0].numpy(), rv,
                               rtol=1e-4, atol=1e-5)


def test_dense_and_sparse_input_train_the_same_model(efb_models):
    # exact: the model text of a model trained from the dense array equals
    # the one trained from its CSR matrix (the same bins and plan)
    X, Xv, yv, ref, port, ev_r, ev_p = efb_models["l2_unfused"]
    p = dict(BASE, objective="regression", use_quantized_grad="true", **CPU)
    y = port.train_set.get_label()
    dense = lt.train(p, lt.Dataset(X, label=y, params=p), 3)
    assert dense.model_to_string() == port.model_to_string()


def test_bundled_model_roundtrip_names_original_features(efb_models,
                                                         tmp_path):
    # exact: the model text round-trips, names only original features
    # (max_feature_idx the raw width), and predicts as the booster does;
    # raw-value predictions agree with the train score within f32 rounding
    X, Xv, yv, ref, port, ev_r, ev_p = efb_models["l2_fused"]
    path = os.path.join(tmp_path, "m.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    assert loaded.model_to_string() == port.model_to_string()
    assert f"max_feature_idx={X.shape[1] - 1}" in port.model_to_string()
    assert all(t.split_feature.max() < X.shape[1]
               for t in loaded._host_trees())
    np.testing.assert_array_equal(loaded.predict(sps.csr_matrix(Xv)),
                                  port.predict(Xv))
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               port._gbdt.train_score.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_bundled_dart_replays_by_membership():
    # DART drops and re-adds trees through replays on the train bins: the
    # trees before the first drop equal the reference's (structure exact,
    # leaves rtol 1e-4); after it, the port's train score equals its own
    # predictions within f32 rounding, and the reference's, which replays
    # bundle nodes by threshold, does not (ROADMAP caveats)
    X, _, yr = _efb_data()
    p = dict(BASE, objective="regression", boosting="dart",
             use_quantized_grad="true", drop_seed=1, skip_drop=0.0)
    ref = lgb.train(p, lgb.Dataset(X, label=yr, params=p), 3)
    pt = dict(p, **CPU)
    port = lt.train(pt, lt.Dataset(sps.csr_matrix(X), label=yr, params=pt),
                    3)
    rt, ptr = ref._gbdt.finalize(), port._host_trees()
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(ptr[0], name),
                                      getattr(rt[0], name), err_msg=name)
    np.testing.assert_allclose(ptr[0].leaf_value * 1.0,
                               rt[0].leaf_value, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port._gbdt.train_score.numpy(),
                               port.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(np.asarray(ref._gbdt.train_score)
                  - ref.predict(X, raw_score=True)).max() > 1e-2


def test_bundled_init_model_replays_by_membership():
    # an init model on bundled data: the port puts its trees into the
    # bundle columns' bin space (bin_tree), so the continued train score
    # starts at the init model's prediction and a valid set's score is
    # the init model's plus the new trees' (within f32 rounding); the
    # reference's _predict_via_trees indexes the bundle columns by each
    # node's used-feature index, which here lies past the 6 bundle
    # columns, so its warm start raises (ROADMAP caveats)
    X, _, yr = _efb_data()
    Xv, _, yrv = _efb_data(800, seed=1, valid=True)
    p = dict(BASE, objective="regression", use_quantized_grad="true")
    init_r = lgb.train(p, lgb.Dataset(X, label=yr, params=p), 2)
    ref_ds = lgb.Dataset(X, label=yr, params=p).construct()
    assert ref_ds.bundle_meta is not None
    assert ref_ds.num_features < max(
        int(t.split_feature.max()) for t in init_r._ensure_host_trees())
    with pytest.raises(IndexError):
        ref_engine._predict_via_trees(init_r, ref_ds)
    pt = dict(p, **CPU)
    init = lt.train(pt, lt.Dataset(X, label=yr, params=pt), 2)
    booster = lt.Booster(params=pt, train_set=lt.Dataset(
        sps.csr_matrix(X), label=yr, params=pt))
    booster._gbdt.warm_start(init._host_trees())
    np.testing.assert_allclose(booster._gbdt.train_score.numpy(),
                               init.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    tds = lt.Dataset(X, label=yr, params=pt)
    more = lt.train(pt, tds, 1, init_model=init, verbose_eval=False,
                    valid_sets=[lt.Dataset(Xv, label=yrv, reference=tds)])
    np.testing.assert_allclose(
        more._gbdt.valid_scores[0].numpy(),
        init.predict(Xv, raw_score=True) + more.predict(Xv, raw_score=True),
        rtol=1e-5, atol=1e-5)


def test_bundled_path_hands_the_level_pass_bitsets(monkeypatch):
    # the unfused front hands route_level an is_cat row and a bitset
    # exactly on the levels with a bundle split, a level whose splits are
    # all bundle splits among them
    seen = []
    fn = hk.route_level

    def spy(*args, **kw):
        bits = kw.get("catbits", args[5] if len(args) > 5 else None)
        tab = args[2]
        n_cat = int((tab[6] != 0).sum()) if tab.shape[0] == 7 else 0
        seen.append((isinstance(bits, torch.Tensor), n_cat,
                     int((tab[0] >= 0).sum())))
        return fn(*args, **kw)
    monkeypatch.setattr(hk, "route_level", spy)
    X, _, yr = _efb_data(blocks=(14,), levels=10, n_num=8)
    p = dict(BASE, objective="regression", use_quantized_grad="true", **CPU)
    lt.train(p, lt.Dataset(X, label=yr, params=p), 1)
    assert seen and all(bits == (n_cat > 0) for bits, n_cat, _ in seen)
    assert any(bits and n_cat == n_split for bits, n_cat, n_split in seen)


# ---- pandas ----

def _frame(pd, n=1500, seed=0, order=None):
    """A DataFrame: a numeric column, a category column of city names (in
    ``order`` when given), an int column and a category column of ints."""
    rng = np.random.RandomState(seed)
    cities = ["oslo", "rome", "lima", "kyiv", "baku", "doha"]
    city = np.asarray(cities)[rng.randint(0, 6, n)]
    df = pd.DataFrame({
        "x": rng.rand(n),
        "city": pd.Categorical(city, categories=order or sorted(cities)),
        "k": rng.randint(0, 5, n),
        "grade": pd.Categorical(rng.randint(1, 4, n))})
    eff = dict(zip(cities, np.random.RandomState(5).normal(size=6)))
    lat = df["x"].to_numpy() + np.array([eff[c] for c in city]) \
        + 0.3 * rng.randn(n)
    return df, (lat > np.median(lat)).astype(np.float32)


@pytest.fixture(scope="module")
def pandas_models():
    pd = pytest.importorskip("pandas")
    df, y = _frame(pd)
    p = dict(BASE, objective="binary", use_quantized_grad="true")
    ref = lgb.train(p, lgb.Dataset(df, label=y, params=p), 2)
    port = lt.train(dict(p, **CPU), lt.Dataset(df, label=y,
                                               params=dict(p, **CPU)), 2)
    return pd, df, y, ref, port


def test_pandas_category_columns_match_reference(pandas_models):
    # exact: "auto" takes the frame's category columns as categorical,
    # names come from the columns, and the first tree's structure,
    # categories and model text lines equal the reference's; the
    # pandas_categorical line is the reference's; predictions rtol 1e-4
    pd, df, y, ref, port = pandas_models
    assert port.train_set.pandas_categorical == \
        ref.train_set.pandas_categorical
    assert port.feature_name() == ["x", "city", "k", "grade"]
    (a,), (b,) = ref._gbdt.finalize()[:1], port._host_trees()[:1]
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert b.is_cat_node.any()
    rtext, ptext = ref.model_to_string(), port.model_to_string()
    assert _tree_lines(ptext, 0) == _tree_lines(rtext, 0)
    pc = [ln for ln in ptext.splitlines()
          if ln.startswith("pandas_categorical:")]
    assert pc == [ln for ln in rtext.splitlines()
                  if ln.startswith("pandas_categorical:")]
    assert pc[0] != "pandas_categorical:null"
    np.testing.assert_allclose(port.predict(df), ref.predict(df), rtol=1e-4)


def test_pandas_predict_remaps_categories_and_roundtrips(pandas_models,
                                                         tmp_path):
    # exact: a frame whose categories come in another order predicts as
    # the training order does (codes re-mapped through
    # pandas_categorical), before and after a save/load round trip;
    # against the reference rtol 1e-4
    pd, df, y, ref, port = pandas_models
    shuffled, _ = _frame(pd, order=["doha", "baku", "kyiv", "lima", "rome",
                                    "oslo"])
    np.testing.assert_array_equal(port.predict(shuffled), port.predict(df))
    np.testing.assert_allclose(port.predict(shuffled), ref.predict(shuffled),
                               rtol=1e-4)
    path = os.path.join(tmp_path, "m.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    assert loaded.pandas_categorical == port.pandas_categorical
    assert loaded.model_to_string() == port.model_to_string()
    np.testing.assert_array_equal(loaded.predict(shuffled), port.predict(df))
    refit = port.refit(df, y, decay_rate=0.5)
    ref_refit = ref.refit(df, y, decay_rate=0.5)
    np.testing.assert_allclose(refit.predict(df), ref_refit.predict(df),
                               rtol=1e-4)


def test_pandas_numeric_frame_and_object_columns():
    # a numeric frame trains the model of its array (model text equal but
    # the names), and an object column is refused as in the reference
    pd = pytest.importorskip("pandas")
    X, yb, _ = _efb_data(n=800)
    df = pd.DataFrame(X[:, :6], columns=[f"c{j}" for j in range(6)])
    p = dict(BASE, objective="binary", **CPU)
    a = lt.train(p, lt.Dataset(df, label=yb, params=p), 2)
    b = lt.train(p, lt.Dataset(X[:, :6], label=yb, feature_name=list(
        df.columns), params=p), 2)
    assert a.model_to_string() == b.model_to_string()
    bad = df.assign(s=pd.Series(["a"] * len(df), dtype=object))
    with pytest.raises(Exception, match="astype"):
        lgb.Dataset(bad, label=yb, params=BASE).construct()
    with pytest.raises(LightGBMError, match="astype"):
        lt.Dataset(bad, label=yb, params=p).construct()
