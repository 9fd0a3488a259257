"""The split constraints of the PyTorch/CUDA port (lightgbm_tpu_torch):
monotone constraints, feature_contri, extra_trees, CEGB, forced splits and
forced bins, held against the JAX reference (lightgbm_tpu) on the CPU.

The reference runs its Pallas kernels in interpret mode
(histogram_impl=pallas); the port runs with device_type="cpu", on the
kernels' plain versions.

Exact, bit for bit:
- every field of ``best_split``'s record with leaf output bounds and the
  direction filter, feature_contri, a CEGB penalty plane and an
  extra_trees key, on numerical, categorical and EFB bundle columns;
- the extra_trees uniforms and the thresholds drawn from them;
- the bin mappers and bins under forced bin bounds, dense and sparse, and
  through ``forcedbins_filename``;
- the structure of every tree of 3-iteration L2 models (labels on a 1/8
  grid) for each setting on the fused quantized depthwise path
  (max_bin=63), the unfused one (max_bin=255 on 9 columns, F * B > 2048),
  the unquantized depthwise grower and lossguide (which the reference
  gives no CEGB);
- the monotone sweep of the port's own models: the raw prediction moves
  in the constraint's direction, with no tolerance.
Tolerances: leaf values and predictions rtol 1e-4 (queue C2: the
reference renews leaves from bf16 hi/lo sums; later gradients inherit
it). Binary first trees under each setting are held exactly in
tests/test_torch_train.py (``test_out_of_slice_settings_raise``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import binning as ref_binning
from lightgbm_tpu.ops import split as ref_split
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import binning as t_binning
from lightgbm_tpu_torch import efb as t_efb
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops import split as t_split
from lightgbm_tpu_torch.ops.grow import extra_trees_key
from lightgbm_tpu_torch.utils import threefry

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 8, "min_data_in_leaf": 5, "verbosity": -1,
        "prewarm": 0, "histogram_impl": "pallas",
        "use_quantized_grad": "true"}
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- best_split ----

# columns: 0 numerical (10 bins, missing bin 9), 1 a bundle of three
# features, 2 categorical (6 bins), 3 a bundle of two, 4 numerical (12
# bins, no missing bin)
COLUMNS = [[(0, 0, 10)], [(1, 1, 3), (2, 3, 4), (3, 6, 3)], [(4, 0, 6)],
           [(5, 1, 5), (6, 5, 2)], [(7, 0, 12)]]
DEFAULTS = np.array([0, 0, 1, 2, 0, 0, 1, 0], np.int32)
NB = np.array([10, 8, 6, 6, 12], np.int32)
NA = np.array([9, 16, 0, 16, 16], np.int32)
B = 16


def _hists(seed, L=6, n=3000):
    """[L, 3, 5, B] histograms of random rows: gradients N(0, 1) plus a
    step on columns 0 and 4, hessians on [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    bins = np.stack([rng.integers(0, b, n) for b in NB], 1)
    g = (rng.normal(size=n) + 0.8 * (bins[:, 0] > 4) - 0.6 * (bins[:, 4] > 6)
         ).astype(np.float32)
    h = (0.5 + rng.random(n)).astype(np.float32)
    leaf = rng.integers(0, L, n)
    hist = np.zeros((L, 3, len(NB), B), np.float32)
    for j in range(len(NB)):
        for ch, v in enumerate((g, h, np.ones(n, np.float32))):
            np.add.at(hist[:, ch, j], (leaf, bins[:, j]), v)
    return hist


def _bundles():
    meta = t_efb._columns_meta(COLUMNS, DEFAULTS)
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


SPLIT_CASES = {
    "monotone": ({"monotone_constraints": (1, 0, 0, 0, -1)}, True, False,
                 False),
    "contri": ({"feature_contri": (0.5, 1.0, 0.7, 1.0, 1.3),
                "min_gain_to_split": 0.05}, False, False, False),
    "penalty": ({}, False, True, False),
    "extra_trees": ({"extra_trees": True}, False, False, True),
    # bounds and the CEGB plane together, as a constrained tree under
    # CEGB searches them
    "monotone_penalty": ({"monotone_constraints": (0, 1, 0, 0, -1),
                          "lambda_l2": 0.5}, True, True, False),
    "all": ({"monotone_constraints": (-1, 0, 0, 0, 1),
             "feature_contri": (0.9, 0.6, 1.0, 1.0, 0.4),
             "extra_trees": True, "lambda_l1": 0.3,
             "max_delta_step": 2.0}, True, True, True),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_best_split_constraints_exact(case, seed):
    # exact, bit for bit on every field and the sign of every float
    sp, bounded, penalty, rand = SPLIT_CASES[case]
    hist = _hists(seed)
    L = hist.shape[0]
    rng = np.random.default_rng(10 + seed)
    pg, ph, pc = (hist[:, k, 0].sum(-1) for k in range(3))
    lo = np.where(rng.random(L) < 0.5, -np.inf,
                  -rng.random(L) * 0.02).astype(np.float32)
    hi = np.where(rng.random(L) < 0.5, np.inf,
                  rng.random(L) * 0.02).astype(np.float32)
    pen = (rng.random((L, len(NB))) * 2.0).astype(np.float32)
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(6), 3), 2)
    fm = np.ones(len(NB), bool)
    allow = np.array([True] * (L - 1) + [False])
    kw = dict(min_data_in_leaf=5, cat_features=(2,), has_bundles=True,
              max_cat_to_onehot=4, cat_smooth=1.0, min_data_per_group=5,
              **sp)
    tb, rb = _bundles()
    ref = ref_split.best_split(
        jnp.asarray(hist), jnp.asarray(NB), jnp.asarray(NA), jnp.asarray(pg),
        jnp.asarray(ph), jnp.asarray(pc), jnp.asarray(fm),
        ref_split.SplitParams(**kw), jnp.asarray(allow),
        leaf_min=jnp.asarray(lo) if bounded else None,
        leaf_max=jnp.asarray(hi) if bounded else None, bundle=rb,
        gain_penalty=jnp.asarray(pen) if penalty else None,
        rand_key=(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(6), 3), 2) if rand else None))
    port = t_split.best_split(
        _t(hist), _t(NB), _t(NA), _t(pg), _t(ph), _t(pc), _t(fm),
        t_split.SplitParams(**kw), _t(allow), tb,
        leaf_min=_t(lo) if bounded else None,
        leaf_max=_t(hi) if bounded else None,
        gain_penalty=_t(pen) if penalty else None,
        rand_key=key if rand else None)
    for name in ref._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(port, name).numpy()
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.signbit(b), np.signbit(a),
                                          err_msg=name)
    assert (port.gain > -1e29).any()


def test_extra_trees_draws_exact():
    # exact: the replica's uniforms under the extra_trees key of (seed,
    # tree, level) and the thresholds they draw equal jax.random's
    sp = t_split.SplitParams(extra_trees=True, extra_seed=11)
    nb = np.array([2, 3, 17, 64, 256, 1], np.int32)
    for qseed, lvl in ((0, 0), (7, 3), (123, 254)):
        u = threefry.uniform(extra_trees_key(sp, qseed, lvl), (9, len(nb)))
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(11), qseed), lvl)
        ru = jax.random.uniform(key, (9, len(nb)))
        np.testing.assert_array_equal(u.numpy().view(np.int32),
                                      np.asarray(ru).view(np.int32))
        rr = jnp.minimum(jnp.floor(ru * jnp.maximum(jnp.asarray(nb) - 1, 1))
                         .astype(jnp.int32), jnp.asarray(nb) - 2)
        nbt = _t(nb).to(torch.int64)
        tr = torch.minimum(torch.floor(u * torch.clamp(nbt - 1, min=1).to(
            torch.float32)).to(torch.int64), nbt - 2)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(rr))
    assert extra_trees_key(t_split.SplitParams(), 1, 1) is None


# ---- forced bins ----

FORCED = {0: [-1.0, 0.0, 1.0], 1: [0.0], 3: [0.5, -0.25, 0.5, 2.0]}


def _mappers_equal(ref_m, port_m):
    for a, b in zip(ref_m, port_m):
        assert (a.num_bins, a.missing_type, a.default_bin, a.is_trivial) == \
            (b.num_bins, b.missing_type, b.default_bin, b.is_trivial)
        np.testing.assert_array_equal(b.upper_bounds, a.upper_bounds)


@pytest.mark.parametrize("max_bin", [3, 63])
def test_forced_bin_mappers_exact(max_bin):
    # exact: mappers and bins with forced bounds (NaN, a duplicate bound,
    # a bound list capped at max_bin - 1) on dense and sparse input
    rng = np.random.RandomState(2)
    X = rng.randn(500, 5)
    X[rng.rand(500) < 0.1, 1] = np.nan
    X[rng.rand(500) < 0.6, 3] = 0.0
    kw = dict(max_bin=max_bin, min_data_in_bin=3, sample_cnt=400, seed=3,
              forced_bins=FORCED)
    ref_m = ref_binning.find_bin_mappers(X, **kw)
    port_m = t_binning.find_bin_mappers(X, **kw)
    _mappers_equal(ref_m, port_m)
    assert port_m[0].num_bins == min(4, max_bin)
    ref_b = ref_binning.bin_data(X, ref_m)
    used = t_binning.used_features(port_m)
    port_b = t_binning.bin_data(X, [port_m[j] for j in used], used,
                                torch.device("cpu"))
    np.testing.assert_array_equal(port_b.numpy(), ref_b.bins)
    csc = sps.csc_matrix(np.where(np.isnan(X), 0.0, X) * (rng.rand(500, 5)
                                                            < 0.4))
    ref_s = ref_binning.find_bin_mappers_sparse(csc, **kw)
    port_s = t_binning.find_bin_mappers_sparse(csc, **kw)
    _mappers_equal(ref_s, port_s)


def test_forcedbins_filename_dataset_exact(tmp_path):
    # exact: the Dataset's mappers and bins through forcedbins_filename
    rng = np.random.RandomState(4)
    X = rng.randn(400, 6).astype(np.float32)
    fn = tmp_path / "bins.json"
    fn.write_text(json.dumps([{"feature": k, "bin_upper_bound": v}
                              for k, v in FORCED.items()]))
    p = dict(BASE, max_bin=63, forcedbins_filename=str(fn))
    ref = lgb.Dataset(X, label=X[:, 0], params=p).construct()
    port = lt.Dataset(X, label=X[:, 0], params=dict(p, **CPU)).construct()
    _mappers_equal(ref.mappers, port.mappers)
    np.testing.assert_array_equal(port.bins.numpy(), np.asarray(ref.bins))
    np.testing.assert_array_equal(port.mappers[1].upper_bounds, [0.0, np.inf])


# ---- whole models ----

def _rows(n_feat=8, seed=7):
    """400 rows; labels on a 1/8 grid, rising with column 0 and falling
    with column 2; with 9 columns, every value distinct enough for more
    than 128 bins at max_bin=255 and min_data_in_bin=1 (F * B = 2304)."""
    rng = np.random.RandomState(seed)
    X = rng.rand(400, n_feat).astype(np.float32)
    X[rng.rand(400) < 0.05, 5] = np.nan
    y = np.round((2.0 * X[:, 0] - 1.5 * X[:, 2] + X[:, 1] * X[:, 3]
                  + 0.5 * rng.rand(400)) * 8) / 8
    return X, y.astype(np.float32)


def _settings(tmp):
    forced = tmp / "forced.json"
    forced.write_text(json.dumps({
        "feature": 1, "threshold": 0.5,
        "left": {"feature": 3, "threshold": 0.3,
                 "right": {"feature": 4, "threshold": 0.6}}}))
    forced0 = tmp / "forced0.json"
    forced0.write_text(json.dumps({
        "feature": 0, "threshold": 0.4,
        "right": {"feature": 2, "threshold": 0.5}}))
    bins = tmp / "fbins.json"
    bins.write_text(json.dumps([{"feature": 1,
                                 "bin_upper_bound": [0.25, 0.5, 0.75]}]))
    return {
        "monotone": {"monotone_constraints": [1, 0, -1, 0, 0, 0, 0, 0, 0]},
        "contri": {"feature_contri": [1.0, 0.5, 1.0, 0.3, 1.0, 1.0, 1.0, 0.0,
                                      1.0]},
        "extra_trees": {"extra_trees": True, "extra_seed": 3},
        "cegb": {"cegb_penalty_split": 0.002,
                 "cegb_penalty_feature_coupled": [0.0, 0.0, 0.0, 5.0, 0.0,
                                                  0.0, 5.0, 0.0, 0.0],
                 "cegb_penalty_feature_lazy": [0.01, 0.002, 0.0, 0.0, 0.02,
                                               0.0, 0.0, 0.0, 0.001]},
        "forced": {"forcedsplits_filename": str(forced),
                   "forcedbins_filename": str(bins)},
        # forced splits on constrained features pin their midpoints as
        # the subtrees' bounds, with extra_trees beside
        "combined": {"monotone_constraints": [1, 0, -1, 0, 0, 0, 0, 0, 0],
                     "extra_trees": True,
                     "forcedsplits_filename": str(forced0)},
    }


PATHS = {
    "fused63": {"max_bin": 63},
    "unfused255": {"max_bin": 255, "min_data_in_bin": 1},
    "unquantized": {"max_bin": 63, "use_quantized_grad": "false"},
    "lossguide": {"max_bin": 63, "grow_policy": "lossguide"},
}


@pytest.fixture(scope="module")
def settings(tmp_path_factory):
    return _settings(tmp_path_factory.mktemp("constraints"))


def _trim(extra, n_feat):
    return {k: (v[:n_feat] if isinstance(v, list) else v)
            for k, v in extra.items()}


def _train_pair(path, setting, settings, objective="regression", rounds=3):
    n_feat = 9 if path == "unfused255" else 8
    X, y = _rows(n_feat)
    if objective == "binary":
        y = (y > np.median(y)).astype(np.float32)
    p = dict(BASE, objective=objective, **PATHS[path],
             **_trim(settings[setting], n_feat))
    ref = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                    num_boost_round=rounds)
    pt = dict(p, **CPU)
    port = lt.train(pt, lt.Dataset(X, label=y, params=pt),
                    num_boost_round=rounds)
    return X, ref, port


MODEL_CASES = [(path, setting) for path in PATHS
               for setting in ("monotone", "contri", "extra_trees", "cegb",
                               "forced")
               if not (path == "lossguide" and setting == "cegb")] + [
                   ("fused63", "combined"), ("lossguide", "combined")]


@pytest.mark.parametrize("path,setting", MODEL_CASES)
def test_constrained_models_match_reference(path, setting, settings):
    # exact structure of every tree of a 3-iteration L2 model; leaf values
    # and predictions rtol 1e-4 (queue C2)
    X, ref, port = _train_pair(path, setting, settings)
    g = port._gbdt
    assert g.gp.quant == (path in ("fused63", "unfused255"))
    fused = path == "fused63" and setting not in ("cegb", "forced",
                                                  "combined")
    assert (g.gp.fused_obj is not None) == fused
    if path == "unfused255":
        assert port.train_set.num_features * g.gp.max_bin > 2048
    rt, pt = ref._gbdt.finalize(), port._host_trees()
    assert len(rt) == len(pt) == 3
    for a, b in zip(rt, pt):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)
    if setting == "forced":
        # the forced root and its left child in every tree
        for t in pt:
            assert t.split_feature[0] == 1 and t.threshold_real[0] == 0.5
            assert t.split_feature[t.left_child[0]] == 3
    if setting == "cegb":
        # the coupled penalty blocks columns 3 and 6
        for t in pt:
            used = t.split_feature[: t.num_leaves - 1]
            assert not np.isin(used, [3, 6]).any()


def test_cegb_lossguide_warns_and_trains_unpenalized(settings, caplog):
    # exact: on lossguide the CEGB parameters warn and change nothing, as
    # in the reference
    X, y = _rows()
    p = dict(BASE, objective="regression", **PATHS["lossguide"], **CPU)
    plain = lt.train(p, lt.Dataset(X, label=y, params=p), 2)
    pc = dict(p, **_trim(settings["cegb"], 8))
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        cegb = lt.train(pc, lt.Dataset(X, label=y, params=pc), 2)
    assert any("CEGB is only supported" in r.getMessage()
               for r in caplog.records)
    assert cegb._gbdt.cegb is None and not cegb._gbdt.gp.split.has_cegb
    assert cegb.model_to_string().split("parameters:")[0] == \
        plain.model_to_string().split("parameters:")[0]


def test_cegb_vector_length_is_fatal():
    X, y = _rows()
    p = dict(BASE, objective="regression", max_bin=63,
             cegb_penalty_feature_coupled=[1.0] * 5, **CPU)
    with pytest.raises(LightGBMError, match="same size as feature number"):
        lt.train(p, lt.Dataset(X, label=y, params=p), 1)


def _exclusive(n=400, seed=1):
    """Columns 0-3 mutually exclusive (one of them set a row), 4-7 dense."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 8).astype(np.float32)
    X[:, :4] = 0.0
    which = rng.randint(0, 4, n)
    for j in range(4):
        rows = (which == j) & (rng.rand(n) < 0.7)
        X[rows, j] = 1.0 + j + rng.rand(rows.sum())
    y = np.round((X[:, 0] - X[:, 1] + X[:, 4] + 0.3 * rng.rand(n)) * 8) / 8
    return X, y.astype(np.float32)


def test_bundled_forced_feature_warns(tmp_path, caplog):
    # a forced feature that EFB bundled warns and drops its subtree, in
    # both packages: the model is the unforced one
    X, y = _exclusive()
    fn = tmp_path / "forced.json"
    fn.write_text(json.dumps({"feature": 0, "threshold": 0.5}))
    p = dict(BASE, objective="regression", max_bin=63, **CPU)
    plain = lt.train(p, lt.Dataset(X, label=y, params=p), 2)
    pf = dict(p, forcedsplits_filename=str(fn))
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        forced = lt.train(pf, lt.Dataset(sps.csr_matrix(X), label=y,
                                         params=pf), 2)
    assert forced.train_set.bundle_meta is not None
    assert forced._gbdt.forced is None
    assert any("was bundled by EFB" in r.getMessage()
               for r in caplog.records)
    assert forced.model_to_string().split("parameters:")[0] == \
        plain.model_to_string().split("parameters:")[0]
    ref_p = {k: v for k, v in pf.items() if k != "device_type"}
    ref = lgb.train(ref_p, lgb.Dataset(X, label=y, params=ref_p), 1)
    assert ref._gbdt._forced_dev is None


def test_monotone_and_contri_under_efb(caplog):
    # exact: a monotone feature stays out of the bundles (the plan equals
    # the reference's on CSR input), the model's first tree equals the
    # reference's; a feature_contri other than ones turns bundling off
    # with a warning
    X, y = _exclusive()
    mc = [1, 0, 0, 0, 0, 0, 0, 0]
    p = dict(BASE, objective="regression", max_bin=63,
             monotone_constraints=mc)
    ref = lgb.train(p, lgb.Dataset(sps.csr_matrix(X), label=y, params=p), 2)
    pt = dict(p, **CPU)
    port = lt.train(pt, lt.Dataset(sps.csr_matrix(X), label=y, params=pt), 2)
    meta, ref_meta = port.train_set.bundle_meta, ref.train_set.bundle_meta

    def members(m):
        return [[tuple(int(v) for v in x) for x in mem] for mem in m.members]
    assert meta is not None and members(meta) == members(ref_meta)
    assert [(0, 0, port.train_set.mappers[0].num_bins)] in members(meta)
    assert any(len(m) > 1 for m in meta.members)
    assert port._gbdt.gp.split.monotone_constraints[0] == 1
    rt, ptr = ref._gbdt.finalize(), port._host_trees()
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(ptr[0], name),
                                      getattr(rt[0], name), err_msg=name)
    pc = dict(BASE, objective="regression", max_bin=63,
              feature_contri=[1.0] * 7 + [0.5], **CPU)
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        ds = lt.Dataset(sps.csr_matrix(X), label=y, params=pc).construct()
    assert ds.bundle_meta is None
    assert any("EFB bundling is disabled" in r.getMessage()
               for r in caplog.records)


def test_dataset_getters_match_reference():
    X, y = _rows()
    for params in ({}, {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0],
                        "feature_penalty": "0.5,1,1,1,1,1,1,2"}):
        ref = lgb.Dataset(X, label=y, params=params)
        port = lt.Dataset(X, label=y, params=params)
        for get in ("get_feature_penalty", "get_monotone_constraints"):
            a, b = getattr(ref, get)(), getattr(port, get)()
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("grow", ["depthwise", "lossguide",
                                  "depthwise_f32"])
def test_monotone_sweep_exact(grow):
    # exact: sweeping a constrained feature over 32 values that span its
    # bin bounds, the other features held, moves the raw prediction in the
    # constraint's direction, with no tolerance; extra_trees and a forced
    # root ride along on the depthwise run
    X, y = _rows()
    mc = [1, 0, -1, 0, 0, 0, 0, 0]
    extra = {"use_quantized_grad": "false"} if grow == "depthwise_f32" \
        else {}
    p = dict(BASE, objective="regression", max_bin=63, num_leaves=16,
             min_data_in_leaf=3, monotone_constraints=mc,
             grow_policy="lossguide" if grow == "lossguide" else "depthwise",
             extra_trees=grow == "depthwise", **extra, **CPU)
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), 5)
    base = X[:50].astype(np.float64)
    for j, sign in ((0, 1), (2, -1)):
        bounds = bst.train_set.mappers[j].upper_bounds[:-1]
        vals = np.linspace(bounds.min() - 0.01, bounds.max() + 0.01, 32)
        rows = np.repeat(base, 32, axis=0)
        rows[:, j] = np.tile(vals, 50)
        pred = bst.predict(rows, raw_score=True).reshape(50, 32)
        assert (sign * np.diff(pred, axis=1) >= 0).all()
        assert (np.ptp(pred, axis=1) > 0).any()
