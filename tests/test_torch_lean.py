"""histogram_pool_size in the port (A13b), held against the JAX reference
on the CPU: the lean depthwise grower (feature tiles of hist_q8 / hist_f32
read in place at a column offset, cached split records, both children of
each split measured) and the leaf-wise grower's histogram pool (LRU slots,
evicted parents rebuilt by one more pass).

The quantized lean references train on the Pallas kernels in interpret mode
(histogram_impl=pallas); the reference's unquantized lean pass and its
pooled leaf-wise grower run on histogram_impl=scatter, whose f32 sums the
port's plain versions match to their last bits. The port trains with
device_type="cpu" (the kernels' plain versions).

Exact: lean_ft and hist_pool as the reference sizes them; every tree's
structure of the quantized L2 models and the first tree's of the binary
ones (queue C1), on numerical data cut into tiles at column offsets that
are not multiples of 4, categorical data, EFB bundles from CSR, monotone
constraints with min_gain_to_split, and feature_contri whose later tiles
are all 1.0; the first tree's structure of the unquantized lean and pooled
models; the tie rule of the tiles' fold; the tile wrappers against their
plain versions on a column range; and, under each setting that keeps the
whole frontier, the warning and the default grower's model. Tolerance:
leaf values rtol 1e-4 with an absolute 1e-5 of the largest leaf, and
predictions rtol 1e-4 (raw scores with atol 1e-6; queue C2).
"""
import logging

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.gbdt import padded_bins
from lightgbm_tpu_torch.ops import grow_depthwise as gd
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops.split import SplitResult
from test_torch_categorical import CATS, _cat_data
from test_torch_efb import _efb_data

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "max_bin": 31, "min_data_in_leaf": 5,
        "verbosity": -1, "prewarm": 0}
PALLAS = {"histogram_impl": "pallas", "use_quantized_grad": "true"}
SCATTER = {"histogram_impl": "scatter", "use_quantized_grad": "false"}
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child", "is_cat_node")


def _num_data(n=800, f=11, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    X[rng.rand(n) < 0.05, 4] = np.nan
    lat = (X[:, 0] * 2 - X[:, 5] + np.sin(6 * X[:, 9])
           + np.nan_to_num(X[:, 4]) + 0.3 * rng.randn(n))
    yb = (lat > np.median(lat)).astype(np.float32)
    yr = (np.round(np.clip(lat, -4, 4) * 8) / 8).astype(np.float32)
    return X, yb, yr


def _lean_mb(ft, num_leaves, b):
    """A histogram_pool_size (MB) whose lean feature tile is ft."""
    slots = 2 * max(1, num_leaves // 2)
    return (ft * slots * 3 * b * 4 + 1) / float(1 << 20)


def _pool_mb(pool, f, b):
    """A histogram_pool_size (MB) that caches ``pool`` leaf histograms."""
    return (pool * 3 * f * b * 4 + 1) / float(1 << 20)


def _trees(ref, port):
    return ref._gbdt.finalize(), port._host_trees()


def _check_models(ref, port, X, exact, data=None):
    """Structures of the first ``exact`` trees exact, their leaves rtol
    1e-4 (absolute 1e-5 of the largest), predictions rtol 1e-4."""
    rt, pt = _trees(ref, port)
    assert len(rt) == len(pt) == 3
    for i in range(exact):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(pt[i], name),
                                          getattr(rt[i], name),
                                          err_msg=f"tree {i} {name}")
        np.testing.assert_allclose(
            pt[i].leaf_value, rt[i].leaf_value, rtol=1e-4,
            atol=1e-5 * np.abs(rt[i].leaf_value).max())
    pdata = X if data is None else data
    np.testing.assert_allclose(port.predict(pdata, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)


# ---- the lean depthwise grower, quantized ----

LEAN_CASES = {
    # eleven columns in tiles of 3: column offsets 3, 6 and 9
    "numerical": dict(data="num", ft=3),
    "categorical": dict(data="cat", ft=2),
    "efb_csr": dict(data="efb", ft=2),
    "monotone_min_gain": dict(
        data="num", ft=4, params={"monotone_constraints":
                                  [1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 0],
                                  "min_gain_to_split": 0.05}),
    # contri on the first tile only: the later tiles' slices are all 1.0
    "contri": dict(data="num", ft=4, params={
        "feature_contri": [0.5, 1.0, 0.8, 1.0] + [1.0] * 7}),
}


def _case_data(kind):
    if kind == "num":
        return _num_data(), {}
    if kind == "cat":
        X, yb, yr = _cat_data(n=800)
        return (X, yb, yr), {"categorical_feature": CATS}
    X, yb, yr = _efb_data(n=1200)
    return (X, yb, yr), {}


@pytest.fixture(scope="module", params=sorted(LEAN_CASES))
def lean_models(request):
    case = LEAN_CASES[request.param]
    (X, yb, yr), ds_kw = _case_data(case["data"])
    out = {}
    for objective, y in (("regression", yr), ("binary", yb)):
        p = dict(BASE, **PALLAS, objective=objective,
                 **case.get("params", {}))
        p["histogram_pool_size"] = _lean_mb(case["ft"], p["num_leaves"], 64)
        ref = lgb.train(p, lgb.Dataset(X, label=y, params=p, **ds_kw), 3)
        pt = dict(p, **CPU)
        data = sps.csr_matrix(X) if case["data"] == "efb" else X
        port = lt.train(pt, lt.Dataset(data, label=y, params=pt, **ds_kw), 3)
        out[objective] = (ref, port)
    return request.param, case, X, out


def test_lean_tile_and_path_match_reference(lean_models):
    # exact: the reference's lean_ft, the tiles it gives, the lean path
    # (no fused front, one level pass a level) and a bundled Dataset on
    # the CSR case
    name, case, X, out = lean_models
    ref, port = out["regression"]
    gp = port._gbdt.gp
    assert gp.lean_ft == ref._gbdt.gp.lean_ft == case["ft"]
    assert gp.hist_pool == 0 and gp.quant and gp.fused_obj is None
    f = port.train_set.num_features
    tiles = gd.lean_tiles(f, gp.lean_ft)
    assert len(tiles) >= 2 and tiles[-1][1] == f
    if name == "numerical":
        assert len(tiles) >= 3 and any(lo % 4 for lo, _ in tiles)
    if name == "efb_csr":
        assert port.train_set.bundle_meta is not None
    assert min(port._gbdt.hist_passes) >= 2


def test_lean_l2_every_tree_exact(lean_models):
    name, case, X, out = lean_models
    ref, port = out["regression"]
    data = sps.csr_matrix(X) if case["data"] == "efb" else X
    _check_models(ref, port, X, exact=3, data=data)


def test_lean_binary_first_tree_exact(lean_models):
    name, case, X, out = lean_models
    ref, port = out["binary"]
    data = sps.csr_matrix(X) if case["data"] == "efb" else X
    _check_models(ref, port, X, exact=1, data=data)
    if name == "monotone_min_gain":
        # the port's own model keeps each constraint's direction
        grid = np.tile(X[:50], (8, 1))
        for j, sign in ((0, 1), (5, -1)):
            sweep = grid.copy()
            sweep[:, j] = np.repeat(np.linspace(0, 1, 8), 50)
            raw = port.predict(sweep, raw_score=True).reshape(8, 50)
            assert (np.diff(raw, axis=0) * sign >= 0).all()


# ---- the unquantized lean grower and the pooled leaf-wise grower ----

@pytest.fixture(scope="module", params=["lean_f32", "pooled"])
def f32_models(request):
    X, yb, yr = _num_data()
    b = padded_bins(32)
    out = {}
    for objective, y in (("regression", yr), ("binary", yb)):
        p = dict(BASE, **SCATTER, objective=objective)
        if request.param == "pooled":
            p.update(grow_policy="lossguide",
                     histogram_pool_size=_pool_mb(4, X.shape[1], b))
        else:
            p["histogram_pool_size"] = _lean_mb(3, p["num_leaves"], b)
        ref = lgb.train(p, lgb.Dataset(X, label=y, params=p), 3)
        pt = dict(p, **CPU)
        port = lt.train(pt, lt.Dataset(X, label=y, params=pt), 3)
        out[objective] = (ref, port)
    return request.param, X, out


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_f32_lean_and_pooled_match_reference(f32_models, objective):
    # exact: the sizes and the first tree's structure; leaves and
    # predictions rtol 1e-4 (the tolerances of test_torch_unquantized.py)
    path, X, out = f32_models
    ref, port = out[objective]
    gp, rgp = port._gbdt.gp, ref._gbdt.gp
    assert not gp.quant
    assert (gp.lean_ft, gp.hist_pool) == (rgp.lean_ft, rgp.hist_pool)
    if path == "pooled":
        assert gp.hist_pool == 4 and gp.lean_ft == 0
        # evicted parents were rebuilt, one more pass each
        assert min(port._gbdt.hist_rebuilds) >= 1
    else:
        assert gp.lean_ft == 3 and gp.hist_pool == 0
    _check_models(ref, port, X, exact=1)


def test_pool_rebuilds_change_no_tree():
    # exact: the pooled leaf-wise model equals the unpooled one's structure
    # (a rebuilt parent histogram holds the same sums), and the pooled
    # grower's passes are the splits plus its rebuilds
    X, _, yr = _num_data()
    runs = {}
    for mb in (0, _pool_mb(2, X.shape[1], padded_bins(32))):
        p = dict(BASE, **CPU, objective="regression", grow_policy="lossguide",
                 histogram_pool_size=mb)
        runs[mb] = lt.train(p, lt.Dataset(X, label=yr, params=p), 2)
    plain, pooled = runs.values()
    assert pooled._gbdt.gp.hist_pool == 2
    assert min(pooled._gbdt.hist_rebuilds) >= 1
    for a, b in zip(plain._host_trees(), pooled._host_trees()):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    np.testing.assert_allclose(pooled.predict(X), plain.predict(X),
                               rtol=1e-6)


# ---- pieces ----

def test_fold_best_keeps_the_earlier_tile_on_ties():
    # exact: the higher gain wins; on equal gains the earlier tile's
    # record (the reference's b.gain > a.gain)
    def rec(gain, feat):
        n = len(gain)
        z = torch.zeros(n)
        return SplitResult(
            gain=torch.tensor(gain), feature=torch.tensor(feat),
            bin=torch.tensor(feat) * 2, default_left=torch.tensor(
                [f % 2 == 1 for f in feat]), left_g=z + torch.tensor(feat),
            left_h=z, left_cnt=z, is_cat=torch.zeros(n, dtype=torch.bool),
            cat_member=torch.tensor([[f % 3 == 0] * 4 for f in feat]))
    a = rec([1.0, 2.0, -1e30, 3.0], [0, 1, 2, 3])
    b = rec([1.0, 2.5, -1e30, 2.0], [10, 11, 12, 13])
    out = gd.fold_best(a, b)
    assert out.feature.tolist() == [0, 11, 2, 3]
    assert out.bin.tolist() == [0, 22, 4, 6]
    assert out.default_left.tolist() == [False, True, False, True]
    assert out.left_g.tolist() == [0.0, 11.0, 2.0, 3.0]
    assert out.cat_member[1].tolist() == [False] * 4
    assert out.cat_member[0].tolist() == [True] * 4


def test_tile_split_params_keep_the_clamp_and_the_rewrite():
    # exact: a tile whose slice of the constraints is trivial still clamps
    # to the leaf's bounds and rewrites to the penalized improvement
    from lightgbm_tpu.ops import grow_depthwise as ref_gd
    from lightgbm_tpu.ops.split import SplitParams as RefSP
    from lightgbm_tpu_torch.ops.split import SplitParams
    kw = dict(cat_features=(1, 6), monotone_constraints=(1, 0, 0, 0, 0, 0),
              feature_contri=(0.5, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0))
    for lo, hi in ((0, 3), (3, 6), (6, 7)):
        a = ref_gd._tile_split_params(RefSP(**kw), lo, hi)
        b = gd.tile_split_params(SplitParams(**kw), lo, hi)
        for name in ("cat_features", "monotone_constraints", "feature_contri",
                     "monotone_clamp", "contri_active", "has_monotone",
                     "has_contri"):
            assert getattr(b, name) == getattr(a, name), (lo, name)
        assert b.has_monotone and b.has_contri


@pytest.mark.parametrize("lo,hi", [(0, 4), (5, 11), (9, 13)])
@pytest.mark.parametrize("kernel", ["hist_q8", "hist_f32"])
def test_tile_wrappers_equal_the_plain_versions(kernel, lo, hi):
    # exact: the wrapper on a tile (bins_T's rows [lo, hi) as a view, the
    # whole row-major bins and col0) equals the plain version on that
    # tile, with a slot vector and the counts, and without one; a tile
    # outside the bins, or an offset without them, raises
    rng = np.random.RandomState(lo)
    n, f, b, s = 3000, 13, 64, 6
    bins = torch.from_numpy(rng.randint(0, b, (n, f)).astype(np.uint8))
    bins_T = bins.t().contiguous()
    slot = torch.from_numpy(rng.randint(0, s + 2, n).astype(np.int32))
    counts = torch.bincount(slot[slot < s].long(), minlength=s).to(
        torch.int32)
    if kernel == "hist_q8":
        chans = [torch.from_numpy(rng.randint(-127, 128, n).astype(np.int8)),
                 torch.from_numpy(rng.randint(0, 128, n).astype(np.int8)),
                 torch.from_numpy((rng.rand(n) < 0.9).astype(np.int8))]
        fn, plain = hk.hist_q8, hk.hist_q8_plain
    else:
        chans = [torch.from_numpy(rng.randn(n).astype(np.float32))
                 for _ in range(3)]
        fn, plain = hk.hist_f32, hk.hist_f32_plain
    tile = bins_T[lo:hi]
    assert tile.is_contiguous() and tile.data_ptr() != bins_T.data_ptr() \
        or lo == 0
    for sl, ns, cnt in ((slot, s, counts), (None, 1, None)):
        got = fn(tile, *chans, sl, ns, b, bins, cnt, col0=lo)
        want = plain(bins_T[lo:hi].clone(), *chans, sl, ns, b)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        fn(tile, *chans, slot, s, b, bins, counts, col0=f - (hi - lo) + 1)
    with pytest.raises(ValueError, match="offset"):
        fn(tile, *chans, None, 1, b, None, None, col0=lo or 1)


@pytest.mark.parametrize("setting", [
    {"cegb_penalty_split": 0.01}, {"feature_fraction_bynode": 0.7},
    {"extra_trees": True}, "forced"])
def test_incompatible_settings_warn_and_keep_the_whole_frontier(
        setting, caplog, tmp_path):
    # exact: a warning, no lean tile, and the model of the same settings
    # without histogram_pool_size (the default grower's), as the reference
    X, _, yr = _num_data()
    if setting == "forced":
        fn = tmp_path / "forced.json"
        fn.write_text('{"feature": 1, "threshold": 0.5}')
        setting = {"forcedsplits_filename": str(fn)}
    models = []
    for mb in (_lean_mb(3, 15, 64), -1):
        p = dict(BASE, **CPU, objective="regression", **setting,
                 histogram_pool_size=mb)
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            models.append(lt.train(p, lt.Dataset(X, label=yr, params=p), 2))
        warned = any("histogram_pool_size is ignored" in r.getMessage()
                     for r in caplog.records)
        assert warned == (mb > 0)
        assert models[-1]._gbdt.gp.lean_ft == 0
    for a, b in zip(*(m._host_trees() for m in models)):
        for name in STRUCT + ("leaf_value",):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    rp = dict(BASE, **PALLAS, objective="regression", **setting,
              histogram_pool_size=_lean_mb(3, 15, 64))
    ref = lgb.Booster(params=rp, train_set=lgb.Dataset(X, label=yr,
                                                       params=rp))
    assert ref._gbdt.gp.lean_ft == 0
