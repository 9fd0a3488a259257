"""Row and feature sampling of the PyTorch/CUDA port (lightgbm_tpu_torch)
against the JAX reference (lightgbm_tpu), on the CPU.

The reference trains on its Pallas kernels in interpret mode
(histogram_impl=pallas), the port with device_type="cpu" on the kernels'
plain versions, as in tests/test_torch_train.py.

Exact (bit for bit): the threefry replica's PRNGKey, split, fold_in and
uniform against jax.random; the bag masks (bagging_freq 1 and 3, plain and
balanced by label) over 6 iterations; the feature_fraction masks; the
feature_fraction_bynode masks per level (depthwise) and per split step
(lossguide); GOSS's row weights on the same gradients; and the tree
structures of 3-iteration models with bagging + feature_fraction +
feature_fraction_bynode on the fused (max_bin=63), unfused (255), f32 and
lossguide paths, and with GOSS (binary models: the first tree, see
``_assert_models_match``). Tolerances: predictions rtol 1e-4; leaf values
and raw scores rtol 1e-4 plus an absolute 1e-4 of the largest in
magnitude (queue C2: the reference renews leaves from bf16 hi/lo sums,
whose error scales with the leaf's row mass, so a leaf whose gradients
nearly cancel, such as 0.0019 beside 0.18 in a bagged binary tree,
differs by more than 1e-4 of itself: 2.3e-7 there).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops.grow import GrowParams, node_feature_mask
from lightgbm_tpu_torch.utils import threefry

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

BASE = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1,
        "prewarm": 0, "histogram_impl": "pallas",
        "use_quantized_grad": "true"}
CPU = {"device_type": "cpu"}
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child")
SAMPLED = {"bagging_fraction": 0.7, "bagging_freq": 1,
           "feature_fraction": 0.7, "feature_fraction_bynode": 0.6}


def _data(n=400, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    X[rng.rand(n) < 0.05, f - 1] = np.nan
    yb = (X[:, 0] + 0.3 * rng.rand(n) > 0.65).astype(np.float32)
    # L2 labels on a 1/8 grid: their f32 mean is exact in any order
    yr = (np.round((X[:, 1] * 2.0 + rng.rand(n)) * 8) / 8).astype(
        np.float32)
    return X, yb, yr


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


def _bits(a):
    return np.asarray(a).view(np.int32)


# ---- the threefry replica ----

@pytest.mark.parametrize("seed", [0, 3, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(1,), (1000,), (65537,), (255, 28)])
def test_threefry_replica_bit_identical(seed, shape):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    assert _key(key) == tkey
    assert [_key(k) for k in jax.random.split(key)] == threefry.split(tkey)
    assert [_key(k) for k in jax.random.split(key, 3)] == \
        threefry.split(tkey, 3)
    for data in (0, 1, 7, 254):
        assert _key(jax.random.fold_in(key, data)) == \
            threefry.fold_in(tkey, data)
    sub = jax.random.split(key)[1]
    tsub = threefry.split(tkey)[1]
    got = threefry.uniform(tsub, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(jax.random.uniform(sub, shape)))
    lvl = threefry.fold_in(tkey, 5)
    np.testing.assert_array_equal(
        _bits(threefry.uniform(lvl, shape).numpy()),
        _bits(jax.random.uniform(jax.random.fold_in(key, 5), shape)))


@pytest.mark.parametrize("minval,maxval", [(-2.0, 3.5), (1e-3, 7.0),
                                           (-1e6, 1e-6), (-3.0, -1.0)])
def test_threefry_uniform_range_bit_identical(minval, maxval):
    # XLA fuses the scale and shift into one rounding; so does the replica
    key = jax.random.PRNGKey(11)
    got = threefry.uniform(threefry.prng_key(11), (100_000,), "cpu", minval,
                           maxval)
    np.testing.assert_array_equal(
        _bits(got.numpy()),
        _bits(jax.random.uniform(key, (100_000,), minval=minval,
                                 maxval=maxval)))


# ---- bag, feature and bynode masks ----

def _boosters(params, X, y):
    ref = lgb.Booster(params=params,
                      train_set=lgb.Dataset(X, label=y, params=params))
    pt = dict(params, **CPU)
    port = lt.Booster(params=pt, train_set=lt.Dataset(X, label=y, params=pt))
    return ref._gbdt, port._gbdt


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.6, "bagging_freq": 1},
    {"bagging_fraction": 0.6, "bagging_freq": 3, "bagging_seed": 9},
    {"pos_bagging_fraction": 0.8, "neg_bagging_fraction": 0.3,
     "bagging_freq": 1},
    {"pos_bagging_fraction": 0.5, "bagging_freq": 3, "seed": 4},
])
def test_bag_masks_bit_identical(extra):
    # exact: the mask of each of 6 iterations (redrawn every bagging_freq)
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", **extra)
    ref, port = _boosters(p, X, yb)
    for it in range(6):
        ref._update_bag(it, None, None)
        port._update_bag(it, None, None)
        np.testing.assert_array_equal(port._bag.numpy(),
                                      np.asarray(ref._bag_mask))
    assert 0.2 < float(port._bag.mean()) < 0.9


def test_no_bagging_without_bagging_freq():
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", bagging_fraction=0.5)
    ref, port = _boosters(p, X, yb)
    ref._update_bag(0, None, None)
    port._update_bag(0, None, None)
    assert ref._bag_mask is None and port._bag_mask is None
    assert bool((port._bag == 1.0).all())


@pytest.mark.parametrize("extra", [{"feature_fraction": 0.5},
                                   {"feature_fraction": 0.8, "seed": 3},
                                   {"feature_fraction": 0.01}])
def test_feature_masks_bit_identical(extra):
    X, yb, _ = _data(f=9)
    p = dict(BASE, objective="binary", **extra)
    ref, port = _boosters(p, X, yb)
    for _ in range(5):
        got, want = port._feature_mask().numpy(), np.asarray(
            ref._feature_mask())
        np.testing.assert_array_equal(got, want)
    assert 1 <= got.sum() < 9


def _ref_node_mask(base, ff, qseed, tag):
    # the reference's draw (lightgbm_tpu/ops/grow.py:227-234, the same
    # scheme as grow_depthwise.py:360-367)
    key = jax.random.fold_in(jax.random.PRNGKey(qseed), tag)
    u = jax.random.uniform(key, base.shape)
    u_allowed = jnp.where(base, u, -1.0)
    best = u_allowed >= u_allowed.max(axis=-1, keepdims=True)
    return np.asarray(base & ((u < ff) | best))


@pytest.mark.parametrize("ff", [0.3, 0.8])
def test_bynode_masks_per_level_and_split_bit_identical(ff):
    # depthwise: [L, F] a level, tag = the level; lossguide: the root [F]
    # under tag L and the two children [2, F] of step t under tag t
    rng = np.random.RandomState(1)
    gp = GrowParams(num_leaves=15, ff_bynode=ff)
    base = rng.rand(11) < 0.7
    tb = torch.from_numpy(base)
    for qseed in (0, 2, 9):
        for lvl in range(4):
            got = node_feature_mask(tb.expand(15, 11), gp, qseed, lvl)
            want = _ref_node_mask(jnp.broadcast_to(jnp.asarray(base),
                                                   (15, 11)), ff, qseed, lvl)
            np.testing.assert_array_equal(got.numpy(), want)
            assert bool(got.any(dim=1).all())
        np.testing.assert_array_equal(
            node_feature_mask(tb, gp, qseed, 15).numpy(),
            _ref_node_mask(jnp.asarray(base), ff, qseed, 15))
        for t in range(3):
            np.testing.assert_array_equal(
                node_feature_mask(tb.expand(2, 11), gp, qseed, t).numpy(),
                _ref_node_mask(jnp.broadcast_to(jnp.asarray(base), (2, 11)),
                               ff, qseed, t))
    assert node_feature_mask(tb, GrowParams(), 0, 0) is tb


def test_goss_weights_bit_identical():
    # exact: GOSS's row weights from the same gradients (ties included),
    # over three draws of one key chain
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", boosting="goss", top_rate=0.25,
             other_rate=0.15)
    ref, port = _boosters(p, X, yb)
    rng = np.random.RandomState(2)
    for it in range(3):
        g = np.round(rng.randn(400), 1).astype(np.float32)
        h = (rng.rand(400) + 0.5).astype(np.float32)
        ref._update_bag(it, jnp.asarray(g), jnp.asarray(h))
        port._update_bag(it, torch.from_numpy(g), torch.from_numpy(h))
        want = np.asarray(ref._bag_mask)
        np.testing.assert_array_equal(port._bag.numpy(), want)
        assert (want == 1.0).sum() >= 100 and (want > 1.0).sum() == 60


# ---- trees against the reference ----

def _train_pair(params, X, y, rounds=3):
    ref = lgb.train(params, lgb.Dataset(X, label=y, params=params),
                    num_boost_round=rounds)
    pt = dict(params, **CPU)
    port = lt.train(pt, lt.Dataset(X, label=y, params=pt),
                    num_boost_round=rounds)
    return ref, port


def _assert_models_match(ref, port, X, objective, rounds=3):
    """L2: every tree's structure exact, leaf values and predictions within
    the stated tolerance. Binary: the first tree's (later ones inherit the
    logloss exp gap of queue C1, which moves int8 gains; a bagged GOSS
    binary model's third tree picks bin 137 where the reference picks 144
    at a split gain of 2.3e-4 against 2.0e-4), and the predictions of that
    tree."""
    rt, ptr = ref._gbdt.finalize(), port._host_trees()
    assert len(rt) == len(ptr) == rounds
    exact = rounds if objective == "regression" else 1
    for a, b in zip(rt[:exact], ptr[:exact]):
        assert b.num_leaves > 2
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=name)
        np.testing.assert_allclose(
            b.leaf_value, a.leaf_value, rtol=1e-4,
            atol=1e-4 * float(np.abs(a.leaf_value).max()))
    want = ref.predict(X, num_iteration=exact, raw_score=True)
    np.testing.assert_allclose(
        port.predict(X, num_iteration=exact, raw_score=True), want,
        rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    np.testing.assert_allclose(port.predict(X, num_iteration=exact),
                               ref.predict(X, num_iteration=exact), rtol=1e-4)


PATHS = {
    "fused63": ({"max_bin": 63}, False),
    "unfused255": ({"max_bin": 255, "num_leaves": 15}, True),
    "f32": ({"max_bin": 255, "num_leaves": 15,
             "use_quantized_grad": "false"}, True),
    "lossguide": ({"max_bin": 255, "num_leaves": 15,
                   "grow_policy": "lossguide"}, True),
}


def _path_data(wide):
    # 600 uniform rows on 9 features reach B = 256 at max_bin=255 and
    # F * B > 2048 (the unfused path); 400 rows on 6 features stay fused
    return _data(600, 9, seed=5) if wide else _data()


@pytest.mark.parametrize("objective", ["regression", "binary"])
@pytest.mark.parametrize("path", list(PATHS))
def test_sampled_paths_match_reference(path, objective):
    extra, wide = PATHS[path]
    X, yb, yr = _path_data(wide)
    y = yr if objective == "regression" else yb
    p = dict(BASE, objective=objective, **extra, **SAMPLED)
    ref, port = _train_pair(p, X, y)
    gp = port._gbdt.gp
    assert gp.ff_bynode == 0.6
    assert (gp.fused_obj is not None) == (path == "fused63")
    np.testing.assert_array_equal(port._gbdt._bag.numpy(),
                                  np.asarray(ref._gbdt._bag_mask))
    _assert_models_match(ref, port, X, objective)


@pytest.mark.parametrize("objective", ["regression", "binary"])
@pytest.mark.parametrize("max_bin", [63, 255])
def test_goss_matches_reference(max_bin, objective):
    X, yb, yr = _path_data(max_bin == 255)
    y = yr if objective == "regression" else yb
    p = dict(BASE, objective=objective, boosting="goss", max_bin=max_bin,
             num_leaves=15 if max_bin == 255 else 7, top_rate=0.3,
             other_rate=0.2)
    ref, port = _train_pair(p, X, y)
    np.testing.assert_array_equal(port._gbdt._bag.numpy(),
                                  np.asarray(ref._gbdt._bag_mask))
    _assert_models_match(ref, port, X, objective)


@pytest.mark.parametrize("max_bin", [63, 255])
def test_goss_takes_the_unfused_front_with_three_channels(monkeypatch,
                                                          max_bin):
    # GOSS hands the step materialized gradients: grad_quant_hist0 and
    # leaf_sums_grad never run, even at max_bin=63; the root is a hist_q8
    # pass, each level hist_routed_fused (F * B <= 2048) or route_level +
    # hist_q8, the renewal leaf_sums; and L2's constant hessian is not
    # elided, so every histogram pass gets the hessian channel
    calls = {k: 0 for k in hk.KERNELS}
    seen_h = []
    for name in hk.KERNELS:
        fn = getattr(hk, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            if _name in ("hist_q8", "hist_routed_fused"):
                seen_h.append(args[2] is not None)
            return _fn(*args, **kw)
        monkeypatch.setattr(hk, name, spy)
    X, _, yr = _path_data(max_bin == 255)
    p = dict(BASE, objective="regression", boosting="goss", max_bin=max_bin,
             **CPU)
    bst = lt.train(p, lt.Dataset(X, label=yr, params=p), num_boost_round=2)
    gp = bst._gbdt.gp
    assert gp.quant and gp.fused_obj is None and not gp.const_hess
    passes = sum(bst._gbdt.hist_passes)
    expected = {"hist_q8": 2, "hist_routed_fused": passes,
                "leaf_sums": 2, "take_small": 2}
    if max_bin == 255:
        expected.update(hist_q8=2 + passes, hist_routed_fused=0,
                        route_level=passes)
    assert passes >= 2
    assert calls == {k: expected.get(k, 0) for k in hk.KERNELS}, calls
    assert len(seen_h) == 2 + passes and all(seen_h)


def test_goss_guard_and_bagging_warning(caplog):
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", boosting="goss", top_rate=0.6,
             other_rate=0.5, **CPU)
    with pytest.raises(LightGBMError, match="top_rate"):
        lt.train(p, lt.Dataset(X, label=yb, params=p), num_boost_round=1)
    p = dict(BASE, objective="binary", boosting="goss", bagging_freq=1,
             bagging_fraction=0.5, **CPU)
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        bst = lt.train(p, lt.Dataset(X, label=yb, params=p),
                       num_boost_round=1)
    assert "cannot use bagging in GOSS" in caplog.text
    assert bst.num_trees() == 1


def test_bagging_keeps_out_of_bag_rows_out_of_the_tree():
    # the root's count is the in-bag row count, and every out-of-bag row
    # still gets its score update (leaf ids route all rows)
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", bagging_fraction=0.5, bagging_freq=1,
             **CPU)
    bst = lt.train(p, lt.Dataset(X, label=yb, params=p), num_boost_round=1)
    tree = bst._host_trees()[0]
    in_bag = float(bst._gbdt._bag.sum())
    assert tree.internal_count[0] == in_bag < 400
    raw = bst.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, bst._gbdt.train_score.numpy(),
                               rtol=1e-6)
