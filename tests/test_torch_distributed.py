"""Data- and feature-parallel training of the PyTorch/CUDA port
(lightgbm_tpu_torch/parallel/) on the CPU: the cases of the reference's
tests/test_distributed.py on the port, with ``virtual_devices(8, "cpu")``
on the port's side and the reference's 8 virtual XLA devices (conftest.py)
on the other.

Both packages run unquantized (the reference's ``use_quantized_grad=auto``
is off on the CPU; ``tests/test_torch_train.py`` holds the quantized
learners). Tolerances are the reference's own: a sharded model's sums
round in another order than the serial one's, so predictions agree
within rtol 1e-3, atol 1e-4 (rtol 1e-4, atol 1e-5 for the grower-level
and feature-parallel cases) and split structure exactly where the
reference asserts it. The reference's ``test_dp_cegb_equals_serial[2]``
fails on its own; the port's CEGB learner is held against the serial
reference instead.
"""
import time

import numpy as np
import pytest
import torch

from sklearn.datasets import make_classification
from sklearn.metrics import roc_auc_score

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models import gbdt as t_gbdt
from lightgbm_tpu_torch.ops.grow import GrowParams, grow_tree
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.parallel.data_parallel import grow_tree_dp
from lightgbm_tpu_torch.parallel.mesh import (make_mesh, shard_rows,
                                              virtual_devices)

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

CPU = {"device_type": "cpu", "use_quantized_grad": False, "prewarm": 0}


@pytest.fixture(autouse=True)
def mesh8():
    with virtual_devices(8, "cpu") as devs:
        yield devs


def _port(p, X, y, rounds, **kw):
    q = {**p, **CPU}
    return lt.train(q, lt.Dataset(X, label=y, params=q), num_boost_round=rounds,
                    verbose_eval=False, **kw)


def _ref(p, X, y, rounds):
    return lgb.train(p, lgb.Dataset(X, label=y), num_boost_round=rounds,
                     verbose_eval=False)


def test_dp_tree_matches_serial():
    """The leaf-wise grower on 8 row shards equals the serial grower (the
    reference's case, at the grower level): structure and leaf ids
    exactly, leaf values within rtol 1e-4, atol 1e-5."""
    mesh = make_mesh(8)
    rng = np.random.RandomState(0)
    n, f, b = 800, 5, 16
    bins = torch.as_tensor(rng.randint(0, b, size=(n, f)).astype(np.uint8))
    g = torch.as_tensor(rng.randn(n).astype(np.float32))
    h = torch.ones(n)
    num_bins = torch.full((f,), b, dtype=torch.int32)
    na_bin = torch.full((f,), 256, dtype=torch.int32)
    fmask = torch.ones(f, dtype=torch.bool)
    gp = GrowParams(num_leaves=8, max_bin=b,
                    split=SplitParams(min_data_in_leaf=5))
    tree_s, leaf_s, _, _ = grow_tree(bins.t().contiguous(), g, h, h,
                                     num_bins, na_bin, fmask, gp, bins=bins)
    tree_d, leaf_d, _, _ = grow_tree_dp(
        shard_rows(bins, mesh), shard_rows(g, mesh), shard_rows(h, mesh),
        shard_rows(h, mesh), num_bins, na_bin, fmask, gp, mesh)
    assert tree_s.num_leaves == tree_d.num_leaves
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(tree_s, name).numpy(),
                                      getattr(tree_d, name).numpy())
    np.testing.assert_allclose(tree_s.leaf_value.numpy(),
                               tree_d.leaf_value.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(leaf_s.numpy(),
                                  torch.cat(leaf_d)[:n].numpy())
    # the padding rows of the last shard stay at the root
    assert len(leaf_d) == 8 and all(x.shape[0] == 100 for x in leaf_d)


def test_dp_end_to_end_auc():
    X, y = make_classification(n_samples=1000, n_features=10, random_state=0)
    bst = _port({"objective": "binary", "tree_learner": "data",
                 "num_leaves": 7, "verbosity": -1, "min_data_in_leaf": 5},
                X, y, 20)
    assert bst._gbdt._dp and bst._gbdt._shard_plan.num_shards == 8
    assert roc_auc_score(y, bst.predict(X)) > 0.9


def test_dp_equals_serial_training():
    X, y = make_classification(n_samples=600, n_features=8, random_state=1)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "min_data_in_leaf": 5}
    b1 = _port(p, X, y, 10)
    b2 = _port({**p, "tree_learner": "data"}, X, y, 10)
    np.testing.assert_allclose(b1.predict(X), b2.predict(X), rtol=1e-3,
                               atol=1e-4)
    ref = _ref({**p, "tree_learner": "data"}, X, y, 10)
    np.testing.assert_allclose(b2.predict(X), ref.predict(X), rtol=1e-3,
                               atol=1e-4)


def test_depthwise_serial_and_dp():
    """The depthwise grower, serial and on 8 shards. On the reference's
    data the third tree's level 3 holds a leaf whose best split gains one
    f32 ulp of its parent's gain (7.6e-06 at 96): with the port's shard
    order the split is valid, with the serial order it is not, so the
    models part there (ROADMAP C16). Both models learn (AUC > 0.9) and
    their first two trees are the same; with min_gain_to_split 1e-3, which
    keeps such rounding splits out, the sharded model is within the
    reference's tolerance of the serial one and of the reference's
    sharded model."""
    X, y = make_classification(n_samples=900, n_features=8, random_state=2)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 5, "grow_policy": "depthwise"}
    b1 = _port(p, X, y, 10)
    assert roc_auc_score(y, b1.predict(X)) > 0.9
    b2 = _port({**p, "tree_learner": "data"}, X, y, 10)
    assert roc_auc_score(y, b2.predict(X)) > 0.9
    for ta, tb in list(zip(b1._host_trees(), b2._host_trees()))[:2]:
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.threshold_bin, tb.threshold_bin)
    b3 = lt.Booster(params={"device_type": "cpu"},
                    model_str=b2.model_to_string())
    np.testing.assert_allclose(b2.predict(X), b3.predict(X), rtol=1e-5,
                               atol=1e-6)
    p["min_gain_to_split"] = 1e-3
    b1 = _port(p, X, y, 10)
    b2 = _port({**p, "tree_learner": "data"}, X, y, 10)
    np.testing.assert_allclose(b1.predict(X), b2.predict(X), rtol=1e-3,
                               atol=1e-4)
    ref = _ref({**p, "tree_learner": "data"}, X, y, 10)
    np.testing.assert_allclose(b2.predict(X), ref.predict(X), rtol=1e-3,
                               atol=1e-4)


def test_dp_rides_the_one_step(monkeypatch):
    """The data- and feature-parallel learners grow their trees through
    the serial learner's iteration (``GBDT._grow``; the reference's
    test_dp_rides_fused_path_no_per_tree_sync): no path of their own
    around it, one host read of the leaf count a level as serially."""
    X, y = make_classification(n_samples=800, n_features=8, random_state=3)
    seen = []
    real = t_gbdt.GBDT._grow

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append((self._dp, self._fp, isinstance(out[1], list)))
        return out

    monkeypatch.setattr(t_gbdt.GBDT, "_grow", spy)
    for learner in ("data", "feature"):
        seen.clear()
        p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
             "min_data_in_leaf": 5, "tree_learner": learner, **CPU}
        bst = lt.Booster(params=p,
                         train_set=lt.Dataset(X, label=y, params=p))
        for _ in range(3):
            bst.update()
        assert bst.num_trees() == 3
        want = (True, False, True) if learner == "data" else \
            (False, True, False)
        assert seen == [want] * 3


def test_dp_per_iteration_wallclock_vs_serial():
    """8 virtual shards within 3x (or 0.25 s) of serial per iteration on
    the CPU (the reference's bound)."""
    X, y = make_classification(n_samples=4000, n_features=12, random_state=5)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 5, "grow_policy": "depthwise", **CPU}

    def time_iters(extra, iters=6, warmup=2):
        q = {**p, **extra}
        bst = lt.Booster(params=q, train_set=lt.Dataset(X, label=y,
                                                         params=q))
        for _ in range(warmup):
            bst.update()
        t0 = time.time()
        for _ in range(iters):
            bst.update()
        return (time.time() - t0) / iters

    t_serial = time_iters({})
    t_dp = time_iters({"tree_learner": "data"})
    assert t_dp < max(3.0 * t_serial, t_serial + 0.25), \
        f"dp {t_dp * 1e3:.1f} ms/iter vs serial {t_serial * 1e3:.1f} ms/iter"


def test_feature_parallel_equals_serial():
    """Feature tiles over 8 devices (16 features, 2 a device) equal the
    serial model within rtol 1e-4, atol 1e-5, and the reference's
    feature-parallel model."""
    X, y = make_classification(n_samples=900, n_features=16, random_state=4)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 5}
    b1 = _port(p, X, y, 8)
    b2 = _port({**p, "tree_learner": "feature"}, X, y, 8)
    assert b2._gbdt._fp and b2._gbdt._fmesh.size == 8
    np.testing.assert_allclose(b1.predict(X), b2.predict(X), rtol=1e-4,
                               atol=1e-5)
    assert roc_auc_score(y, b2.predict(X)) > 0.9
    ref = _ref({**p, "tree_learner": "feature"}, X, y, 8)
    np.testing.assert_allclose(b2.predict(X), ref.predict(X), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.slow
def test_dp_equals_serial_training_1m():
    """Data-parallel == serial tree structure at 1M rows on 8 virtual
    shards (the reference's slow case, with its tolerances)."""
    rng = np.random.RandomState(11)
    n, f = 1_000_000, 20
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(6)
    logits = X[:, :6] @ w + 0.4 * X[:, 6] * X[:, 7]
    y = (rng.rand(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "min_data_in_leaf": 20, "max_bin": 63}
    b1 = _port(p, X, y, 3)
    b2 = _port({**p, "tree_learner": "data"}, X, y, 3)
    t1, t2 = b1._host_trees(), b2._host_trees()
    assert len(t1) == len(t2) == 3
    for a, b in zip(t1, t2):
        assert a.num_leaves == b.num_leaves
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=2e-2,
                                   atol=5e-4)
    sub = X[::100]
    np.testing.assert_allclose(b1.predict(sub), b2.predict(sub), rtol=1e-3,
                               atol=1e-4)


def test_dp_with_efb_equals_serial_with_efb():
    rng = np.random.RandomState(5)
    n = 3000
    X = np.zeros((n, 9))
    for g in range(3):
        pick = rng.choice(3, n, p=[0.6, 0.3, 0.1])
        X[np.arange(n), g * 3 + pick] = rng.rand(n) * (g + 1) + 0.5
    w = np.array([1.0, -0.7, 0.4, 0.9, -0.3, 0.2, 0.6, -0.8, 0.1])
    y = (X @ w + 0.1 * rng.randn(n) > 0.5).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 5, "sparse_threshold": 0.5}
    b1 = _port(p, X, y, 8)
    assert b1._gbdt.train_set.bundle_meta is not None, "expected EFB bundles"
    b2 = _port({**p, "tree_learner": "data"}, X, y, 8)
    assert b2._gbdt.train_set.bundle_meta is not None and b2._gbdt._dp
    np.testing.assert_allclose(b1.predict(X), b2.predict(X), rtol=1e-3,
                               atol=1e-4)
    for a, b in zip(b1._host_trees(), b2._host_trees()):
        assert a.num_leaves == b.num_leaves


def _exact_until_near_tie(ref_trees, port_trees) -> bool:
    """Every tree equal in structure (leaf values within rtol 1e-4, C2)
    up to the first node where the two models choose other splits, whose
    gains must then be a near tie (within 1e-5 relative, ten tie bands of
    ``best_split``: another summation order may rank them otherwise, ROADMAP
    C16); the trees after it are not compared. Returns whether such a
    node was met."""
    for ta, tb in zip(ref_trees, port_trees):
        same = (np.array_equal(ta.split_feature, tb.split_feature)
                and np.array_equal(ta.threshold_bin, tb.threshold_bin))
        if not same:
            j = int(np.flatnonzero(
                (ta.split_feature != tb.split_feature)
                | (ta.threshold_bin != tb.threshold_bin))[0])
            np.testing.assert_array_equal(ta.split_feature[:j],
                                          tb.split_feature[:j])
            np.testing.assert_allclose(tb.split_gain[j], ta.split_gain[j],
                                       rtol=1e-5)
            return True
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=1e-4,
                                   atol=1e-7)
    return False


@pytest.mark.parametrize("num_shards", [1, 2, 8])
def test_dp_cegb_equals_serial(num_shards):
    """CEGB under the data-parallel learner: the lazy bitset in row blocks
    on the shards, the penalties' sums over the shards. Held against the
    serial reference: structure exactly, leaf values within rtol 1e-4
    (ROADMAP C2: the port's serial leaf values are within 2.1e-05 of the
    reference's here), predictions rtol 1e-4, atol 1e-6. At 2 shards the
    coupled penalty's fourth tree meets a near tie (gains 17.004372 and
    17.004351, 1.2e-06 apart, just past the tie band) that the 2-shard
    sums rank otherwise, as the reference's own 2-shard case does (one of
    its known failures): there the trees are held exact up to that node
    and the tie is checked."""
    X, y = make_classification(n_samples=800, n_features=5, random_state=7)
    ties = []
    for pen in ({"cegb_penalty_feature_coupled": [50, 100, 10, 25, 30]},
                {"cegb_penalty_feature_lazy": [1, 2, 3, 4, 5]},
                {"cegb_penalty_split": 1.0}):
        p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
             "min_data_in_leaf": 5, "grow_policy": "depthwise",
             "histogram_impl": "scatter", "cegb_tradeoff": 0.5, **pen}
        ref = _ref(p, X, y, 8)
        b2 = _port({**p, "tree_learner": "data", "num_shards": num_shards},
                   X, y, 8)
        gb = b2._gbdt
        assert gb._dp
        if "cegb_penalty_feature_lazy" in pen:
            assert isinstance(gb.cegb.data_used, list)
            assert len(gb.cegb.data_used) == gb._shard_plan.num_shards
        if _exact_until_near_tie(ref._gbdt.finalize(), b2._host_trees()):
            ties.append(next(iter(pen)))
        else:
            np.testing.assert_allclose(ref.predict(X), b2.predict(X),
                                       rtol=1e-4, atol=1e-6)
        b0 = _port({k: v for k, v in p.items() if not k.startswith("cegb")},
                   X, y, 8)
        assert b0.model_to_string() != b2.model_to_string(), pen
    assert ties == (["cegb_penalty_feature_coupled"] if num_shards == 2
                    else [])


@pytest.mark.parametrize("num_shards", [1, 2, 8])
def test_dp_lossguide_bynode_matches_serial(num_shards):
    """feature_fraction_bynode with the leaf-wise grower under the
    data-parallel learner: the per-node draws match the serial model's
    (structure exactly, leaf values rtol 1e-5, atol 1e-7) and vary from
    tree to tree."""
    X, y = make_classification(n_samples=600, n_features=8, random_state=9)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 5, "grow_policy": "lossguide",
         "feature_fraction_bynode": 0.5}
    b1 = _port(p, X, y, 5)
    b2 = _port({**p, "tree_learner": "data", "num_shards": num_shards},
               X, y, 5)
    for ta, tb in zip(b1._host_trees(), b2._host_trees()):
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.threshold_bin, tb.threshold_bin)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=1e-5,
                                   atol=1e-7)
    roots = [int(t.split_feature[0]) for t in b1._host_trees()]
    assert len(set(roots)) > 1, f"sampling seed frozen across trees: {roots}"
