"""Multiclass models of the PyTorch/CUDA port (lightgbm_tpu_torch), K trees
an iteration, against the JAX reference (lightgbm_tpu), on the CPU.

The reference trains on its Pallas kernels in interpret mode
(histogram_impl=pallas), the port with device_type="cpu", as in
tests/test_torch_train.py. K = 3 classes from the features plus noise.

Exact: the structure of the first iteration's K trees of 3-iteration
softmax and one-vs-all models, with and without row weights, at
max_bin=63 and 255, and with bagging; the tree count when class trees stop
splitting (stumps are kept inside an iteration, and an iteration of K
stumps ends training); leaf indices of those trees; the model text's
header, the class of every tree, and a port model's save/load round trip
(text and predictions bit for bit). Tolerances: leaf values of the first
iteration rtol 1e-4 plus 1e-4 of the largest leaf (ROADMAP.md C2), raw
scores and probabilities after 3 iterations rtol 1e-4 plus 1e-4 of the
largest; a model text read by the other package predicts within rtol 1e-6
(the reference sums leaf values in f32, the port in f64); softmax rows sum
to 1 within 1e-12.
"""
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from test_torch_objectives import BASE, CPU, STRUCT, assert_models_match
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

K = 3
SAMPLED = {"bagging_fraction": 0.7, "bagging_freq": 1,
           "feature_fraction": 0.8}


def _data(max_bin=63, seed=0):
    n, f = (400, 6) if max_bin == 63 else (600, 9)
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    X[rng.rand(n) < 0.05, f - 1] = np.nan
    s = X[:, 0] + 0.6 * X[:, 1] + 0.5 * rng.rand(n)
    y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float32)
    w = (rng.randint(2, 9, n) / 4).astype(np.float32)
    return X, y, w


def _train(params, X, y, w=None, rounds=3):
    ref = lgb.train(params, lgb.Dataset(X, label=y, weight=w, params=params),
                    num_boost_round=rounds)
    pt = dict(params, **CPU)
    port = lt.train(pt, lt.Dataset(X, label=y, weight=w, params=pt),
                    num_boost_round=rounds)
    return ref, port


CASES = [(obj, weighted, mb) for obj in ("multiclass", "multiclassova")
         for weighted, mb in ((False, 63), (True, 63), (False, 255),
                              (True, 255))]


@pytest.fixture(scope="module")
def models():
    out = {}
    for obj, weighted, mb in CASES:
        X, y, w = _data(mb)
        p = dict(BASE, objective=obj, num_class=K, max_bin=mb)
        out[obj, weighted, mb] = (X, y) + _train(p, X, y,
                                                 w if weighted else None)
    return out


@pytest.mark.parametrize("obj,weighted,max_bin", CASES)
def test_models_match_reference(models, obj, weighted, max_bin):
    X, y, ref, port = models[obj, weighted, max_bin]
    assert port.num_model_per_iteration() == K
    assert port.num_trees() == ref.num_trees() == 3 * K
    assert port.current_iteration == 3
    gb = port._gbdt
    assert tuple(gb.train_score.shape) == (X.shape[0], K)
    # K > 1 leaves the fused front; no const-hessian elision
    assert gb.gp.fused_obj is None and not gb.gp.const_hess and gb.gp.quant
    assert len(gb.hist_passes) == 3 * K
    assert_models_match(ref, port, X)
    prob, want = port.predict(X), np.asarray(ref.predict(X))
    assert prob.shape == want.shape == (X.shape[0], K)
    np.testing.assert_allclose(prob, want, rtol=1e-4, atol=1e-4)
    if obj == "multiclass":
        np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    # one iteration: the first K trees
    np.testing.assert_allclose(port.predict(X, num_iteration=1),
                               np.asarray(ref.predict(X, num_iteration=1)),
                               rtol=1e-4, atol=1e-4)


def test_pred_leaf_and_class_columns(models):
    X, y, ref, port = models["multiclass", False, 63]
    leaf = port.predict(X, pred_leaf=True)
    assert leaf.shape == (X.shape[0], 3 * K)
    np.testing.assert_array_equal(
        leaf[:, :K], np.asarray(ref.predict(X, pred_leaf=True))[:, :K])
    # tree t adds to class t mod K: column c of the raw score is the sum of
    # leaf values of trees c, c + K, c + 2K
    trees = port._host_trees()
    raw = port.predict(X, raw_score=True)
    for c in range(K):
        s = sum(trees[t].leaf_value[leaf[:, t]] for t in range(c, 3 * K, K))
        np.testing.assert_allclose(raw[:, c], s, rtol=1e-12)


def test_model_text_across_packages_both_ways(models, tmp_path):
    X, y, ref, port = models["multiclass", True, 63]
    text = port.model_to_string()
    head = text.split("\nTree=")[0]
    assert "num_class=3" in head and "num_tree_per_iteration=3" in head
    assert "objective=multiclass num_class:3" in head
    # the port reads the reference's text ...
    got = lt.Booster(model_str=ref.model_to_string(), params=CPU)
    assert got.num_model_per_iteration() == K and got.current_iteration == 3
    np.testing.assert_allclose(got.predict(X), np.asarray(ref.predict(X)),
                               rtol=1e-6, atol=1e-7)
    # ... and the reference the port's
    back = lgb.Booster(model_str=text)
    np.testing.assert_allclose(np.asarray(back.predict(X)), port.predict(X),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(back.predict(X, raw_score=True)),
                               port.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-6)
    # the port's own round trip, through a file, bit for bit
    path = str(tmp_path / "mc.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    np.testing.assert_array_equal(loaded.predict(X), port.predict(X))
    assert loaded.model_to_string() == text
    one = lt.Booster(model_str=port.model_to_string(num_iteration=1),
                     params=CPU)
    assert one.num_trees() == K
    np.testing.assert_array_equal(one.predict(X, raw_score=True),
                                  port.predict(X, raw_score=True,
                                               num_iteration=1))


def test_ova_model_text_carries_sigmoid(models):
    X, y, ref, port = models["multiclassova", False, 63]
    head = port.model_to_string().split("\nTree=")[0]
    assert "objective=multiclassova num_class:3 sigmoid:1" in head
    back = lgb.Booster(model_str=port.model_to_string())
    np.testing.assert_allclose(np.asarray(back.predict(X)), port.predict(X),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("obj", ["multiclass", "multiclassova"])
def test_sampled_multiclass_matches_reference(obj):
    # bagging and feature_fraction draw once an iteration, shared by its K
    # class trees
    X, y, w = _data(63, seed=3)
    p = dict(BASE, objective=obj, num_class=K, max_bin=63, **SAMPLED)
    ref, port = _train(p, X, y)
    np.testing.assert_array_equal(port._gbdt._bag.numpy(),
                                  np.asarray(ref._gbdt._bag_mask))
    assert_models_match(ref, port, X)


@pytest.mark.parametrize("gain,trees", [(2.0, None), (1e9, 0)])
def test_class_stumps_stay_and_an_all_stump_iteration_ends(gain, trees):
    # min_gain_to_split 2.0 leaves some class trees unsplit (stumps) while
    # the others split: every class tree stays, K an iteration. At 1e9 no
    # tree splits: the first iteration is all stumps and is dropped
    X, y, _ = _data(63, seed=5)
    p = dict(BASE, objective="multiclass", num_class=K, max_bin=63,
             min_gain_to_split=gain, learning_rate=0.5)
    ref, port = _train(p, X, y, rounds=4)
    assert port.num_trees() == ref.num_trees()
    assert port.num_trees() % K == 0
    if trees is not None:
        assert port.num_trees() == trees
        np.testing.assert_array_equal(port.predict(X, raw_score=True), 0.0)
        return
    leaves = [t.num_leaves for t in port._host_trees()]
    assert 1 in leaves and max(leaves) > 1, leaves
    assert leaves == [t.num_leaves for t in ref._ensure_host_trees()]
    assert_models_match(ref, port, X)


def test_multiclass_settings_are_checked():
    X, y, _ = _data()
    for p, match in (({"objective": "multiclass"}, "num_class > 1"),
                     ({"objective": "binary", "num_class": 3},
                      "num_class must be 1")):
        p = dict(BASE, **p, **CPU)
        with pytest.raises(lt.basic.LightGBMError, match=match):
            lt.train(p, lt.Dataset(X, label=y, params=p), 1)
