"""The other boosters of the PyTorch/CUDA port (lightgbm_tpu_torch) against
the JAX reference (lightgbm_tpu), on the CPU: DART, RF, Dataset init
scores, continued training from an init model, Booster.refit and a valid
set added after training started.

The reference trains on its Pallas kernels in interpret mode
(histogram_impl=pallas), the port with device_type="cpu". Labels of the L2
models lie on a 1/8 grid, so their gradients and init scores are exact.

Exact: DART's drop lists and tree weights (numpy RandomState(drop_seed) in
both), the structure of every tree of DART and RF models, RF's bagging
refusal, its constant gradients (L2) and running-mean scores, the model
text's average_output line, the structures of continued models. Tolerances:
leaf values and predictions rtol 1e-4 plus 1e-4 of the largest (C2);
scores that sum trees in another order (the reference's init-model score
is a dense f32 contraction, the port's a tree-by-tree f32 sum; across
packages the reference predicts in f32, the port in f64) within 1e-6 of
the largest; refit's leaf values within 1e-6 of the largest (the binary
gradients' exp, C1). The reference's valid sets see no init model's
score; the port's replay it, so a continued valid score is compared with
the reference's plus the init model's raw prediction.
"""
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt

from test_torch_objectives import BASE, CPU, STRUCT
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

# xgboost_dart_mode weighs drops by 1 - tree weight, which is 0 for every
# tree until one was dropped, so it runs on uniform drops here (see
# test_weighted_xgboost_dart_drop_fails_as_in_reference)
DART_CASES = {"default": {}, "uniform": {"uniform_drop": True},
              "xgboost": {"xgboost_dart_mode": True, "uniform_drop": True,
                          "drop_rate": 0.3}}
RF = {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1,
      "feature_fraction": 0.8}


def _data(n=500, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 6).astype(np.float32)
    s = X[:, 0] + 0.6 * X[:, 1] - 0.4 * X[:, 2] + 0.3 * rng.randn(n)
    yb = (s > np.median(s)).astype(np.float32)
    yr = (np.round(s * 16) / 8).astype(np.float32)
    return X, yb, yr


def _structs_equal(ref_trees, port_trees):
    assert len(ref_trees) == len(port_trees)
    for i, (a, b) in enumerate(zip(ref_trees, port_trees)):
        assert a.num_leaves == b.num_leaves, i
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=f"tree {i} {name}")


def _near(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def _boosters(params, X, y, **ds_kw):
    ref = lgb.Booster(params=params,
                      train_set=lgb.Dataset(X, label=y, params=params,
                                            **ds_kw))
    pt = dict(params, **CPU)
    port = lt.Booster(params=pt, train_set=lt.Dataset(X, label=y, params=pt,
                                                      **ds_kw))
    return ref, port


@pytest.mark.parametrize("case", list(DART_CASES))
@pytest.mark.parametrize("obj", ["binary", "regression"])
def test_dart_matches_reference(case, obj):
    X, yb, yr = _data()
    p = dict(BASE, objective=obj, boosting="dart", **DART_CASES[case])
    ref, port = _boosters(p, X, yb if obj == "binary" else yr)
    drops = []
    for _ in range(6):
        ref.update()
        port.update()
        assert port._gbdt.drop_idx == ref._gbdt._drop_idx
        drops.append(list(port._gbdt.drop_idx))
        assert port._gbdt.tree_weights == ref._gbdt.tree_weights
    assert any(drops), "no iteration dropped a tree"
    _structs_equal(ref._ensure_host_trees(), port._host_trees())
    _near(port._gbdt.train_score.numpy(), np.asarray(ref._gbdt.train_score))
    want = np.asarray(ref.predict(X, raw_score=True))
    _near(port.predict(X, raw_score=True), want)
    # the rescaled trees and the train score agree
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               port._gbdt.train_score.numpy(), rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_weighted_xgboost_dart_drop_fails_as_in_reference():
    # all weights are 1 before the first drop: the drop probabilities
    # 1 - w are all 0 and numpy's choice refuses them, in both packages
    # (ROADMAP.md C7)
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", boosting="dart",
             xgboost_dart_mode=True, skip_drop=0.0)
    ref, port = _boosters(p, X, yb)
    ref.update()
    port.update()
    for b in (ref, port):
        with pytest.raises(ValueError, match="probabilities do not sum"):
            b.update()


def test_dart_model_text_across_packages():
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", boosting="dart")
    ref = lgb.train(p, lgb.Dataset(X, label=yb, params=p), 5)
    pt = dict(p, **CPU)
    port = lt.train(pt, lt.Dataset(X, label=yb, params=pt), 5)
    back = lgb.Booster(model_str=port.model_to_string())
    np.testing.assert_allclose(np.asarray(back.predict(X)), port.predict(X),
                               rtol=1e-6, atol=1e-7)
    got = lt.Booster(model_str=ref.model_to_string(), params=CPU)
    np.testing.assert_allclose(got.predict(X), np.asarray(ref.predict(X)),
                               rtol=1e-6, atol=1e-7)


def test_dart_iteration_ending_in_stumps_matches_reference():
    # y is a step in x0 and the learning rate 1, so the first tree fits it.
    # The second iteration drops the first tree and grows it again; the
    # third drops one of the two half-weight trees, and the residual's best
    # gain (n/4) falls below min_gain_to_split (0.6 n): a stump, which ends
    # training. Both packages normalize that iteration (the stump weighed
    # in the scores, the dropped tree rescaled and put back) before the
    # stump leaves the model, so the train and valid scores, the metrics
    # and the model agree with the reference's 3-round run
    rng = np.random.RandomState(0)
    X = rng.rand(500, 4).astype(np.float32)
    y = (2.0 * (X[:, 0] > 0.5)).astype(np.float32)
    Xv = rng.rand(200, 4).astype(np.float32)
    yv = (2.0 * (Xv[:, 0] > 0.5)).astype(np.float32)
    p = dict(BASE, objective="regression", boosting="dart", skip_drop=0.0,
             learning_rate=1.0, num_leaves=2, min_gain_to_split=0.6 * 500,
             metric="l2")
    pt = dict(p, **CPU)
    res_ref, res_port = {}, {}
    ds = lgb.Dataset(X, label=y, params=p)
    ref = lgb.train(p, ds, 3, valid_sets=[lgb.Dataset(
        Xv, label=yv, reference=ds, params=p)], evals_result=res_ref,
        keep_training_booster=True)
    dt = lt.Dataset(X, label=y, params=pt)
    port = lt.train(pt, dt, 3, valid_sets=[lt.Dataset(
        Xv, label=yv, reference=dt, params=pt)], evals_result=res_port,
        keep_training_booster=True)
    assert port._gbdt.drop_idx == ref._gbdt._drop_idx == [1]
    assert [t.num_leaves for t in port._host_trees()] == [2, 2]
    _structs_equal(ref._ensure_host_trees(), port._host_trees())
    assert port._gbdt.tree_weights == ref._gbdt.tree_weights[:2] \
        == [0.5, 0.25]
    _near(port._gbdt.train_score.numpy(), np.asarray(ref._gbdt.train_score))
    _near(port._gbdt.valid_scores[0].numpy(),
          np.asarray(ref._gbdt.valid_scores[0]))
    _near(res_port["valid_0"]["l2"], res_ref["valid_0"]["l2"])
    _near(port.predict(Xv, raw_score=True),
          np.asarray(ref.predict(Xv, raw_score=True)))


@pytest.mark.parametrize("extra", [{}, {"bagging_fraction": 1.0},
                                   {"bagging_freq": 0}])
def test_rf_needs_bagging_or_feature_fraction(extra):
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", boosting="rf", **extra)
    for pkg, pp in ((lgb, p), (lt, dict(p, **CPU))):
        with pytest.raises(Exception, match="RF mode requires bagging"):
            pkg.train(pp, pkg.Dataset(X, label=yb, params=pp), 1)


@pytest.mark.parametrize("obj", ["binary", "regression"])
def test_rf_matches_reference(obj):
    X, yb, yr = _data()
    y = yb if obj == "binary" else yr
    p = dict(BASE, objective=obj, **RF)
    ref, port = _boosters(p, X, y)
    for _ in range(3):
        ref.update()
        port.update()
    # the gradients are taken once, at the init score
    for a, b in zip(port._gbdt._const_gh, ref._gbdt._const_gh):
        if obj == "regression":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _near(a.numpy(), b, 1e-6)
    _structs_equal(ref._ensure_host_trees(), port._host_trees())
    for t in port._host_trees():
        assert t.shrinkage == 1.0
    score = port._gbdt.train_score.numpy()
    _near(score, np.asarray(ref._gbdt.train_score))
    # the train score is the running mean of the trees
    raw = port.predict(X, raw_score=True)
    np.testing.assert_allclose(score, raw, rtol=0,
                               atol=1e-6 * np.abs(raw).max())
    _near(raw, np.asarray(ref.predict(X, raw_score=True)))


def test_rf_average_output_model_text_both_ways(tmp_path):
    X, yb, _ = _data()
    Xv = _data(200, seed=3)[0]
    p = dict(BASE, objective="binary", **RF)
    ref = lgb.train(p, lgb.Dataset(X, label=yb, params=p), 3)
    pt = dict(p, **CPU)
    ds = lt.Dataset(X, label=yb, params=pt)
    vs = lt.Dataset(Xv, label=yb[:200], reference=ds, params=pt)
    port = lt.train(pt, ds, 3, valid_sets=[vs], verbose_eval=False)
    text = port.model_to_string()
    assert "\naverage_output\n" in text.split("\nTree=")[0]
    # valid scores are running means too
    np.testing.assert_allclose(port._gbdt.valid_scores[0].numpy(),
                               port.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-6)
    back = lgb.Booster(model_str=text)
    np.testing.assert_allclose(np.asarray(back.predict(X)), port.predict(X),
                               rtol=1e-6, atol=1e-7)
    got = lt.Booster(model_str=ref.model_to_string(), params=CPU)
    assert got.average_output()
    np.testing.assert_allclose(got.predict(X), np.asarray(ref.predict(X)),
                               rtol=1e-6, atol=1e-7)
    path = str(tmp_path / "rf.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    np.testing.assert_array_equal(loaded.predict(X), port.predict(X))
    assert loaded.model_to_string() == text


@pytest.mark.parametrize("obj", ["binary", "regression"])
def test_init_score_matches_reference(obj):
    X, yb, yr = _data()
    y = yb if obj == "binary" else yr
    init = (np.round(np.random.RandomState(1).randn(len(y)) * 4) / 8
            ).astype(np.float32)
    Xv = _data(200, seed=2)[0]
    vinit = init[:200]
    p = dict(BASE, objective=obj)
    out = {}
    for pkg, pp in ((lgb, p), (lt, dict(p, **CPU))):
        ds = pkg.Dataset(X, label=y, init_score=init, params=pp)
        vs = pkg.Dataset(Xv, label=y[:200], init_score=vinit, reference=ds,
                         params=pp)
        out[pkg] = pkg.train(pp, ds, 3, valid_sets=[vs], verbose_eval=False)
    ref, port = out[lgb], out[lt]
    # no boosting from the average with an init score
    assert port._gbdt.init_scores == [0.0]
    _structs_equal(ref._ensure_host_trees(), port._host_trees())
    _near(port._gbdt.train_score.numpy(), np.asarray(ref._gbdt.train_score))
    _near(port._gbdt.valid_scores[0].numpy(),
          np.asarray(ref._gbdt.valid_scores[0]))
    np.testing.assert_array_equal(
        port.train_set.get_init_score(), init)


def test_init_model_matches_reference(tmp_path):
    X, yb, _ = _data()
    Xv, yv, _ = _data(200, seed=2)
    p = dict(BASE, objective="binary")
    pt = dict(p, **CPU)
    first = lgb.train(p, lgb.Dataset(X, label=yb, params=p), 2)
    path = str(tmp_path / "first.txt")
    first.save_model(path)
    out = {}
    for pkg, pp in ((lgb, p), (lt, pt)):
        ds = pkg.Dataset(X, label=yb, params=pp)
        vs = pkg.Dataset(Xv, label=yv, reference=ds, params=pp)
        out[pkg] = pkg.train(pp, ds, 2, init_model=path, valid_sets=[vs],
                             verbose_eval=False)
    ref, port = out[lgb], out[lt]
    # the returned model holds the new trees; with the init model's they
    # give the train score
    assert port.num_trees() == ref.num_trees() == 2
    _structs_equal(ref._ensure_host_trees(), port._host_trees())
    old = np.asarray(first.predict(X, raw_score=True))
    score = port._gbdt.train_score.numpy()
    np.testing.assert_allclose(old + port.predict(X, raw_score=True), score,
                               rtol=0, atol=1e-6 * np.abs(score).max())
    _near(score, np.asarray(ref._gbdt.train_score))
    # the valid set replays the init model (the reference's does not)
    vold = np.asarray(first.predict(Xv, raw_score=True))
    _near(port._gbdt.valid_scores[0].numpy(),
          np.asarray(ref._gbdt.valid_scores[0]) + vold)
    # a Booster as init model continues the same way
    port2 = lt.train(pt, lt.Dataset(X, label=yb, params=pt), 2,
                     init_model=lt.Booster(model_file=path, params=CPU))
    np.testing.assert_array_equal(port2.predict(X), port.predict(X))


def test_init_model_equals_init_score():
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", **CPU)
    first = lt.train(p, lt.Dataset(X, label=yb, params=p), 2)
    a = lt.train(p, lt.Dataset(X, label=yb, params=p), 2, init_model=first)
    b = lt.train(p, lt.Dataset(
        X, label=yb, params=p,
        init_score=first.predict(X, raw_score=True)), 2)
    _structs_equal(a._host_trees(), b._host_trees())
    _near(a.predict(X, raw_score=True), b.predict(X, raw_score=True), 1e-6)


@pytest.mark.parametrize("obj", ["binary", "regression"])
def test_refit_matches_reference(obj):
    X, yb, yr = _data()
    y = yb if obj == "binary" else yr
    X2, yb2, yr2 = _data(300, seed=4)
    y2 = yb2 if obj == "binary" else yr2
    p = dict(BASE, objective=obj, lambda_l2=0.5)
    ref = lgb.train(p, lgb.Dataset(X, label=y, params=p), 3)
    port = lt.Booster(model_str=ref.model_to_string(), params=dict(p, **CPU))
    r2 = ref.refit(X2, y2, decay_rate=0.9)
    p2 = port.refit(X2, y2, decay_rate=0.9)
    rt, pt_ = r2._ensure_host_trees(), p2._host_trees()
    _structs_equal(rt, pt_)
    for a, b in zip(rt, pt_):
        assert np.isfinite(b.leaf_value).all()
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6 * np.abs(a.leaf_value).max())
    # the default decay comes from refit_decay_rate, and the original
    # model is left as it was
    before = port.predict(X)
    p3 = port.refit(X2, y2)
    np.testing.assert_array_equal(port.predict(X), before)
    assert not np.array_equal(p3.predict(X), before)


def test_late_valid_set_matches_reference():
    X, yb, _ = _data()
    Xv, yv, _ = _data(200, seed=2)
    p = dict(BASE, objective="binary", metric="auc")
    ref, port = _boosters(p, X, yb)
    for _ in range(2):
        ref.update()
        port.update()
    ref.add_valid(lgb.Dataset(Xv, label=yv, reference=ref.train_set,
                              params=p), "late")
    port.add_valid(lt.Dataset(Xv, label=yv, reference=port.train_set,
                              params=dict(p, **CPU)), "late")
    # the trees so far replayed on the valid bins
    _near(port._gbdt.valid_scores[0].numpy(),
          np.asarray(ref._gbdt.valid_scores[0]))
    ref.update()
    port.update()
    _near(port._gbdt.valid_scores[0].numpy(),
          np.asarray(ref._gbdt.valid_scores[0]))
    np.testing.assert_allclose(port.predict(Xv, raw_score=True),
                               port._gbdt.valid_scores[0].numpy(), rtol=0,
                               atol=1e-6)
    (name, metric, val, _), = port.eval_valid()
    assert (name, metric) == ("late", "auc")
    np.testing.assert_allclose(val, ref.eval_valid()[0][2], rtol=1e-6)
