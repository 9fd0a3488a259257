"""The port's API surface (A15a) against the JAX reference's methods on the
same data, on the CPU: the Dataset methods (create_valid, subset, the
setters, add_features_from, save_binary / load_binary), the Booster
methods (rollback_one_iter, raw_train_score, dump_model,
feature_importance, attributes, get_leaf_output,
get_split_value_histogram, trees_to_dataframe, shuffle_models, pickling
and copies), ``cv`` and the scikit-learn style estimators.

Both packages train with the reference's Pallas kernels in interpret mode
(histogram_impl=pallas) and the port's plain versions (device_type="cpu").
Exact: every structure, count, name, fold and ordering, and every number
of the two packages' Boosters loaded from one reference model text; the
first tree of a trained binary model (queue C1).
Tolerance: leaf values, gains, scores, metrics and predictions of trained
models rtol 1e-4 (queue C2), with an absolute 1e-6 for raw scores near 0.
"""
import copy
import dataclasses
import pickle

import numpy as np
import pandas as pd
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.sklearn import (LGBMClassifier as RefClassifier,
                                  LGBMRanker as RefRanker,
                                  LGBMRegressor as RefRegressor)
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.engine import stratified_folds
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 7, "max_bin": 31, "min_data_in_leaf": 5,
        "verbosity": -1, "prewarm": 0, "histogram_impl": "pallas"}
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child")


def _data(n=500, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    X[rng.rand(n) < 0.05, 2] = np.nan
    lat = X[:, 0] * 2 - X[:, 1] + np.nan_to_num(X[:, 2]) + 0.3 * rng.randn(n)
    yb = (lat > np.median(lat)).astype(np.float32)
    yr = (np.round(np.clip(lat, -4, 4) * 8) / 8).astype(np.float32)
    return X, yb, yr


def _close(a, b, path=""):
    """Nested dicts, lists and numbers equal: ints, strings and bools
    exactly, floats rtol 1e-4 with an absolute 1e-6."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def pair():
    """A binary model of 4 iterations in each package, with a valid set,
    and the reference's model text loaded by each package (the text keeps
    6 digits of gains and weights, so the loaded pair compares exactly)."""
    X, yb, _ = _data()
    Xv, ybv, _ = _data(200, seed=1)
    p = dict(BASE, objective="binary")
    rds = lgb.Dataset(X, label=yb, params=p)
    ref = lgb.train(p, rds, 4, valid_sets=[rds.create_valid(Xv, ybv)],
                    verbose_eval=False)
    pt = dict(p, **CPU)
    tds = lt.Dataset(X, label=yb, params=pt)
    port = lt.train(pt, tds, 4, valid_sets=[tds.create_valid(Xv, ybv)],
                    verbose_eval=False)
    text = ref.model_to_string()
    loaded = (lgb.Booster(model_str=text),
              convert.booster_from_model_text(text, CPU))
    return X, Xv, ref, port, loaded


# ---- Booster ----

def test_dump_model_matches_reference(pair):
    # exact on the reference's own model; trained: structures exact for
    # the first tree, the rest within rtol 1e-4
    X, _, ref, port, loaded = pair
    assert loaded[1].dump_model() == loaded[0].dump_model()
    want = ref.dump_model()
    got = port.dump_model()
    assert got["tree_info"][0]["tree_structure"].keys() == \
        want["tree_info"][0]["tree_structure"].keys()
    _close(got, want)
    assert len(port.dump_model(num_iteration=2)["tree_info"]) == 2


def test_trees_to_dataframe_matches_reference(pair):
    X, _, ref, port, loaded = pair
    pd.testing.assert_frame_equal(loaded[1].trees_to_dataframe(),
                                  loaded[0].trees_to_dataframe())
    want = ref.trees_to_dataframe()
    got = port.trees_to_dataframe()
    assert list(got.columns) == list(want.columns)
    for col in ("tree_index", "node_depth", "node_index", "left_child",
                "right_child", "parent_index", "split_feature",
                "decision_type", "missing_direction", "missing_type"):
        assert got[col].tolist() == want[col].tolist(), col
    for col in ("split_gain", "threshold", "value", "weight", "count"):
        np.testing.assert_allclose(got[col].astype(float),
                                   want[col].astype(float), rtol=1e-4,
                                   atol=1e-6, err_msg=col)


@pytest.mark.parametrize("kind", ["split", "gain"])
def test_feature_importance_matches_reference(pair, kind):
    X, _, ref, port, loaded = pair
    want = ref.feature_importance(kind)
    got_loaded, got = (b.feature_importance(kind) for b in (loaded[1], port))
    assert got_loaded.dtype == got.dtype == want.dtype
    np.testing.assert_array_equal(got_loaded,
                                  loaded[0].feature_importance(kind))
    if kind == "split":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("bins,xgb", [(None, False), (4, False), (3, True),
                                      (None, True)])
def test_split_value_histogram_matches_reference(pair, bins, xgb):
    X, _, ref, port, loaded = pair
    for feature in (0, 1, "Column_0"):
        want = loaded[0].get_split_value_histogram(feature, bins=bins,
                                                   xgboost_style=xgb)
        got = loaded[1].get_split_value_histogram(feature, bins=bins,
                                                  xgboost_style=xgb)
        if xgb:
            pd.testing.assert_frame_equal(got, want)
        else:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    hist, _ = port.get_split_value_histogram(0)
    assert hist.sum() == ref.get_split_value_histogram(0)[0].sum()


def test_leaf_output_and_attributes(pair):
    X, _, ref, port, loaded = pair
    for t, leaf in ((0, 0), (2, 3), (3, 1)):
        assert loaded[1].get_leaf_output(t, leaf) == \
            loaded[0].get_leaf_output(t, leaf)
        np.testing.assert_allclose(port.get_leaf_output(t, leaf),
                                   ref.get_leaf_output(t, leaf), rtol=1e-4,
                                   atol=1e-6)
    with pytest.raises(lt.LightGBMError):
        port.get_leaf_output(4, 0)
    b = lt.Booster(model_str=port.model_to_string(), params=CPU)
    assert b.attr("a") is None
    b.set_attr(a="1", b="x")
    assert (b.attr("a"), b.attr("b")) == ("1", "x")
    b.set_attr(a=None)
    assert b.attr("a") is None
    with pytest.raises(ValueError):
        b.set_attr(c=1)


def test_rollback_scores_match_reference():
    # exact against the port's own 2-iteration run within 1e-6 of the
    # largest score; against the reference's rollback rtol 1e-4
    X, _, yr = _data()
    Xv, _, yrv = _data(200, seed=1)
    p = dict(BASE, objective="regression")
    runs = {}
    for pkg, extra in ((lgb, {}), (lt, CPU)):
        pp = dict(p, **extra)
        ds = pkg.Dataset(X, label=yr, params=pp)
        out = []
        for rounds in (3, 2):
            b = pkg.train(pp, ds, rounds,
                          valid_sets=[ds.create_valid(Xv, yrv)],
                          verbose_eval=False)
            out.append(b)
        out[0].rollback_one_iter()
        runs[pkg] = out
    (r3, r2), (p3, p2) = runs[lgb], runs[lt]
    assert p3.current_iteration == 2 and p3.num_trees() == 2
    for got, want in ((p3.raw_train_score(), p2.raw_train_score()),
                      (p3._gbdt.valid_scores[0].numpy(),
                       p2._gbdt.valid_scores[0].numpy())):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(p3.raw_train_score(),
                               np.asarray(r3.raw_train_score()), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(p3._gbdt.valid_scores[0].numpy(),
                               np.asarray(r3._gbdt.valid_scores[0]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(p3.predict(X), p2.predict(X))
    # training goes on from the rolled-back state
    p3.update()
    assert p3.num_trees() == 3


def test_pickle_and_copies_keep_the_whole_model(pair):
    X, _, ref, port, loaded = pair
    port.best_iteration = 2
    port.set_attr(note="kept")
    try:
        for b in (pickle.loads(pickle.dumps(port)), copy.copy(port),
                  copy.deepcopy(port)):
            assert b.num_trees() == port.num_trees() == 4
            assert b.best_iteration == 2 and b.attr("note") == "kept"
            np.testing.assert_array_equal(b.predict(X, num_iteration=-1),
                                          port.predict(X, num_iteration=-1))
            np.testing.assert_array_equal(b.predict(X), port.predict(X))
        state = port.__getstate__()
        assert state.keys() == ref.__getstate__().keys()
        assert state["name_valid_sets"] == ["valid_0"]
    finally:
        port.best_iteration = -1
        port.set_attr(note=None)


def test_shuffle_models_order_matches_reference(pair):
    X, _, ref, port, _ = pair
    text = ref.model_to_string()
    a = lgb.Booster(model_str=text)
    b = convert.booster_from_model_text(text, CPU)
    a.shuffle_models(1, 4)
    b.shuffle_models(1, 4)
    assert [t.leaf_value.tolist() for t in b._host_trees()] == \
        [t.leaf_value.tolist() for t in a._ensure_host_trees()]
    np.testing.assert_allclose(b.predict(X), a.predict(X), rtol=1e-6)
    # a training Booster's device trees follow the new order
    before = [t.leaf_value.tolist() for t in port._host_trees()]
    port.shuffle_models()
    after = [t.leaf_value.tolist() for t in port._host_trees()]
    assert sorted(after) == sorted(before)
    order = [before.index(v) for v in after]
    perm = np.arange(4)
    np.random.RandomState(17).shuffle(perm)
    assert order == perm.tolist()
    port.shuffle_models()
    port.shuffle_models()   # permutations compose; restore is not needed
    dev = port._gbdt.models_dev
    assert [float(t.leaf_value[0]) for t in dev] == pytest.approx(
        [t.leaf_value[0] for t in port._host_trees()])


# ---- Dataset ----

def test_subset_and_setters_train_as_reference():
    # exact: a subset's rows of bins, label and weight; the first tree of
    # a binary model on it; predictions rtol 1e-4
    X, yb, _ = _data()
    idx = np.sort(np.random.RandomState(3).choice(500, 300, replace=False))
    w = np.random.RandomState(4).uniform(0.5, 2, 500).astype(np.float32)
    p = dict(BASE, objective="binary")
    rds = lgb.Dataset(X, label=yb, weight=w, params=p).construct()
    tds = lt.Dataset(X, label=yb, weight=w, params=dict(p, **CPU)).construct()
    rsub, tsub = rds.subset(idx), tds.subset(idx)
    np.testing.assert_array_equal(tsub.bins.numpy(),
                                  np.asarray(rds.bins)[idx])
    np.testing.assert_array_equal(tsub.bins_T.numpy(), tsub.bins.numpy().T)
    np.testing.assert_array_equal(tsub.get_label(), yb[idx])
    np.testing.assert_array_equal(tsub.get_weight(), w[idx])
    ref = lgb.train(p, rsub, 2)
    port = lt.train(dict(p, **CPU), tsub, 2)
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(port._host_trees()[0], name),
                                      getattr(ref._gbdt.finalize()[0], name))
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)
    # setters: a new label and no weight train the model of a Dataset
    # built with them
    yb2 = 1.0 - yb
    tds.set_label(yb2).set_weight(None)
    tds.set_init_score(np.full(500, 0.25, np.float32))
    assert tds.weight is None and float(tds.init_score[0]) == 0.25
    tds.set_init_score(None)
    fresh = lt.Dataset(X, label=yb2, params=dict(p, **CPU))
    a = lt.train(dict(p, **CPU), tds, 2)
    b = lt.train(dict(p, **CPU), fresh, 2)
    np.testing.assert_array_equal(a.predict(X), b.predict(X))


def test_subset_keeps_whole_queries():
    rng = np.random.RandomState(0)
    X = rng.rand(60, 3)
    group = np.array([10, 20, 30])
    p = dict(BASE, objective="lambdarank", **CPU)
    ds = lt.Dataset(X, label=rng.randint(0, 3, 60), group=group,
                    params=p).construct()
    assert ds.subset(np.arange(10, 60)).get_group().tolist() == [20, 30]
    assert ds.subset(np.arange(5, 60)).get_group() is None


def test_add_features_from_trains_as_reference():
    # exact: the merged bins, names and parameters; the first tree;
    # predictions rtol 1e-4
    X, yb, _ = _data(f=6)
    p = dict(BASE, objective="binary")
    out = {}
    for pkg, extra in ((lgb, {}), (lt, CPU)):
        pp = dict(p, **extra)
        a = pkg.Dataset(X[:, :4], label=yb, params=dict(
            pp, monotone_constraints=[1, 0, 0, 0])).construct()
        b = pkg.Dataset(X[:, 4:], label=yb, params=pp).construct()
        a.add_features_from(b)
        out[pkg] = (a, pkg.train(dict(pp, monotone_constraints=a.params[
            "monotone_constraints"]), a, 2))
    (ra, ref), (ta, port) = out[lgb], out[lt]
    np.testing.assert_array_equal(ta.bins.numpy(), np.asarray(ra.bins))
    np.testing.assert_array_equal(ta.bins_T.numpy(), ta.bins.numpy().T)
    assert ta.feature_names() == ra.feature_names()
    assert ta.params["monotone_constraints"] == [1, 0, 0, 0, 0, 0]
    assert ta.num_features_raw == 6
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(port._host_trees()[0], name),
                                      getattr(ref._gbdt.finalize()[0], name))
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)


def test_save_and_load_binary(tmp_path):
    # exact: the loaded Dataset trains the same model text; the
    # reference's file is refused, and its mappers carry across through
    # convert.mappers_from_reference
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", **CPU)
    ds = lt.Dataset(X, label=yb, params=p).construct()
    path = str(tmp_path / "train.bin")
    ds.save_binary(path)
    loaded = lt.Dataset.load_binary(path, params=CPU)
    np.testing.assert_array_equal(loaded.bins.numpy(), ds.bins.numpy())
    a = lt.train(p, ds, 2)
    b = lt.train(p, loaded, 2)
    assert a.model_to_string() == b.model_to_string()
    rp = dict(BASE, objective="binary")
    rds = lgb.Dataset(X, label=yb, params=rp).construct()
    rpath = str(tmp_path / "ref.bin")
    rds.save_binary(rpath)
    with pytest.raises(lt.LightGBMError, match="mappers_from_reference"):
        lt.Dataset.load_binary(rpath, params=CPU)
    carried = convert.mappers_from_reference(
        [dataclasses.asdict(m) for m in rds.mappers])
    for m, n in zip(carried, ds.mappers):
        np.testing.assert_array_equal(m.upper_bounds, n.upper_bounds)
        assert (m.num_bins, m.missing_type, m.default_bin) == \
            (n.num_bins, n.missing_type, n.default_bin)


# ---- cv ----

@pytest.mark.parametrize("objective,stratified", [
    ("binary", True), ("regression", False), ("lambdarank", False)])
def test_cv_folds_and_means_match_reference(objective, stratified):
    # exact: each fold's rows (its train set's label and size); the means
    # and stdvs of each round rtol 1e-4
    X, yb, yr = _data(480)
    y = yb if objective == "binary" else yr
    kw = {}
    if objective == "lambdarank":
        y = np.random.RandomState(5).randint(0, 4, 480).astype(np.float32)
        kw["group"] = np.full(24, 20)
    p = dict(BASE, objective=objective)
    ref = lgb.cv(p, lgb.Dataset(X, label=y, params=p, **kw), 3, nfold=3,
                 stratified=stratified, seed=7, return_cvbooster=True)
    pt = dict(p, **CPU)
    port = lt.cv(pt, lt.Dataset(X, label=y, params=pt, **kw), 3, nfold=3,
                 stratified=stratified, seed=7, return_cvbooster=True)
    assert sorted(port) == sorted(ref)
    for a, b in zip(port.pop("cvbooster"), ref.pop("cvbooster")):
        np.testing.assert_array_equal(a.train_set.get_label(),
                                      np.asarray(b.train_set.get_label()))
        np.testing.assert_array_equal(a._gbdt.valid_sets[0].get_label(),
                                      np.asarray(b._gbdt.valid_sets[0]
                                                 .get_label()))
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_stratified_folds_equal_scikit_learns():
    from sklearn.model_selection import StratifiedKFold
    y = np.random.RandomState(0).randint(0, 3, 101).astype(np.float32)
    for shuffle in (True, False):
        want = StratifiedKFold(4, shuffle=shuffle,
                               random_state=11 if shuffle else None).split(
                                   np.zeros(101), y)
        for (a, b), (c, d) in zip(stratified_folds(y, 4, shuffle, 11), want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_cv_early_stopping_and_callbacks():
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", learning_rate=1.0)
    ref = lgb.cv(p, lgb.Dataset(X, label=yb, params=p), 30, nfold=3,
                 early_stopping_rounds=2)
    seen = []

    def spy(env):
        seen.append(env.evaluation_result_list[0][:2])
    pt = dict(p, **CPU)
    port = lt.cv(pt, lt.Dataset(X, label=yb, params=pt), 30, nfold=3,
                 early_stopping_rounds=2, callbacks=[spy])
    assert len(port["binary_logloss-mean"]) == len(
        ref["binary_logloss-mean"]) < 30
    assert seen[0] == ("cv_agg", "binary_logloss")
    stopped = lt.cv(pt, lt.Dataset(X, label=yb, params=pt), 30, nfold=3,
                    callbacks=[lt.early_stopping(2, verbose=False)])
    assert len(stopped["binary_logloss-mean"]) == len(
        port["binary_logloss-mean"])


# ---- the estimators ----

def test_regressor_matches_reference():
    X, _, yr = _data()
    ref = RefRegressor(n_estimators=3, num_leaves=7, max_bin=31,
                       histogram_impl="pallas", min_child_samples=5).fit(X, yr)
    port = lt.LGBMRegressor(n_estimators=3, num_leaves=7, max_bin=31,
                            min_child_samples=5, **CPU).fit(X, yr)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)
    assert port.n_features_ == 6 and port.best_iteration_ == \
        ref.best_iteration_
    np.testing.assert_array_equal(port.feature_importances_,
                                  ref.feature_importances_)
    np.testing.assert_allclose(port.score(X, yr), ref.score(X, yr),
                               rtol=1e-4)


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("labels", ["names", "codes"])
def test_classifier_matches_reference(classes, labels):
    # string labels are encoded in sorted order; the eval set's labels
    # reach the metric as given, so early stopping takes the codes
    X, _, yr = _data()
    code = np.digitize(yr, np.quantile(yr, np.linspace(0, 1, classes + 1)
                                       [1:-1]))
    y = np.array(["hi", "lo", "mid"])[code] if labels == "names" else code
    kw = dict(n_estimators=6, num_leaves=7, max_bin=31, min_child_samples=5,
              learning_rate=0.5, class_weight="balanced")
    fit_kw = ({} if labels == "names" else
              dict(eval_set=[(X[:100], y[:100])], early_stopping_rounds=2))
    ref = RefClassifier(histogram_impl="pallas", **kw).fit(X, y, **fit_kw)
    port = lt.LGBMClassifier(**kw, **CPU).fit(X, y, **fit_kw)
    assert port.classes_.tolist() == ref.classes_.tolist()
    assert port.n_classes_ == classes
    assert port.best_iteration_ == ref.best_iteration_
    np.testing.assert_allclose(port.predict_proba(X), ref.predict_proba(X),
                               rtol=1e-4, atol=1e-6)
    assert (port.predict(X) == ref.predict(X)).mean() > 0.99
    assert port.predict_proba(X).shape == (500, classes)


def test_ranker_matches_reference():
    rng = np.random.RandomState(0)
    X = rng.rand(400, 5).astype(np.float32)
    y = np.clip(np.round(X[:, 0] * 4 + rng.rand(400)), 0, 4)
    group = np.full(20, 20)
    kw = dict(n_estimators=3, num_leaves=7, max_bin=31, min_child_samples=5)
    ref = RefRanker(histogram_impl="pallas", **kw).fit(X, y, group=group)
    port = lt.LGBMRanker(**kw, **CPU).fit(X, y, group=group)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4,
                               atol=1e-6)
    assert port.booster_.params["eval_at"] == [1, 2, 3, 4, 5]
    with pytest.raises(ValueError, match="group"):
        lt.LGBMRanker(**CPU).fit(X, y)


def test_estimator_model_is_trains_model():
    # exact: the wrapper's model text is train's under its parameters
    X, yb, _ = _data()
    clf = lt.LGBMClassifier(n_estimators=3, num_leaves=15, max_bin=63,
                            **CPU).fit(X, yb)
    params = clf._make_train_params()
    direct = lt.train(params, lt.Dataset(X, label=yb, params=params), 3,
                      verbose_eval=False)
    assert clf.booster_.model_to_string() == direct.model_to_string()
    # pred_contrib (A15): the reference's contributions of the same model
    # text, exactly (both run the same host TreeSHAP in f64)
    ref = lgb.Booster(model_str=clf.booster_.model_to_string())
    np.testing.assert_array_equal(
        clf.predict(X, pred_contrib=True),
        np.asarray(ref.predict(X, pred_contrib=True)))
