"""TreeSHAP contributions and plotting of the PyTorch/CUDA port
(lightgbm_tpu_torch) against brute-force Shapley values and the JAX
reference (lightgbm_tpu), on the CPU.

Both packages run the same host numpy TreeSHAP, so on one model text their
contributions are equal in f64, exactly; against brute force (coverage-
weighted conditional expectations over every feature subset) they agree
to 1e-9; each row's contributions sum to its raw score to 1e-9 relative.
The plots are held against the reference's on the same model file (bar
widths, histogram counts, the digraph's source); matplotlib and graphviz
are imported only inside the plotting functions, and a test skips with its
reason where one is missing.
"""
import importlib.util
import itertools
import math
import shutil

import numpy as np
import pytest
from scipy import sparse

import lightgbm_tpu as lgb
from lightgbm_tpu import plotting as ref_plotting
import lightgbm_tpu_torch as lt
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}


def _needs(module):
    if importlib.util.find_spec(module) is None:
        pytest.skip(f"{module} is not installed")


def _expvalue(tree, x, fixed):
    """E[f(x') | x'_S = x_S] with coverage-weighted marginalization."""
    def cnt(p):
        return float(tree.leaf_count[~p] if p < 0 else tree.internal_count[p])

    def rec(ptr):
        if ptr < 0:
            return tree.leaf_value[~ptr]
        feat = tree.split_feature[ptr]
        left, right = tree.left_child[ptr], tree.right_child[ptr]
        if feat in fixed:
            return rec(left if x[feat] <= tree.threshold_real[ptr] else right)
        return (cnt(left) * rec(left) + cnt(right) * rec(right)) / (
            cnt(left) + cnt(right))
    return rec(0)


def _brute_shap(tree, x, n_feat):
    """Exact Shapley values by subset enumeration; the last entry is the
    tree's expected value."""
    phi = np.zeros(n_feat + 1)
    for j in range(n_feat):
        others = [f for f in range(n_feat) if f != j]
        for k in range(len(others) + 1):
            for S in itertools.combinations(others, k):
                w = (math.factorial(k) * math.factorial(n_feat - k - 1)
                     / math.factorial(n_feat))
                phi[j] += w * (_expvalue(tree, x, set(S) | {j})
                               - _expvalue(tree, x, set(S)))
    phi[-1] = _expvalue(tree, x, set())
    return phi


def _reg_model(rounds=3, **extra):
    rng = np.random.RandomState(0)
    X = rng.randn(400, 4)
    y = X[:, 0] * 2 + X[:, 1] * X[:, 2] + rng.randn(400) * 0.1
    p = {"objective": "regression", "num_leaves": 8, "verbosity": -1,
         "min_data_in_leaf": 10, "lambda_l2": 1.0, **CPU, **extra}
    return X, lt.train(p, lt.Dataset(X, label=y, params=p), rounds)


def test_treeshap_matches_bruteforce():
    X, bst = _reg_model()
    trees = bst._host_trees()
    contrib = bst.predict(X[:5], pred_contrib=True)
    assert contrib.shape == (5, 5)
    for i in range(5):
        want = sum(_brute_shap(t, X[i], 4) for t in trees)
        np.testing.assert_allclose(contrib[i], want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("objective,k", [("binary", 1), ("multiclass", 3)])
def test_contributions_equal_reference_on_one_model_text(objective, k):
    """The port's contributions of a model text equal the reference's for
    the same text bit for bit, and each row (class) sums to its raw
    score."""
    rng = np.random.RandomState(1)
    X = rng.randn(500, 5)
    X[rng.rand(500) < 0.1, 3] = np.nan
    y = (X[:, 0] + X[:, 1] > 0).astype(float) if k == 1 else \
        np.digitize(X[:, 0] + 0.3 * X[:, 2], [-0.5, 0.5]).astype(float)
    p = {"objective": objective, "num_class": k, "num_leaves": 15,
         "verbosity": -1, "min_data_in_leaf": 10, "lambda_l2": 5.0, **CPU}
    text = lt.train(p, lt.Dataset(X, label=y, params=p),
                    6).model_to_string()
    ours = lt.Booster(model_str=text, params=CPU)
    ref = lgb.Booster(model_str=text)
    got = ours.predict(X[:40], pred_contrib=True)
    assert got.shape == (40, k * 6)
    np.testing.assert_array_equal(got, np.asarray(ref.predict(
        X[:40], pred_contrib=True)))
    raw = ours.predict(X[:40], raw_score=True).reshape(40, k)
    sums = got.reshape(40, k, 6).sum(axis=2)
    np.testing.assert_allclose(sums, raw, rtol=1e-9, atol=1e-12)


def test_contributions_dense_and_csr():
    X, bst = _reg_model()
    Xs = X[:30].copy()
    Xs[np.abs(Xs) < 0.5] = 0.0
    csr = sparse.csr_matrix(Xs)
    dense = bst.predict(Xs, pred_contrib=True)
    out = bst.predict(csr, pred_contrib=True)
    assert sparse.issparse(out) and out.shape == dense.shape
    np.testing.assert_array_equal(out.toarray(), dense)
    np.testing.assert_array_equal(bst.predict(csr), bst.predict(Xs))


def test_estimator_pred_contrib():
    rng = np.random.RandomState(2)
    X = rng.randn(300, 4)
    y = (X[:, 0] - X[:, 1] > 0).astype(int)
    clf = lt.LGBMClassifier(n_estimators=4, num_leaves=7,
                            min_child_samples=5, device_type="cpu").fit(X, y)
    got = clf.predict(X[:10], pred_contrib=True)
    np.testing.assert_array_equal(got, clf.booster_.predict(
        X[:10], pred_contrib=True))
    np.testing.assert_allclose(got.sum(axis=1), clf.predict(
        X[:10], raw_score=True), rtol=1e-9)
    reg = lt.LGBMRegressor(n_estimators=3, num_leaves=7, device_type="cpu"
                           ).fit(X, X[:, 0])
    assert reg.predict(X[:4], pred_contrib=True).shape == (4, 5)


# ---------------- plotting ----------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """One binary model text, loaded in both packages, and its eval
    history."""
    rng = np.random.RandomState(3)
    X = rng.randn(400, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(400) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "min_data_in_leaf": 5, "metric": "auc", **CPU}
    ds = lt.Dataset(X, label=y, params=p)
    evals = {}
    bst = lt.train(p, ds, 8, valid_sets=[ds.create_valid(X, label=y)],
                   evals_result=evals, verbose_eval=False)
    path = str(tmp_path_factory.mktemp("plot") / "m.txt")
    bst.save_model(path)
    return (lt.Booster(model_file=path, params=CPU),
            lgb.Booster(model_file=path), evals)


def _mpl():
    _needs("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def test_plot_importance_matches_reference(models):
    plt = _mpl()
    ours, ref, _ = models
    for kw in ({}, {"importance_type": "gain", "max_num_features": 3}):
        a = lt.plot_importance(ours, **kw)
        b = ref_plotting.plot_importance(ref, **kw)
        assert [r.get_width() for r in a.patches] == pytest.approx(
            [r.get_width() for r in b.patches], rel=1e-12)
        assert [t.get_text() for t in a.get_yticklabels()] == \
            [t.get_text() for t in b.get_yticklabels()]
    plt.close("all")


def test_plot_split_value_histogram_matches_reference(models):
    plt = _mpl()
    ours, ref, _ = models
    feat = int(ours._host_trees()[0].split_feature[0])
    a = lt.plot_split_value_histogram(ours, feature=feat)
    b = ref_plotting.plot_split_value_histogram(ref, feature=feat)
    assert [r.get_height() for r in a.patches] == \
        [r.get_height() for r in b.patches]
    assert a.get_title() == b.get_title()
    plt.close("all")


def test_plot_metric(models):
    plt = _mpl()
    _, _, evals = models
    ax = lt.plot_metric(evals, metric="auc")
    assert len(ax.lines) == 1 and len(ax.lines[0].get_ydata()) == 8
    clf = lt.LGBMClassifier(n_estimators=3, num_leaves=7, device_type="cpu")
    rng = np.random.RandomState(4)
    X = rng.randn(200, 3)
    y = (X[:, 0] > 0).astype(int)
    clf.fit(X, y, eval_set=[(X, y)], eval_metric="auc")
    assert len(lt.plot_metric(clf).lines) == 1
    with pytest.raises(TypeError):
        lt.plot_metric(models[0])
    plt.close("all")


def test_create_tree_digraph_matches_reference(models):
    _needs("graphviz")
    ours, ref, _ = models
    for kw in ({}, {"show_info": ["split_gain", "internal_count",
                                  "leaf_count"], "precision": 4}):
        a = lt.create_tree_digraph(ours, tree_index=1, **kw)
        b = ref_plotting.create_tree_digraph(ref, tree_index=1, **kw)
        assert a.source == b.source
    with pytest.raises(IndexError):
        lt.create_tree_digraph(ours, tree_index=99)


def test_plot_tree(models):
    plt = _mpl()
    _needs("graphviz")
    if shutil.which("dot") is None:
        pytest.skip("graphviz's dot program is not installed")
    ax = lt.plot_tree(models[0], tree_index=0)
    assert ax is not None
    plt.close("all")
