"""Custom objectives (fobj) and eval functions (feval) of the PyTorch/CUDA
port (lightgbm_tpu_torch) against the JAX reference (lightgbm_tpu), on the
CPU.

One Python function drives both packages: fobj(score, dataset) and
feval(score, dataset) see the raw score as a numpy array ([N], or [N, K]
for K > 1) and read ``dataset.get_label()`` / ``get_weight()``. The
reference trains on its Pallas kernels in interpret mode
(histogram_impl=pallas), the port with device_type="cpu".

Exact: the first tree of an fobj model (the L2 and the weighted logloss
gradients as custom functions; a K = 3 softmax as flat row-major and as
[N, K] gradients), the keys and lengths of ``evals_result``, the stopping
iteration and ``best_iteration`` of early stopping on a feval metric,
the order of feval results. Tolerances: leaf values rtol 1e-4 plus 1e-4 of
the largest (ROADMAP.md C2); feval values rtol 1e-5 (they read f32 scores
that inherit C2).
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


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(600, 6).astype(np.float32)
    yr = (np.round((X[:, 1] * 2.0 + 2 * rng.rand(600)) * 8) / 8).astype(
        np.float32)
    yb = (X[:, 0] + 0.8 * rng.rand(600) > 0.9).astype(np.float32)
    s = X[:, 0] + 0.6 * X[:, 1] + 0.5 * rng.rand(600)
    yk = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float32)
    w = (rng.randint(2, 9, 600) / 4).astype(np.float32)
    return X, {"regression": yr, "binary": yb, "multiclass": yk}, w


def l2_fobj(score, ds):
    return score - ds.get_label(), np.ones_like(score)


def logloss_fobj(score, ds):
    y, w = ds.get_label(), ds.get_weight()
    p = 1.0 / (1.0 + np.exp(-score))
    return (p - y) * w, p * (1.0 - p) * w


def softmax_fobj(flat):
    def fobj(score, ds):
        e = np.exp(score - score.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        g = p - np.eye(K)[ds.get_label().astype(int)]
        h = K / (K - 1.0) * p * (1.0 - p)
        return (g.reshape(-1), h.reshape(-1)) if flat else (g, h)
    return fobj


def mae_feval(score, ds):
    return "mae", float(np.mean(np.abs(score - ds.get_label()))), False


def two_fevals(score, ds):
    err = np.abs(score - ds.get_label())
    return [("max_err", float(err.max()), False),
            ("within_half", float(np.mean(err < 0.5)), True)]


def _train(mod, params, X, y, w=None, valid=True, **kw):
    p = dict(params, **CPU) if mod is lt else dict(params)
    ds = mod.Dataset(X[:400], label=y[:400],
                     weight=None if w is None else w[:400], params=p)
    sets, names = [ds], ["train"]
    if valid:
        sets.append(mod.Dataset(X[400:], label=y[400:], reference=ds))
        names.append("valid")
    res = {}
    bst = mod.train(p, ds, valid_sets=sets, valid_names=names,
                    evals_result=res, verbose_eval=False, **kw)
    return bst, res


def _results_match(got, want):
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name])
        for metric in want[name]:
            np.testing.assert_allclose(got[name][metric], want[name][metric],
                                       rtol=1e-5, err_msg=metric)


@pytest.mark.parametrize("objective,fobj,weighted", [
    ("regression", l2_fobj, False),
    ("binary", logloss_fobj, True)])
def test_fobj_trains_the_reference_trees(objective, fobj, weighted):
    X, ys, w = _data()
    p = dict(BASE, max_bin=63, objective=objective, metric="None")
    runs = [_train(mod, p, X, ys[objective], w if weighted else None,
                   valid=False, num_boost_round=3, fobj=fobj)
            for mod in (lgb, lt)]
    (ref, _), (port, _) = runs
    gb = port._gbdt
    # fobj turns the objective off: no init score, the unfused front, all
    # three quantized channels
    assert gb.objective is None and gb.init_scores == [0.0]
    assert "objective=none" in port.model_to_string()
    assert port.num_trees() == ref.num_trees() == 3
    assert_models_match(ref, port, X)


@pytest.mark.parametrize("flat", [True, False])
def test_multiclass_fobj_trains_the_reference_trees(flat):
    X, ys, _ = _data(1)
    p = dict(BASE, max_bin=63, objective="multiclass", num_class=K,
             metric="None")
    (ref, _), (port, _) = [
        _train(mod, p, X, ys["multiclass"], valid=False,
               num_boost_round=2, fobj=softmax_fobj(flat))
        for mod in (lgb, lt)]
    assert port.num_model_per_iteration() == K
    assert port.num_trees() == ref.num_trees() == 2 * K
    assert_models_match(ref, port, X)
    raw = port.predict(X, raw_score=True)
    assert raw.shape == (600, K)
    # objective "none": predict gives the raw scores
    np.testing.assert_array_equal(port.predict(X), raw)


@pytest.mark.parametrize("feval", [mae_feval, [mae_feval, two_fevals]])
def test_feval_results_flow_into_evals_result(feval):
    X, ys, _ = _data()
    p = dict(BASE, max_bin=63, objective="regression", metric="l2")
    (ref, want), (port, got) = [
        _train(mod, p, X, ys["regression"], num_boost_round=4, feval=feval)
        for mod in (lgb, lt)]
    _results_match(got, want)
    names = list(got["valid"])
    assert names[0] == "l2" and "mae" in names
    assert len(got["training"]["mae"]) == 4
    if isinstance(feval, list):
        assert names == ["l2", "mae", "max_err", "within_half"]


def test_fobj_feval_early_stopping_matches_reference():
    # the valid label is the negated target, so training moves away from
    # it and the feval metric stops the run; first_metric_only reads the
    # feval metric, the only one (metric None)
    X, ys, _ = _data(2)
    y = ys["regression"].copy()
    y[400:] = -y[400:]
    p = dict(BASE, max_bin=63, objective="regression", metric="None",
             learning_rate=0.3)
    runs = [_train(mod, p, X, y, num_boost_round=20, fobj=l2_fobj,
                   feval=mae_feval, early_stopping_rounds=2)
            for mod in (lgb, lt)]
    (ref, want), (port, got) = runs
    _results_match(got, want)
    assert len(got["valid"]["mae"]) < 20
    assert port.best_iteration == ref.best_iteration > 0
    assert port.best_score["valid"]["mae"] == pytest.approx(
        ref.best_score["valid"]["mae"], rel=1e-5)
    np.testing.assert_allclose(port.predict(X), np.asarray(ref.predict(X)),
                               rtol=1e-4, atol=1e-4)


def test_update_takes_fobj_directly():
    # Booster.update(fobj=...) without train(): one iteration each
    X, ys, _ = _data()
    p = dict(BASE, max_bin=63, objective="none", **CPU)
    bst = lt.Booster(p, lt.Dataset(X, label=ys["regression"], params=p))
    for _ in range(2):
        assert bst.update(fobj=l2_fobj) is False
    assert bst.current_iteration == 2 and bst.num_trees() == 2
    ref = lt.train(dict(p, objective="regression", boost_from_average=False),
                   lt.Dataset(X, label=ys["regression"], params=p),
                   num_boost_round=2)
    a, b = bst._host_trees()[0], ref._host_trees()[0]
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
