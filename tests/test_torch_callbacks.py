"""Early stopping and callbacks of the PyTorch/CUDA port (lightgbm_tpu_torch)
against the JAX reference (lightgbm_tpu), on the CPU.

The reference trains on its Pallas kernels in interpret mode
(histogram_impl=pallas), the port with device_type="cpu", as in
tests/test_torch_train.py, on one shared binary and one shared L2 dataset
with a held-out valid set.

Exact: the stopping iteration, ``best_iteration``, the number of trees,
the keys and lengths of ``evals_result`` and ``best_score``, the model's
tree count after ``save_model``, and the log lines' iteration numbers and
metric names. Tolerances: metric values rtol 1e-5 (the leaf values differ
within queue C2, and the reference's metrics are f32 where the port's are
f64); predictions rtol 1e-4 (queue C2).
"""
import re

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu import callback as ref_cb
from lightgbm_tpu.utils import log as ref_log
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import callback as t_cb
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

BASE = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1,
        "prewarm": 0, "histogram_impl": "pallas",
        "use_quantized_grad": "true", "max_bin": 63, "learning_rate": 0.3}
CPU = {"device_type": "cpu"}
METRICS = {"binary": "binary_logloss,auc", "regression": "l2,rmse"}


def _data():
    rng = np.random.RandomState(0)
    X = rng.rand(600, 6).astype(np.float32)
    yb = (X[:, 0] + 0.8 * rng.rand(600) > 0.9).astype(np.float32)
    # L2 labels on a 1/8 grid: their f32 mean is exact in any order
    yr = (np.round((X[:, 1] * 2.0 + 2 * rng.rand(600)) * 8) / 8).astype(
        np.float32)
    return X, {"binary": yb, "regression": yr}


def _train(mod, params, y, **kw):
    X, _ = _data()
    p = dict(params, **CPU) if mod is lt else dict(params)
    ds = mod.Dataset(X[:400], label=y[:400], params=p)
    valid = mod.Dataset(X[400:], label=y[400:], reference=ds)
    res = {}
    bst = mod.train(p, ds, valid_sets=[ds, valid],
                    valid_names=["train", "valid"], evals_result=res, **kw)
    return bst, res


def _assert_results_match(got, want):
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name])
        for metric in want[name]:
            g, w = got[name][metric], want[name][metric]
            if isinstance(w, list):
                assert len(g) == len(w)
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=metric)


@pytest.fixture(scope="module")
def stopped():
    _, ys = _data()
    out = {}
    for objective in ("binary", "regression"):
        for fmo in (False, True):
            p = dict(BASE, objective=objective, metric=METRICS[objective],
                     first_metric_only=fmo)
            out[objective, fmo] = tuple(
                _train(mod, p, ys[objective], num_boost_round=12,
                       early_stopping_rounds=3, verbose_eval=False)
                for mod in (lgb, lt))
    return out


@pytest.mark.parametrize("fmo", [False, True])
@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_early_stopping_matches_reference(stopped, objective, fmo):
    (ref, ref_res), (port, res) = stopped[objective, fmo]
    assert port.best_iteration == ref.best_iteration > 0
    assert port.num_trees() == ref.num_trees()
    _assert_results_match(res, ref_res)
    _assert_results_match(port.best_score, ref.best_score)
    n = len(res["valid"][METRICS[objective].split(",")[0]])
    if objective == "binary" and not fmo:
        # the valid AUC (the second metric) stops the run three iterations
        # after its best, while the logloss still improves
        assert n == port.best_iteration + 3 < 12
    if objective == "binary" and fmo:
        # only the first metric, the logloss, counts: no stop before the end
        assert n == 12


def test_first_metric_only_changes_the_stop(stopped):
    (_, _), (a, _) = stopped["binary", False]
    (_, _), (b, _) = stopped["binary", True]
    assert a.num_trees() < b.num_trees()


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_predict_and_save_default_to_best_iteration(stopped, objective,
                                                    tmp_path):
    (ref, _), (port, _) = stopped[objective, False]
    X, _ = _data()
    best = port.best_iteration
    assert 0 < best < port.num_trees()
    np.testing.assert_array_equal(port.predict(X),
                                  port.predict(X, num_iteration=best))
    assert not np.array_equal(port.predict(X),
                              port.predict(X, num_iteration=-1))
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)
    assert port.model_to_string() == port.model_to_string(
        num_iteration=best)
    path = str(tmp_path / "model.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    assert loaded.num_trees() == best and loaded.best_iteration == -1
    np.testing.assert_array_equal(loaded.predict(X), port.predict(X))
    ref_path = str(tmp_path / "ref.txt")
    ref.save_model(ref_path)
    assert lgb.Booster(model_file=ref_path).num_trees() == best


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_early_stopping_round_param_and_training_metric(objective):
    # early_stopping_round in params, the training metric from
    # is_provide_training_metric (no training set among the valid sets)
    X, ys = _data()
    y = ys[objective]
    p = dict(BASE, objective=objective, metric=METRICS[objective],
             early_stopping_round=2, is_provide_training_metric=True)
    runs = []
    for mod in (lgb, lt):
        pp = dict(p, **CPU) if mod is lt else dict(p)
        ds = mod.Dataset(X[:400], label=y[:400], params=pp)
        valid = mod.Dataset(X[400:], label=y[400:], reference=ds)
        res = {}
        bst = mod.train(pp, ds, num_boost_round=10, valid_sets=[valid],
                        evals_result=res, verbose_eval=False)
        runs.append((bst, res))
    (ref, ref_res), (port, res) = runs
    assert "training" in res and "valid_0" in res
    assert port.best_iteration == ref.best_iteration > 0
    _assert_results_match(res, ref_res)
    _assert_results_match(port.best_score, ref.best_score)


def test_early_stopping_without_valid_sets_trains_every_round():
    X, ys = _data()
    y = ys["regression"]
    runs = []
    for mod in (lgb, lt):
        p = dict(BASE, objective="regression", **(CPU if mod is lt else {}))
        bst = mod.train(p, mod.Dataset(X, label=y, params=p),
                        num_boost_round=4, early_stopping_rounds=1,
                        verbose_eval=False)
        runs.append(bst)
    ref, port = runs
    assert port.num_trees() == ref.num_trees() == 4
    assert port.best_iteration == ref.best_iteration == -1
    assert port.best_score == ref.best_score == {}


def _eval_lines(lines):
    """(iteration, [(data, metric, value)]) of print_evaluation's lines."""
    out = []
    for line in lines:
        m = re.search(r"\[(\d+)\]\t(.*)", line)
        if m:
            items = [re.match(r"(\S+)'s (\S+): (\S+)", part).groups()
                     for part in m.group(2).strip().split("\t")]
            out.append((int(m.group(1)),
                        [(d, k, float(v)) for d, k, v in items]))
    return out


def test_callbacks_match_reference(caplog):
    # record_evaluation, print_evaluation every second iteration and
    # reset_parameter's learning-rate schedule, on both packages: the same
    # evals, the same log lines (values within the metric tolerance), and
    # L2 trees grown at the scheduled rates (predictions rtol 1e-4)
    X, ys = _data()
    y = ys["regression"]
    rates = [0.5, 0.3, 0.2, 0.1]
    p = dict(BASE, objective="regression", metric="l2", verbosity=1)
    lines = []
    level = ref_log.get_level()
    ref_log.set_callback(lines.append)
    try:
        ref_evals = {}
        ref, _ = _train(lgb, p, y, num_boost_round=4, verbose_eval=False,
                        callbacks=[ref_cb.record_evaluation(ref_evals),
                                   ref_cb.print_evaluation(2),
                                   ref_cb.reset_parameter(
                                       learning_rate=list(rates))])
    finally:
        ref_log.set_callback(None)
        ref_log.set_level(level)
    evals = {}
    with caplog.at_level("INFO", logger="lightgbm_tpu_torch"):
        port, _ = _train(lt, p, y, num_boost_round=4, verbose_eval=False,
                         callbacks=[t_cb.record_evaluation(evals),
                                    t_cb.print_evaluation(2),
                                    t_cb.reset_parameter(
                                        learning_rate=list(rates))])
    _assert_results_match(evals, ref_evals)
    got = _eval_lines(r.getMessage() for r in caplog.records)
    want = _eval_lines(lines)
    assert [i for i, _ in got] == [i for i, _ in want] == [2, 4]
    for (_, a), (_, b) in zip(got, want):
        assert [x[:2] for x in a] == [x[:2] for x in b]
        np.testing.assert_allclose([x[2] for x in a], [x[2] for x in b],
                                   rtol=1e-5)
    assert port._gbdt.learning_rate == ref._gbdt.learning_rate == rates[-1]
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)


def test_reset_parameter_forms():
    # a function of the iteration index; a list of the wrong length raises
    X, ys = _data()
    p = dict(BASE, objective="regression", **CPU)
    ds = lt.Dataset(X, label=ys["regression"], params=p)
    seen = []

    def rate(i):
        seen.append(i)
        return 0.1 * (i + 1)
    bst = lt.train(p, ds, num_boost_round=3, verbose_eval=False,
                   callbacks=[t_cb.reset_parameter(learning_rate=rate)])
    assert seen == [0, 1, 2] and bst._gbdt.learning_rate == pytest.approx(0.3)
    with pytest.raises(ValueError, match="num_boost_round"):
        lt.train(p, lt.Dataset(X, label=ys["regression"], params=p),
                 num_boost_round=3, verbose_eval=False,
                 callbacks=[t_cb.reset_parameter(learning_rate=[0.1, 0.2])])


def test_callback_order_and_env():
    # callbacks run sorted by order, before-iteration ones before the
    # update; the env carries the iteration range and the evaluation list
    X, ys = _data()
    p = dict(BASE, objective="regression", metric="l2", **CPU)
    log = []

    def make(name, order, before=False):
        def cb(env):
            log.append((name, env.iteration, env.begin_iteration,
                        env.end_iteration,
                        None if env.evaluation_result_list is None
                        else [r[:2] for r in env.evaluation_result_list]))
        cb.order = order
        if before:
            cb.before_iteration = True
        return cb
    _train(lt, p, ys["regression"], num_boost_round=2, verbose_eval=False,
           callbacks=[make("late", 40), make("early", 5),
                      make("pre", 50, before=True)])
    evals = [("training", "l2"), ("valid", "l2")]
    assert log == [("pre", 0, 0, 2, None), ("early", 0, 0, 2, evals),
                   ("late", 0, 0, 2, evals), ("pre", 1, 0, 2, None),
                   ("early", 1, 0, 2, evals), ("late", 1, 0, 2, evals)]


def test_record_evaluation_needs_a_dict():
    with pytest.raises(TypeError):
        t_cb.record_evaluation([])
