"""The metric table of the PyTorch/CUDA port (lightgbm_tpu_torch) against
the JAX reference (lightgbm_tpu), on the CPU: every pointwise metric, with
and without row weights, on the same inputs made from numpy seeds, and the
ranking ones' names (their values: test_torch_ranking.py).

Exact: each alias's reported name and direction (greater_is_better), and
the default metric of every objective name. Tolerance: values rtol 1e-5
(the reference computes in f32, the port in f64; measured up to 4e-7).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu import config as ref_config
from lightgbm_tpu import metrics as ref_metrics
from lightgbm_tpu_torch import config as t_config
from lightgbm_tpu_torch import metrics as t_metrics
from lightgbm_tpu_torch.log import LightGBMError

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

N, K = 1000, 4
CONF = {"alpha": 0.7, "fair_c": 0.8, "tweedie_variance_power": 1.3,
        "num_class": K}
AUC_MU_W = [0, 1, 2, 3, 1, 0, 1, 2, 2, 1, 0, 1, 3, 2, 1, 0]
# name -> input kind
METRICS = {
    "l2": "reg", "rmse": "reg", "l1": "reg", "quantile": "reg",
    "huber": "reg", "fair": "reg", "mape": "reg",
    "poisson": "pos", "gamma": "pos", "gamma_deviance": "pos",
    "tweedie": "pos",
    "binary_logloss": "bin", "binary_error": "bin", "auc": "bin",
    "multi_logloss": "multi", "multi_error": "multi", "auc_mu": "multi",
    "cross_entropy": "xent", "kullback_leibler": "xent",
    "cross_entropy_lambda": "xentlambda",
}
ALIASES = ["l2", "mse", "mean_squared_error", "regression", "l2_root",
           "rmse", "root_mean_squared_error", "l1", "mae",
           "mean_absolute_error", "regression_l1", "quantile", "huber",
           "fair", "poisson", "mape", "mean_absolute_percentage_error",
           "gamma", "gamma_deviance", "tweedie", "binary_logloss", "binary",
           "binary_error", "auc", "multi_logloss", "multiclass", "softmax",
           "multiclassova", "multi_error", "auc_mu", "cross_entropy",
           "xentropy", "cross_entropy_lambda", "xentlambda",
           "kullback_leibler", "kldiv"]


def _inputs(kind, seed=0):
    """(label, prediction) of one input kind; scores with ties."""
    rng = np.random.RandomState(seed)
    if kind == "reg":
        y = (np.round(rng.randn(N) * 16) / 8).astype(np.float32)
        return y, (y + rng.randn(N) * 0.7).astype(np.float32)
    if kind == "pos":
        y = (rng.randint(1, 40, N) / 8).astype(np.float32)
        return y, (y * np.exp(rng.randn(N) * 0.3)).astype(np.float32)
    if kind == "bin":
        y = (rng.rand(N) > 0.6).astype(np.float32)
        p = np.clip(0.3 * y + 0.7 * rng.rand(N), 0.01, 0.99)
        return y, np.round(p, 2).astype(np.float32)
    if kind == "multi":
        y = rng.randint(0, K, N).astype(np.float32)
        s = rng.randn(N, K) + 1.5 * np.eye(K)[y.astype(int)]
        p = np.exp(s) / np.exp(s).sum(axis=1, keepdims=True)
        return y, np.round(p, 3).astype(np.float32)
    # labels in (0, 1): at 0 or 1 the reference's f32 clip to 1 - 1e-15
    # rounds to 1 and its kullback_leibler is nan (0 * log 0), where the
    # port's f64 one is finite (test_kullback_leibler_finite_at_hard_labels)
    y = (rng.randint(1, 8, N) / 8).astype(np.float32)
    p = np.clip(0.5 * y + 0.5 * rng.rand(N), 0.02, 0.98).astype(np.float32)
    if kind == "xentlambda":
        return y, (-np.log1p(-p)).astype(np.float32)    # hhat > 0
    return y, p


def _pair(name, conf=CONF):
    ref = ref_metrics.create_metrics([name], ref_config.Config(conf))
    got = t_metrics.create_metrics([name], t_config.Config(conf))
    assert len(ref) == len(got) == 1
    return ref[0], got[0]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_reference(name, weighted):
    y, pred = _inputs(METRICS[name])
    w = ((np.random.RandomState(9).randint(2, 9, N) / 4).astype(np.float32)
         if weighted else None)
    confs = [CONF, dict(CONF, auc_mu_weights=AUC_MU_W)] \
        if name == "auc_mu" else [CONF]
    for conf in confs:
        ref, got = _pair(name, conf)
        want = ref(jnp.asarray(y), jnp.asarray(pred),
                   None if w is None else jnp.asarray(w))
        have = got(torch.from_numpy(y), torch.from_numpy(pred),
                   None if w is None else torch.from_numpy(w))
        assert isinstance(have, float) and np.isfinite(have)
        np.testing.assert_allclose(have, want, rtol=1e-5, err_msg=name)
    if weighted and name not in ("auc_mu",):
        # the weights change the value (auc_mu ignores them, as there)
        assert have != got(torch.from_numpy(y), torch.from_numpy(pred))


@pytest.mark.parametrize("name", ALIASES)
def test_alias_names_and_direction_match_reference(name):
    ref, got = _pair(name)
    assert (got.name, got.greater_is_better, got.use_prob) == \
        (ref.name, ref.greater_is_better, ref.use_prob)


def test_default_metric_for_every_objective_name():
    names = list(t_config.OBJECTIVES) + ["", "unknown_objective", None]
    for name in names:
        assert t_metrics.default_metric_for_objective(name) == \
            ref_metrics.default_metric_for_objective(name), name


# the ranking metrics train since A11b; under the old name, each alias now
# gives the reference's metrics, one per eval_at entry
@pytest.mark.parametrize("name", ["ndcg", "map", "mean_average_precision",
                                  "lambdarank", "xendcg"])
def test_ranking_metrics_raise_naming_a11b(name):
    for conf in ({}, {"eval_at": [3, 10]}):
        got = t_metrics.create_metrics([name], t_config.Config(conf))
        want = ref_metrics.create_metrics([name], ref_config.Config(conf))
        assert [(m.name, m.greater_is_better, m.use_prob, m.eval_at)
                for m in got] == [(m.name, m.greater_is_better, m.use_prob,
                                   m.eval_at) for m in want]


def test_unknown_metric_raises_and_none_is_skipped():
    with pytest.raises(LightGBMError, match="unknown metric"):
        t_metrics.create_metrics(["l2", "no_such_metric"])
    assert t_metrics.create_metrics(["none", "", "custom", "na", "null"]) \
        == []


@pytest.mark.parametrize("wts,match", [([1.0] * 9, "num_class"),
                                       ([0.0] * 16, "non-zero")])
def test_auc_mu_weights_are_checked(wts, match):
    with pytest.raises(LightGBMError, match=match):
        t_metrics.create_metrics(["auc_mu"], t_config.Config(
            dict(CONF, auc_mu_weights=wts)))


def test_auc_without_weights_is_the_rank_statistic():
    # the midpoint-rank form equals the Mann-Whitney count of correctly
    # ordered pairs, ties counted one half
    y, p = _inputs("bin", seed=4)
    pos, neg = p[y > 0][:, None], p[y == 0][None, :]
    want = ((pos > neg).sum() + 0.5 * (pos == neg).sum()) / (
        pos.size * neg.size)
    np.testing.assert_allclose(
        float(t_metrics.auc(torch.from_numpy(y), torch.from_numpy(p))),
        want, rtol=1e-12)


def test_kullback_leibler_finite_at_hard_labels():
    # labels 0 and 1: LightGBM's double-precision KL is finite there (the
    # f32 reference gives nan); the port equals numpy's f64 formula
    rng = np.random.RandomState(6)
    y = (rng.rand(N) > 0.5).astype(np.float32)
    p = np.clip(rng.rand(N), 0.02, 0.98).astype(np.float32)
    yy = np.clip(y.astype(np.float64), 1e-15, 1 - 1e-15)
    pp = p.astype(np.float64)
    want = np.mean(yy * np.log(yy / pp)
                   + (1 - yy) * np.log((1 - yy) / (1 - pp)))
    got = t_metrics.create_metrics(["kullback_leibler"])[0](
        torch.from_numpy(y), torch.from_numpy(p))
    np.testing.assert_allclose(got, want, rtol=1e-12)
