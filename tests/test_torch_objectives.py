"""The pointwise objectives of the PyTorch/CUDA port (lightgbm_tpu_torch)
against the JAX reference (lightgbm_tpu), on the CPU, with and without row
weights.

Inputs are made from numpy seeds: labels on a 1/8 grid (positive where the
objective needs it, in [0, 1] for the cross-entropies), weights on a 1/4
grid in [0.5, 2], so every f32 sum the init scores and the leaf renewal
take is exact in any order. The reference trains on its Pallas kernels in
interpret mode (histogram_impl=pallas), the port with device_type="cpu", as
in tests/test_torch_train.py.

Exact: the gradients and hessians of every objective whose formula has no
``exp`` (L2, L1, Huber, Fair, Quantile, MAPE, with reg_sqrt too),
``boost_from_score``, ``is_constant_hessian`` and the fused-front spec of
every objective, the weighted and unweighted percentiles and the per-leaf
renewal (L1, Quantile, MAPE) bit for bit, and the first tree of 3-iteration
models (structure, and for the renewal objectives the leaf values bit for
bit). Tolerances: gradients, hessians and converted outputs through
``exp`` within 1e-6 of the array's largest magnitude (torch's and
XLA:CPU's ``exp`` differ by an ulp on some arguments, ROADMAP.md C1;
a difference such as exp(s) - label cancels, so it is bounded in absolute
terms, measured up to 3 ulp of the largest); the other leaf values of the
first tree rtol 1e-4 plus 1e-4 of the largest leaf (C2); predictions after
3 iterations rtol 1e-4 plus 1e-4 of the largest. The replay of
tests/test_objectives_battery.py's flag contract runs on the port's own
objectives.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu import config as ref_config
from lightgbm_tpu import objectives as ref_obj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import config as t_config
from lightgbm_tpu_torch import objectives as t_obj

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
SCALAR = ["regression", "regression_l1", "huber", "fair", "poisson",
          "quantile", "mape", "gamma", "tweedie", "binary", "cross_entropy",
          "cross_entropy_lambda"]
EXP = {"poisson", "gamma", "tweedie", "binary", "cross_entropy",
       "cross_entropy_lambda", "multiclass", "multiclassova"}
RENEWED = ("regression_l1", "quantile", "mape")
PARAMS = {"quantile": {"alpha": 0.7}, "huber": {"alpha": 0.6},
          "fair": {"fair_c": 0.8}, "tweedie": {"tweedie_variance_power": 1.3},
          "multiclass": {"num_class": 3}, "multiclassova": {"num_class": 3}}


def labels(name, n, rng):
    """Labels an objective takes, on a 1/8 grid (classes 0..2 for
    multiclass)."""
    if name == "binary":
        return (rng.rand(n) > 0.55).astype(np.float32)
    if name.startswith("cross_entropy"):
        return (rng.randint(0, 5, n) / 4).astype(np.float32)
    if name.startswith("multiclass"):
        return rng.randint(0, 3, n).astype(np.float32)
    if name in ("poisson", "gamma", "tweedie", "mape"):
        return (rng.randint(1, 40, n) / 8).astype(np.float32)
    return (np.round(rng.randn(n) * 16) / 8).astype(np.float32)


def weights(n, rng):
    return (rng.randint(2, 9, n) / 4).astype(np.float32)


def _pair(name, y, w, extra=None):
    """(reference, port) objectives of one name, initialized on y, w."""
    params = dict({"objective": name}, **PARAMS.get(name, {}),
                  **(extra or {}))
    ref = ref_obj.create_objective(name, ref_config.Config(params))
    ref.init(jnp.asarray(y), None if w is None else jnp.asarray(w))
    got = t_obj.create_objective(name, t_config.Config(params))
    got.init(torch.from_numpy(y), None if w is None else torch.from_numpy(w))
    return ref, got


def _close(got, want, exact, bound=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=bound * np.abs(want).max())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", SCALAR + ["multiclass", "multiclassova"])
def test_gradients_init_score_and_output_match_reference(name, weighted):
    rng = np.random.RandomState(3)
    n = 500
    y = labels(name, n, rng)
    w = weights(n, rng) if weighted else None
    ref, got = _pair(name, y, w)
    k = 3 if name.startswith("multiclass") else 1
    assert got.num_model_per_iteration == ref.num_model_per_iteration == k
    score = (rng.randn(*((n,) if k == 1 else (n, k))) * 0.8).astype(
        np.float32)
    rg, rh = ref.get_gradients(jnp.asarray(score))
    g, h = got.get_gradients(torch.from_numpy(score))
    _close(g.numpy(), rg, name not in EXP)
    # cross_entropy_lambda's hessian subtracts two products of exp terms:
    # measured 1.3e-6 of the largest
    _close(h.numpy(), rh, name not in EXP,
           1e-5 if name == "cross_entropy_lambda" else 1e-6)
    assert got.boost_from_score() == ref.boost_from_score()
    _close(got.convert_output(torch.from_numpy(score)).numpy(),
           ref.convert_output(jnp.asarray(score)), name not in EXP)
    assert got.is_constant_hessian == ref.is_constant_hessian
    rs, gs = ref.fused_grad_spec(), got.fused_grad_spec()
    assert (rs is None) == (gs is None)
    if rs is not None:
        assert gs[0] == rs[0]
        np.testing.assert_array_equal(gs[1].numpy(), np.asarray(rs[1]))


@pytest.mark.parametrize("name", ["regression", "regression_l1", "huber"])
def test_reg_sqrt_matches_reference(name):
    # labels are squares of 1/8-grid values, so the square roots, and the
    # f32 sums of the init score, are exact
    rng = np.random.RandomState(5)
    y = labels(name, 300, rng)
    y = (np.sign(y) * y * y).astype(np.float32)
    ref, got = _pair(name, y, None, {"reg_sqrt": True})
    score = rng.randn(300).astype(np.float32)
    for a, b in zip(got.get_gradients(torch.from_numpy(score)),
                    ref.get_gradients(jnp.asarray(score))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.boost_from_score() == ref.boost_from_score()
    np.testing.assert_array_equal(
        got.convert_output(torch.from_numpy(score)).numpy(),
        np.asarray(ref.convert_output(jnp.asarray(score))))
    # rmse trains as L2 without the square root (create_objective)
    conf = t_config.Config({"objective": "rmse", "reg_sqrt": True})
    t_obj.create_objective("rmse", conf)
    assert conf.reg_sqrt is False


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("alpha", [0.5, 0.7, 0.9])
def test_weighted_percentile_bit_exact(alpha, weighted):
    rng = np.random.RandomState(int(alpha * 10))
    for n in (1, 2, 7, 501):
        v = (np.round(rng.randn(n) * 8) / 8).astype(np.float32)
        w = weights(n, rng) if weighted else None
        want = ref_obj._weighted_percentile(
            jnp.asarray(v), None if w is None else jnp.asarray(w), alpha)
        got = t_obj.weighted_percentile(
            torch.from_numpy(v), None if w is None else torch.from_numpy(w),
            alpha)
        assert np.float32(got.item()) == np.float32(want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("skew", [False, True])
def test_leaf_percentile_bit_exact(alpha, weighted, skew):
    # residuals with ties and near-ties (the f32 key rounds them into
    # ties within a leaf: the stable sort keeps row order, as jnp.argsort),
    # empty leaves, and skewed leaf sizes (leaf k drawn with probability
    # proportional to 1 / (k + 1))
    rng = np.random.RandomState(11)
    n, L = 2000, 16
    r = (rng.randn(n) * 3).astype(np.float32)
    r[::7] = np.round(r[::7])
    r[1::9] = r[1::9] + np.float32(1e-6)
    if skew:
        p = 1.0 / np.arange(1, L + 1)
        lid = rng.choice(L, n, p=p / p.sum()).astype(np.int32)
    else:
        lid = rng.randint(0, L, n).astype(np.int32)
    lid[lid == 5] = 6        # an empty leaf
    w = weights(n, rng) if weighted else None
    want = ref_obj._leaf_percentile(jnp.asarray(r), jnp.asarray(lid), L,
                                    alpha,
                                    None if w is None else jnp.asarray(w))
    got = t_obj.leaf_percentile(torch.from_numpy(r), torch.from_numpy(lid),
                                L, alpha,
                                None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", RENEWED)
def test_renew_leaf_values_bit_exact(name, weighted):
    rng = np.random.RandomState(2)
    n, L = 800, 10
    y = labels(name, n, rng)
    w = weights(n, rng) if weighted else None
    ref, got = _pair(name, y, w)
    score = (np.round(rng.randn(n) * 8) / 8).astype(np.float32)
    lid = rng.randint(0, L - 1, n).astype(np.int32)
    want = ref.renew_leaf_values(jnp.asarray(score), jnp.asarray(lid), L)
    have = got.renew_leaf_values(torch.from_numpy(score),
                                 torch.from_numpy(lid), L)
    np.testing.assert_array_equal(have.numpy(), np.asarray(want))
    for obj in (ref, got):
        assert type(obj).__name__ in ("RegressionL1", "Quantile", "Mape")
    assert t_obj.RegressionL2(t_config.Config()).renew_leaf_values(
        torch.from_numpy(score), torch.from_numpy(lid), L) is None


# ---- the battery's flag contract (tests/test_objectives_battery.py) ----

_SMOOTH = ["regression", "fair", "poisson", "gamma", "tweedie", "binary",
           "cross_entropy", "cross_entropy_lambda"]


def _port_fixture(name, n=64, seed=3):
    rng = np.random.RandomState(seed)
    if name in ("binary", "cross_entropy", "cross_entropy_lambda"):
        label = (rng.rand(n) > 0.5).astype(np.float32)
    elif name in ("poisson", "gamma", "tweedie", "mape"):
        label = (rng.rand(n) * 4 + 0.5).astype(np.float32)
    else:
        label = rng.randn(n).astype(np.float32)
    obj = t_obj.create_objective(name, t_config.Config({"objective": name}))
    obj.init(torch.from_numpy(label))
    return obj, torch.from_numpy(rng.randn(n).astype(np.float32) * 0.5)


@pytest.mark.parametrize("name", SCALAR)
def test_const_hessian_flag_matches_reported_hessian(name):
    obj, score = _port_fixture(name)
    _, h1 = obj.get_gradients(score)
    _, h2 = obj.get_gradients(score * -1.7 + 0.3)
    h1, h2 = h1.numpy(), h2.numpy()
    if obj.is_constant_hessian:
        assert np.all(h1 == h1[0]) and np.all(h2 == h1[0]), name


@pytest.mark.parametrize("name", _SMOOTH)
def test_reported_hessian_matches_numerical(name):
    obj, score = _port_fixture(name)
    _, h0 = obj.get_gradients(score)
    eps = 1e-3
    gp, _ = obj.get_gradients(score + eps)
    gm, _ = obj.get_gradients(score - eps)
    h_num = (gp.double() - gm.double()).numpy() / (2 * eps)
    h0 = h0.double().numpy()
    if name == "poisson":
        # the hessian carries exp(poisson_max_delta_step) on purpose
        h0 = h0 / obj._hess_scale
    np.testing.assert_allclose(h_num, h0, rtol=5e-2, atol=5e-3,
                               err_msg=name)


@pytest.mark.parametrize("name", ["regression", "regression_l1",
                                  "quantile"])
def test_const_hessian_flag_clears_with_weights(name):
    rng = np.random.RandomState(0)
    obj = t_obj.create_objective(name, t_config.Config({"objective": name}))
    obj.init(torch.from_numpy(rng.randn(32).astype(np.float32)),
             torch.from_numpy((rng.rand(32) + 0.5).astype(np.float32)))
    assert not obj.is_constant_hessian


# ---- 3-iteration models ----

def _data(max_bin, name, seed=0):
    """400 x 6 rows at max_bin=63 (F * B = 384); 600 x 9 at 255 (more
    than 128 bins a feature, so B = 256 and F * B = 2304 > 2048)."""
    n, f = (400, 6) if max_bin == 63 else (600, 9)
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    X[rng.rand(n) < 0.05, f - 1] = np.nan
    y = labels(name, n, rng)
    # a target that depends on the features
    order = np.argsort(X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.rand(n))
    y = np.sort(y)[np.argsort(order)]
    return X, y, weights(n, rng)


def train_pair(params, X, y, w=None, rounds=3, **kw):
    """(reference, port) boosters trained on the same rows."""
    ref = lgb.train(params, lgb.Dataset(X, label=y, weight=w, params=params),
                    num_boost_round=rounds, **kw)
    pt = dict(params, **CPU)
    port = lt.train(pt, lt.Dataset(X, label=y, weight=w, params=pt),
                    num_boost_round=rounds, **kw)
    return ref, port


def assert_models_match(ref, port, X, renewed=False):
    """The first iteration's trees: structure exact, leaf values bit for
    bit when renewed, else rtol 1e-4 + 1e-4 of the largest leaf (C2);
    raw predictions rtol 1e-4 + 1e-4 of the largest."""
    k = port.num_model_per_iteration()
    assert k == ref.num_model_per_iteration()
    rt, pt_ = ref._ensure_host_trees(), port._host_trees()
    assert len(rt) == len(pt_) >= k
    for a, b in zip(rt[:k], pt_[:k]):
        assert a.num_leaves == b.num_leaves > 1
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=name)
        if renewed:
            np.testing.assert_array_equal(b.leaf_value, a.leaf_value)
        else:
            np.testing.assert_allclose(
                b.leaf_value, a.leaf_value, rtol=1e-4,
                atol=1e-4 * np.abs(a.leaf_value).max())
    want = np.asarray(ref.predict(X, raw_score=True))
    got = port.predict(X, raw_score=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


MODEL_CASES = [(name, w, 63) for name in SCALAR if name != "binary"
               for w in (False, True)]
MODEL_CASES += [("binary", True, 63), ("binary", True, 255),
                ("regression", True, 255)]
MODEL_CASES += [(name, True, 255) for name in
                ("regression_l1", "quantile", "huber", "poisson", "tweedie",
                 "cross_entropy")]


@pytest.mark.parametrize("name,weighted,max_bin", MODEL_CASES)
def test_three_iteration_models_match_reference(name, weighted, max_bin):
    X, y, w = _data(max_bin, name)
    p = dict(BASE, objective=name, max_bin=max_bin, **PARAMS.get(name, {}))
    ref, port = train_pair(p, X, y, w if weighted else None)
    gp = port._gbdt.gp
    # weights and every objective but L2 / binary leave the fused front
    # (unweighted L2 at max_bin=63 takes it); weights turn the
    # const-hessian elision off
    fused = name == "regression" and not weighted and max_bin == 63
    assert (gp.fused_obj is not None) == fused and gp.quant
    assert gp.const_hess == (name in ("regression", "regression_l1",
                                      "quantile") and not weighted)
    assert_models_match(ref, port, X, renewed=name in RENEWED)
    np.testing.assert_allclose(port.predict(X), np.asarray(ref.predict(X)),
                               rtol=1e-4,
                               atol=1e-4 * np.abs(ref.predict(X)).max())


@pytest.mark.parametrize("extra", [{"use_quantized_grad": "false"},
                                   {"grow_policy": "lossguide"}])
@pytest.mark.parametrize("name", ["regression", "binary", "quantile"])
def test_weights_on_the_f32_and_lossguide_growers(name, extra):
    X, y, w = _data(63, name, seed=1)
    p = dict(BASE, objective=name, max_bin=63, **PARAMS.get(name, {}),
             **extra)
    ref, port = train_pair(p, X, y, w)
    assert not port._gbdt.gp.quant
    assert_models_match(ref, port, X, renewed=name in RENEWED)


def test_weighted_valid_metric_matches_reference():
    # a valid set's weights enter its metrics: the port's equal the
    # reference's (rtol 1e-5: f32 there, f64 here) and the weighted means
    # of the port's own predictions
    X, y, w = _data(63, "regression", seed=2)
    out = []
    for mod in (lgb, lt):
        p = dict(BASE, objective="regression", max_bin=63, metric="l2,l1",
                 **(CPU if mod is lt else {}))
        ds = mod.Dataset(X[:300], label=y[:300], weight=w[:300], params=p)
        valid = mod.Dataset(X[300:], label=y[300:], weight=w[300:],
                            reference=ds)
        res = {}
        bst = mod.train(p, ds, num_boost_round=3, valid_sets=[valid],
                        valid_names=["v"], evals_result=res,
                        verbose_eval=False)
        out.append(res["v"])
    want, got = out
    err = bst.predict(X[300:]) - y[300:]
    wv = w[300:].astype(np.float64)
    for metric, loss in (("l2", err ** 2), ("l1", np.abs(err))):
        np.testing.assert_allclose(got[metric], want[metric], rtol=1e-5)
        # the valid scores sum the trees in f32, predict in f64
        np.testing.assert_allclose(got[metric][-1],
                                   np.sum(wv * loss) / wv.sum(), rtol=1e-6)
        assert abs(got[metric][-1] - loss.mean()) > 1e-6


def test_dataset_weight_length_is_checked():
    X, y, w = _data(63, "regression")
    with pytest.raises(lt.basic.LightGBMError, match="length of weight"):
        lt.Dataset(X, label=y, weight=w[:10], params=CPU).construct()
