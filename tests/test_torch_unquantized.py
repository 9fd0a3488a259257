"""End-to-end parity of the port's unquantized paths with the JAX reference,
on the CPU: the depthwise grower with use_quantized_grad=false and the
leaf-wise grower (grow_policy=lossguide, which the reference never
quantizes). Both build their histograms through hist_f32, whose TPU
counterpart is hist_pallas.

The reference trains on its Pallas kernels in interpret mode
(histogram_impl=pallas); the port trains with device_type="cpu", i.e. on
the kernels' plain versions. Each path runs at max_bin=31 (400 rows) and at
the default max_bin=255 (600 rows, B = 256).

Exact: on exact-sum L2 data (labels on a 1/8 grid in [0, 4), no init
score, so the first tree's gradients are -label and h = 1, and every
histogram sum is exact in any order) the first tree equals the
reference's bit for bit, leaf values included; the structure of the
first tree on general binary and L2 data; the use_quantized_grad
resolution; the model text round trip. Tolerance: predictions after 3
iterations on general data rtol 1e-4, raw scores rtol 1e-4 with atol
1e-6 for those near 0 (the reference's hi/lo histograms keep 16
significant bits a row, so later gradients differ in their last bits).
"""
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import hist_kernels as hk
from test_torch_train import CPU, STRUCT, _data, _data255
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

BASE = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1,
        "prewarm": 0, "histogram_impl": "pallas"}
PATHS = {"lossguide": {"grow_policy": "lossguide"},
         "f32": {"use_quantized_grad": "false"}}
TREE = STRUCT + ("leaf_value", "leaf_weight", "leaf_count", "split_gain",
                 "internal_value", "internal_weight", "internal_count")


def _exact_labels(X):
    rng = np.random.RandomState(9)
    return np.clip(np.floor((X[:, 1] * 2.0 + rng.rand(X.shape[0])) * 8) / 8,
                   0, 3.875).astype(np.float32)


@pytest.fixture(scope="module",
                params=[(p, mb) for p in PATHS for mb in (31, 255)],
                ids=lambda v: f"{v[0]}-{v[1]}")
def trained(request):
    """Reference and port models of one path at one bin count: the
    exact-sum L2 model (1 iteration) and binary and L2 models (3)."""
    path, max_bin = request.param
    X, yb, yr = _data255() if max_bin == 255 else _data()
    base = dict(BASE, max_bin=max_bin, **PATHS[path])
    out = {}
    for name, objective, y, rounds, extra in (
            ("exact", "regression", _exact_labels(X), 1,
             {"boost_from_average": False}),
            ("binary", "binary", yb, 3, {}),
            ("regression", "regression", yr, 3, {})):
        p = dict(base, objective=objective, **extra)
        ref = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                        num_boost_round=rounds)
        pt = dict(p, **CPU)
        port = lt.train(pt, lt.Dataset(X, label=y, params=pt),
                        num_boost_round=rounds)
        out[name] = (ref, port)
    return path, max_bin, X, out


def test_first_tree_bit_identical_on_exact_sums(trained):
    path, max_bin, X, out = trained
    ref, port = out["exact"]
    assert not ref._gbdt.gp.quant and not port._gbdt.gp.quant
    if max_bin == 255:
        assert port._gbdt.gp.max_bin == 256
    (a,), (b,) = ref._gbdt.finalize(), port._host_trees()
    assert b.num_leaves == a.num_leaves > 4
    for name in TREE:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_three_iterations_within_rtol(trained, objective):
    # the first tree's structure exactly; predictions rtol 1e-4
    path, _, X, out = trained
    ref, port = out[objective]
    rt, pt = ref._gbdt.finalize(), port._host_trees()
    assert len(rt) == len(pt) == 3
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(pt[0], name),
                                      getattr(rt[0], name), err_msg=name)
    # raw scores near 0 (binary) take an absolute bound: a gap of a few
    # 1e-7 there is no relative 1e-4
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)
    passes = port._gbdt.hist_passes
    if path == "lossguide":
        assert passes == [t.num_leaves - 1 for t in pt]


def test_model_text_roundtrip(trained, tmp_path):
    _, _, X, out = trained
    _, port = out["binary"]
    path = str(tmp_path / "model.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    np.testing.assert_array_equal(loaded.predict(X), port.predict(X))
    assert loaded.model_to_string() == port.model_to_string()


@pytest.mark.parametrize("grow_policy", ["depthwise", "lossguide"])
@pytest.mark.parametrize("uq", ["auto", "true", "false"])
def test_quantized_grad_resolution_matches_reference(uq, grow_policy,
                                                     caplog):
    # exact: the reference on its kernel path turns int8 histograms on for
    # auto and true with the depthwise grower only, and warns when true
    # meets lossguide
    X, yb, _ = _data()
    p = dict(BASE, objective="binary", max_bin=31, use_quantized_grad=uq,
             grow_policy=grow_policy)
    ref = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=yb, params=p))
    pt = dict(p, **CPU)
    port = lt.Booster(params=pt, train_set=lt.Dataset(X, label=yb,
                                                      params=pt))
    assert port._gbdt.gp.quant == ref._gbdt.gp.quant
    assert port._gbdt.gp.quant == (uq != "false"
                                   and grow_policy == "depthwise")
    warned = any("use_quantized_grad only applies" in r.getMessage()
                 for r in caplog.records if r.name == "lightgbm_tpu_torch")
    assert warned == (uq == "true" and grow_policy == "lossguide")


@pytest.mark.parametrize("path", list(PATHS))
def test_unquantized_l2_has_no_const_hess_or_fused_front(path, monkeypatch):
    # the reference sets const-hessian elision and the fused front only
    # under quantization (gbdt.py:714-719, 737-744): an unquantized L2
    # booster at a width the fused kernels take (F * B = 8 * 32) has
    # neither, and launches none of the quantized kernels (B1-B3, B5, B7)
    calls = {k: 0 for k in hk.KERNELS}
    for name in hk.KERNELS:
        fn = getattr(hk, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(hk, name, spy)
    X, _, yr = _data()
    p = dict(BASE, objective="regression", max_bin=31, **PATHS[path], **CPU)
    bst = lt.train(p, lt.Dataset(X, label=yr, params=p), num_boost_round=2)
    gp = bst._gbdt.gp
    assert not gp.quant and not gp.const_hess and gp.fused_obj is None
    assert all(calls[k] == 0 for k in ("grad_quant_hist0",
                                       "hist_routed_fused", "leaf_sums_grad",
                                       "hist_q8", "leaf_sums")), calls
    assert calls["hist_f32"] > 2 and calls["take_small"] == 2
