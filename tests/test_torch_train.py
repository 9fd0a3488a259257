"""End-to-end parity of the PyTorch/CUDA port (lightgbm_tpu_torch) with the
JAX reference (lightgbm_tpu), on the CPU, plus the port's boundaries.

The reference trains on its Pallas kernels in interpret mode
(histogram_impl=pallas, use_quantized_grad=true, as in
tests/test_megapass.py); the port trains with device_type="cpu", i.e. on
the kernels' plain versions.

Exact: parameter resolution, bin mappers and bins, the structure of every
tree of a 3-iteration L2 model and of the first binary tree
(split_feature, threshold_bin, default_left, children), at max_bin=31
(the fused path) and at the default max_bin=255 (B = 256, F * B > 2048:
the unfused path), save/load predictions, the L2 objective's gradients.
Tolerances: leaf values and predictions after 3 iterations rtol 1e-4 —
the reference renews leaf values from bf16 hi/lo sums (16 significant
bits per row) and every later gradient inherits that gap; predictions of
a loaded reference model rtol 1e-6 — the reference sums leaf values in
f32, the port in f64; the logloss objective's gradients within the CPU
exp gap (queue C1).
"""
import ast
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import binning as ref_binning
from lightgbm_tpu import config as ref_config
from lightgbm_tpu import metrics as ref_metrics
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import binning as t_binning
from lightgbm_tpu_torch import config as t_config
from lightgbm_tpu_torch import metrics as t_metrics
from lightgbm_tpu_torch.convert import (booster_from_model_text,
                                        mappers_from_reference)
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.models.gbdt import padded_bins
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops.histogram import ACC_ROWS_MAX
from lightgbm_tpu_torch.parallel.mesh import virtual_devices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
PALLAS_PARAMS = {"num_leaves": 7, "max_bin": 31, "min_data_in_leaf": 5,
                 "verbosity": -1, "prewarm": 0, "histogram_impl": "pallas",
                 "use_quantized_grad": "true"}
CPU = {"device_type": "cpu"}
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child")


def _data():
    rng = np.random.RandomState(0)
    X = rng.rand(400, 8).astype(np.float32)
    X[rng.rand(400) < 0.05, 5] = np.nan
    yb = (X[:, 0] + 0.3 * rng.rand(400) > 0.65).astype(np.float32)
    # L2 labels on a 1/8 grid: their f32 mean is exact in any summation
    # order, so both packages start from the same boost-from-average score
    yr = (np.round((X[:, 1] * 2.0 + rng.rand(400)) * 8) / 8).astype(
        np.float32)
    return X, yb, yr


def _data255():
    """Rows enough for more than 128 bins a feature at max_bin=255 (600
    uniform rows give about 200 at min_data_in_bin=3, so B = 256) on 9
    features: F * B = 2304 > 2048, the unfused path."""
    rng = np.random.RandomState(5)
    X = rng.rand(600, 9).astype(np.float32)
    X[rng.rand(600) < 0.05, 5] = np.nan
    yb = (X[:, 0] + 0.3 * rng.rand(600) > 0.65).astype(np.float32)
    yr = (np.round((X[:, 1] * 2.0 + rng.rand(600)) * 8) / 8).astype(
        np.float32)
    return X, yb, yr


@pytest.fixture(scope="module")
def models():
    X, yb, yr = _data()
    out = {}
    for objective, y in (("binary", yb), ("regression", yr)):
        p = dict(PALLAS_PARAMS, objective=objective)
        ref = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                        num_boost_round=3)
        pt = dict(p, **CPU)
        port = lt.train(pt, lt.Dataset(X, label=y, params=pt),
                        num_boost_round=3)
        out[objective] = (ref, port)
    return X, out


@pytest.mark.parametrize("params", [
    {},
    {"objective": "binary", "num_leaves": 255, "max_bin": 63, "eta": 0.05,
     "min_data": 20, "reg_lambda": 1.5, "sub_row": 1.0},
    {"application": "regression", "num_iteration": 7, "max_leaves": 15,
     "min_child_weight": 0.5, "histogram_impl": "pallas",
     "hist_packed": "false", "seed": 11, "metric": "auc,l2"},
    {"device": "cpu", "max_bin": 400, "use_missing": "false",
     "max_bin_by_feature": "4,5,6", "verbose": -1},
])
def test_config_resolution_matches_reference(params):
    # exact: every parameter resolves to the same value in both packages
    # (device_type excepted: the port's default is "cuda")
    ref = ref_config.params_to_config(params).to_dict()
    got = t_config.params_to_config(params).to_dict()
    ref.pop("device_type"), got.pop("device_type")
    assert got == ref
    for key in params:
        assert t_config.canonical_name(key) == ref_config.canonical_name(key)


def test_device_type_defaults_to_cuda():
    assert t_config.Config().device_type == "cuda"
    assert t_config.Config({"device": "cpu"}).device_type == "cpu"


def test_binning_exact_and_converted_mappers():
    # exact mappers and bins on data with NaNs, zeros, negatives, a
    # constant column and a row sample (sample_cnt < N)
    rng = np.random.RandomState(3)
    X = rng.randn(600, 6)
    X[rng.rand(600) < 0.1, 0] = np.nan
    X[rng.rand(600) < 0.3, 1] = 0.0
    X[:, 2] = np.round(X[:, 2] * 3)
    X[:, 3] = 1.0
    kw = dict(max_bin=15, min_data_in_bin=3, sample_cnt=500, seed=7)
    ref_m = ref_binning.find_bin_mappers(X, **kw)
    got_m = t_binning.find_bin_mappers(X, **kw)
    conv = mappers_from_reference([dataclasses.asdict(m) for m in ref_m])
    for r, g, c in zip(ref_m, got_m, conv):
        for m in (g, c):
            assert m.num_bins == r.num_bins and m.default_bin == r.default_bin
            assert m.missing_type == r.missing_type
            assert m.is_trivial == r.is_trivial and m.na_bin == r.na_bin
            np.testing.assert_array_equal(m.upper_bounds, r.upper_bounds)
    ref_bd = ref_binning.bin_data(X, ref_m)
    used = t_binning.used_features(got_m)
    assert used == list(ref_bd.feature_map)
    bins = t_binning.bin_data(X, [got_m[j] for j in used], used,
                              torch.device("cpu"))
    np.testing.assert_array_equal(bins.numpy(), ref_bd.bins)


def _trees(ref, port):
    return ref._gbdt.finalize(), port._host_trees()


def test_l2_every_tree_structure_exact(models):
    X, out = models
    ref, port = out["regression"]
    rt, pt = _trees(ref, port)
    assert len(rt) == len(pt) == 3
    for a, b in zip(rt, pt):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)


@pytest.mark.parametrize("extra", [
    {"lambda_l1": 0.5, "lambda_l2": 2.0, "max_depth": 3, "num_leaves": 15,
     "min_gain_to_split": 0.01, "max_delta_step": 0.8},
    {"zero_as_missing": True, "min_sum_hessian_in_leaf": 4.0,
     "learning_rate": 0.3},
])
def test_l2_options_tree_structure_exact(extra):
    # exact structure of every tree under the split options the slice
    # ports; leaf values and predictions rtol 1e-4 (queue C2)
    X, _, yr = _data()
    X[np.random.RandomState(2).rand(*X.shape) < 0.1] = 0.0
    p = dict(PALLAS_PARAMS, objective="regression", **extra)
    ref = lgb.train(p, lgb.Dataset(X, label=yr, params=p), num_boost_round=3)
    pt = dict(p, **CPU)
    port = lt.train(pt, lt.Dataset(X, label=yr, params=pt), num_boost_round=3)
    rt, ptr = _trees(ref, port)
    assert len(rt) == len(ptr) == 3
    for a, b in zip(rt, ptr):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)


def test_binary_first_tree_structure_exact(models):
    X, out = models
    ref, port = out["binary"]
    rt, pt = _trees(ref, port)
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(pt[0], name),
                                      getattr(rt[0], name), err_msg=name)
    np.testing.assert_allclose(pt[0].leaf_value, rt[0].leaf_value, rtol=1e-4)
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)


@pytest.fixture(scope="module")
def models255():
    X, yb, yr = _data255()
    out = {}
    for objective, y in (("binary", yb), ("regression", yr)):
        p = dict(PALLAS_PARAMS, objective=objective, max_bin=255,
                 num_leaves=15)
        ref = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                        num_boost_round=3)
        pt = dict(p, **CPU)
        ds = lt.Dataset(X, label=y, params=pt)
        port = lt.train(pt, ds, num_boost_round=3)
        out[objective] = (ref, port, ds)
    return X, out


def test_max_bin_255_takes_the_unfused_path(models255):
    _, out = models255
    for _ref, port, ds in out.values():
        assert ds.max_num_bins > 128
        assert ds.num_features * padded_bins(ds.max_num_bins) > ACC_ROWS_MAX
        assert port._gbdt.gp.max_bin == 256
        assert port._gbdt.gp.fused_obj is None
        assert min(port._gbdt.hist_passes) >= 2


def test_max_bin_255_l2_every_tree_structure_exact(models255):
    # exact structure of every tree; leaf values and predictions rtol 1e-4
    # (queue C2)
    X, out = models255
    ref, port, _ = out["regression"]
    rt, pt = _trees(ref, port)
    assert len(rt) == len(pt) == 3
    for a, b in zip(rt, pt):
        assert b.num_leaves > 4
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)
    np.testing.assert_array_equal(port.predict(X, pred_leaf=True),
                                  np.asarray(ref.predict(X, pred_leaf=True)))


def test_max_bin_255_binary_first_tree_structure_exact(models255):
    X, out = models255
    ref, port, _ = out["binary"]
    rt, pt = _trees(ref, port)
    assert pt[0].num_leaves > 4
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(pt[0], name),
                                      getattr(rt[0], name), err_msg=name)
    np.testing.assert_allclose(pt[0].leaf_value, rt[0].leaf_value, rtol=1e-4)
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_max_bin_255_model_text_roundtrip(models255, objective, tmp_path):
    # thresholds up to bin 255 survive the text; the loaded model predicts
    # identically and writes the same text
    X, out = models255
    ref, port, _ = out[objective]
    path = str(tmp_path / "model.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    np.testing.assert_array_equal(loaded.predict(X), port.predict(X))
    assert loaded.model_to_string() == port.model_to_string()
    conv = booster_from_model_text(ref.model_to_string(), params=CPU)
    np.testing.assert_allclose(conv.predict(X), ref.predict(X), rtol=1e-6)


def test_max_bin_255_mappers_convert_from_reference():
    # exact: the reference's 255-bin mappers convert to the port's own
    X, _, _ = _data255()
    kw = dict(max_bin=255, min_data_in_bin=3)
    ref_m = ref_binning.find_bin_mappers(X, **kw)
    got_m = t_binning.find_bin_mappers(X, **kw)
    conv = mappers_from_reference([dataclasses.asdict(m) for m in ref_m])
    assert max(m.num_bins for m in ref_m) > 128
    for r, g, c in zip(ref_m, got_m, conv):
        for m in (g, c):
            assert m.num_bins == r.num_bins and m.na_bin == r.na_bin
            np.testing.assert_array_equal(m.upper_bounds, r.upper_bounds)
    bins = t_binning.bin_data(X, got_m, list(range(X.shape[1])),
                              torch.device("cpu"))
    np.testing.assert_array_equal(bins.numpy(),
                                  ref_binning.bin_data(X, ref_m).bins)


@pytest.mark.parametrize("objective,params", [
    ("regression", {}), ("binary", {}),
    ("binary", {"sigmoid": 0.7, "scale_pos_weight": 2.0})])
def test_objective_gradients_match_reference(objective, params):
    # the unfused path's materialized gradients: L2 exact; logloss within
    # the CPU exp gap of queue C1 (g <= 2 ulp, h <= 8 ulp)
    from lightgbm_tpu import objectives as ref_obj
    from lightgbm_tpu_torch import objectives as t_obj
    import jax.numpy as jnp
    X, yb, yr = _data255()
    y = yr if objective == "regression" else yb
    score = np.random.RandomState(7).normal(size=y.shape[0]).astype(
        np.float32)
    ref = ref_obj.create_objective(objective, ref_config.Config(params))
    ref.init(jnp.asarray(y), None)
    got = t_obj.create_objective(objective, t_config.Config(params))
    got.init(torch.from_numpy(y))
    rg, rh = (np.asarray(a) for a in ref.get_gradients(jnp.asarray(score)))
    g, h = (a.numpy() for a in got.get_gradients(torch.from_numpy(score)))

    def ulps(a, b):
        return np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max()
    if objective == "regression":
        np.testing.assert_array_equal(g, rg)
        np.testing.assert_array_equal(h, rh)
    else:
        assert ulps(g, rg) <= 2 and ulps(h, rh) <= 8


FUSED_KERNELS = ("grad_quant_hist0", "hist_routed_fused", "leaf_sums_grad")
UNFUSED_KERNELS = ("hist_q8", "route_level", "leaf_sums")
F32_KERNELS = ("hist_f32", "route_level")


@pytest.mark.parametrize("max_bin,extra", [
    pytest.param(63, {}, id="63"), pytest.param(255, {}, id="255"),
    pytest.param(255, {"use_quantized_grad": "false"}, id="255-f32"),
    pytest.param(255, {"grow_policy": "lossguide"}, id="255-lossguide")])
def test_path_calls_exactly_its_kernels(monkeypatch, max_bin, extra):
    # spy on the wrappers: the 255-bin model (F * B > 2048) calls hist_q8,
    # route_level and leaf_sums and none of the fused kernels; the 63-bin
    # model the reverse; unquantized depthwise calls hist_f32 once per tree
    # and per level and route_level once per level; lossguide calls
    # hist_f32 once per tree and per split; all update the score through
    # take_small, and no path calls another path's kernels
    calls = {k: 0 for k in hk.KERNELS}
    for name in hk.KERNELS:
        fn = getattr(hk, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(hk, name, spy)
    X, yb, _ = _data255() if max_bin == 255 else _data()
    p = dict(PALLAS_PARAMS, objective="binary", max_bin=max_bin,
             num_leaves=15, **extra, **CPU)
    bst = lt.train(p, lt.Dataset(X, label=yb, params=p), num_boost_round=2)
    trees = bst.num_trees()
    passes = sum(bst._gbdt.hist_passes)
    assert trees == 2 and passes >= 4
    if "grow_policy" in extra:
        used, expected = ("hist_f32",), {"hist_f32": trees + passes}
    elif extra:
        used = F32_KERNELS
        expected = {"hist_f32": trees + passes, "route_level": passes}
    elif max_bin == 255:
        used = UNFUSED_KERNELS
        expected = {"hist_q8": trees + passes, "route_level": passes,
                    "leaf_sums": trees}
    else:
        used, expected = FUSED_KERNELS, {}
    unused = [k for k in hk.KERNELS if k not in used + ("take_small",)]
    assert all(calls[k] == 0 for k in unused), calls
    assert all(calls[k] > 0 for k in used), calls
    assert calls["take_small"] == trees
    for k, v in expected.items():
        assert calls[k] == v, calls


def test_pred_leaf_matches_reference(models):
    # exact leaf indices of every row in every tree (the L2 structures are
    # identical, so the routing must be too)
    X, out = models
    ref, port = out["regression"]
    np.testing.assert_array_equal(port.predict(X, pred_leaf=True),
                                  np.asarray(ref.predict(X, pred_leaf=True)))


def test_model_text_roundtrip_predicts_identically(models, tmp_path):
    X, out = models
    _, port = out["binary"]
    path = str(tmp_path / "model.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    np.testing.assert_array_equal(loaded.predict(X), port.predict(X))
    assert loaded.model_to_string() == port.model_to_string()


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_reference_model_text_loads(models, objective):
    # rtol 1e-6: the reference sums f32 leaf values, the port f64
    X, out = models
    ref, _ = out[objective]
    port = booster_from_model_text(ref.model_to_string(), params=CPU)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-6)
    np.testing.assert_allclose(port.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), rtol=1e-6)


def test_golden_model_reproduces_golden_preds():
    # the frozen reference-format model (with a categorical node); rtol
    # 1e-6: its predictions were written from f32 sums
    bst = lt.Booster(model_file=os.path.join(GOLDEN, "model_v3.txt"),
                     params=CPU)
    Xp = np.loadtxt(os.path.join(GOLDEN, "golden_inputs.txt"))
    expected = np.loadtxt(os.path.join(GOLDEN, "golden_preds.txt"))
    np.testing.assert_allclose(bst.predict(Xp, raw_score=True), expected,
                               rtol=1e-6, atol=1e-12)


def test_eval_metrics_match_reference(models):
    X, yb, yr = _data()
    rng = np.random.RandomState(4)
    prob = np.round(rng.rand(400), 2).astype(np.float32)   # with ties
    for name in ("auc", "binary_logloss"):
        ref = ref_metrics.create_metrics([name], ref_config.Config())[0]
        got = t_metrics.create_metrics([name])[0]
        np.testing.assert_allclose(
            got(torch.from_numpy(yb), torch.from_numpy(prob)),
            ref(np.asarray(yb), np.asarray(prob)), rtol=1e-6)
    for name in ("l2", "rmse"):
        ref = ref_metrics.create_metrics([name], ref_config.Config())[0]
        got = t_metrics.create_metrics([name])[0]
        np.testing.assert_allclose(
            got(torch.from_numpy(yr), torch.from_numpy(prob)),
            ref(np.asarray(yr), np.asarray(prob)), rtol=1e-6)


def test_train_records_valid_metrics():
    X, yb, _ = _data()
    p = dict(PALLAS_PARAMS, objective="binary", metric="auc", **CPU)
    ds = lt.Dataset(X[:300], label=yb[:300], params=p)
    valid = lt.Dataset(X[300:], label=yb[300:], reference=ds)
    res = {}
    bst = lt.train(p, ds, num_boost_round=3, valid_sets=[ds, valid],
                   valid_names=["train", "valid"], evals_result=res)
    assert len(res["training"]["auc"]) == len(res["valid"]["auc"]) == 3
    # the valid scores maintained during training are the model's own
    # predictions on those rows
    got = t_metrics.auc(torch.from_numpy(yb[300:]),
                        torch.from_numpy(bst.predict(X[300:])))
    np.testing.assert_allclose(res["valid"]["auc"][-1], float(got),
                               rtol=1e-9)


def test_default_device_needs_a_gpu():
    X, yb, _ = _data()
    p = dict(PALLAS_PARAMS, objective="binary")
    if torch.cuda.is_available():
        ds = lt.Dataset(X, label=yb, params=p).construct()
        assert ds.bins.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        lt.train(p, lt.Dataset(X, label=yb, params=p), num_boost_round=1)


# the cases that named A11 (huber, reg_sqrt, multiclass, binary_error) train
# since A11a and are held against the reference in test_torch_objectives.py,
# test_torch_multiclass.py and test_torch_metrics.py; the ranking settings
# (A11b) and boosting=dart|rf (A14) that they then held train since A11b
# and A14 (test_torch_ranking.py, test_torch_boosters.py); categorical_feature
# (A12a) trains since A12a (test_torch_categorical.py). The split
# constraints (forced bins and splits, CEGB, monotone constraints,
# extra_trees, feature_contri) train since A12c: their cases (item None)
# keep their ids and hold the first binary tree against the reference
# (tests/test_torch_constraints.py holds every tree of L2 models on each
# path); histogram_pool_size trains since A13b: its cases keep their ids,
# with budgets that pool 3 of the 7 leaves' histograms (lossguide) and
# cut the 8 columns into lean tiles of 3 (depthwise), held the same way
# (tests/test_torch_lean.py holds every path); the tree learners train
# since A21a: their cases (marked with the virtual device count the port
# runs them on, "_virtual") keep their ids and hold the port on 8 virtual
# CPU devices against the reference on its 8 (the quantized data-parallel
# and voting learners take each shard's own int8 scales and dither in both
# packages; the feature-parallel one runs unquantized in both); more than
# one machine is still refused (A21b)
@pytest.mark.parametrize("extra,item", [
    pytest.param({"forcedbins_filename": "bins.json"}, None,
                 id="extra0-A11"),
    pytest.param({"grow_policy": "lossguide", "histogram_pool_size": 0.018},
                 None, id="extra1-A13b"),
    pytest.param({"cegb_penalty_feature_lazy": [0.5] * 8}, None,
                 id="extra2-A11"),
    pytest.param({"monotone_constraints": [0, 0, 1, 0, 0, 0, 0, 0]}, None,
                 id="extra3-A12"),
    pytest.param({"cegb_penalty_split": 0.1}, None, id="extra4-A12"),
    pytest.param({"extra_trees": True}, None, id="extra5-A12"),
    pytest.param({"feature_contri": [1.0, 1.0, 1.0, 0.5, 1.0, 1.0, 1.0,
                                     1.0]}, None, id="extra6-A12"),
    pytest.param({"cegb_penalty_feature_coupled": [0.5] * 8}, None,
                 id="extra7-A14"),
    pytest.param({"tree_learner": "feature", "_virtual": 8}, None,
                 id="extra8-A14"),
    pytest.param({"tree_learner": "voting", "top_k": 4, "_virtual": 8},
                 None, id="extra9-A11"),
    pytest.param({"histogram_pool_size": 0.014}, None, id="extra10-A13b"),
    pytest.param({"tree_learner": "data", "_virtual": 8}, None,
                 id="extra11-A21"),
    pytest.param({"monotone_constraints": [-1, 0, 0, 0, 0, 0, 0, 0],
                  "grow_policy": "lossguide"}, None, id="extra12-A12"),
    pytest.param({"num_machines": 2}, "A21b", id="extra13-A11"),
    pytest.param({"forcedsplits_filename": "forced.json"}, None,
                 id="extra14-A12"),
])
def test_out_of_slice_settings_raise(extra, item, tmp_path):
    X, yb, _ = _data()
    p = dict(PALLAS_PARAMS, objective="binary", **CPU)
    p.update(extra)
    n_virtual = p.pop("_virtual", 0)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            lt.train(p, lt.Dataset(X, label=yb, params=p), num_boost_round=1)
        return
    # exact: the first binary tree (queue C1) equals the reference's;
    # predictions after 2 iterations rtol 1e-4 (queue C2)
    files = {"bins.json": [{"feature": 0, "bin_upper_bound": [0.3, 0.65]}],
             "forced.json": {"feature": 1, "threshold": 0.5,
                             "left": {"feature": 0, "threshold": 0.6}}}
    for key in ("forcedbins_filename", "forcedsplits_filename"):
        if key in p:
            fn = tmp_path / p[key]
            fn.write_text(json.dumps(files[p[key]]))
            p[key] = str(fn)
    ref_p = {k: v for k, v in p.items() if k != "device_type"}
    ref = lgb.train(ref_p, lgb.Dataset(X, label=yb, params=ref_p), 2)
    with (virtual_devices(n_virtual, "cpu") if n_virtual
          else contextlib.nullcontext()):
        port = lt.train(p, lt.Dataset(X, label=yb, params=p), 2)
    if n_virtual:
        gb = port._gbdt
        assert gb._fp if extra["tree_learner"] == "feature" else (
            gb._dp and gb._shard_plan.num_shards == n_virtual)
    rt, ptr = _trees(ref, port)
    assert len(rt) == len(ptr) == 2
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(ptr[0], name),
                                      getattr(rt[0], name), err_msg=name)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)
    if "forcedbins_filename" in p:
        np.testing.assert_array_equal(port.train_set.mappers[0].upper_bounds,
                                      [0.3, 0.65, np.inf])
    if "forcedsplits_filename" in p:
        assert ptr[0].split_feature[0] == 1
        assert ptr[0].split_feature[ptr[0].left_child[0]] == 0
    if "histogram_pool_size" in p:
        gp, rgp = port._gbdt.gp, ref._gbdt.gp
        assert (gp.hist_pool, gp.lean_ft) == (rgp.hist_pool, rgp.lean_ft)
        assert (gp.hist_pool, gp.lean_ft) in ((3, 0), (0, 3))


def test_bagging_fraction_without_bagging_freq_trains_as_reference():
    # the reference bags only when bagging_freq > 0, so bagging_fraction
    # below 1 alone trains the unbagged model in both packages: exact
    # against each one's own run without the fraction; against the
    # reference, tree structures exact, predictions rtol 1e-4 (queue C2)
    rng = np.random.RandomState(0)
    X = rng.rand(200, 3).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    runs = {}
    for frac in (0.5, 1.0):
        p = dict(PALLAS_PARAMS, objective="binary", num_leaves=4,
                 bagging_fraction=frac)
        ref = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                        num_boost_round=2)
        pt = dict(p, **CPU)
        runs[frac] = (ref, lt.train(pt, lt.Dataset(X, label=y, params=pt),
                                    num_boost_round=2))
    (ref, port), (ref1, port1) = runs[0.5], runs[1.0]
    np.testing.assert_array_equal(port.predict(X), port1.predict(X))
    np.testing.assert_array_equal(ref.predict(X), ref1.predict(X))
    rt, ptr = _trees(ref, port)
    assert len(rt) == len(ptr) == 2
    for a, b in zip(rt, ptr):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name), err_msg=name)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)


# row weights train since A11a (test_torch_objectives.py), Dataset group
# since A11b (test_torch_ranking.py) and init_score since A14
# (test_torch_boosters.py): those cases held sparse and pandas input under
# their old ids; categorical_feature trains since A12a
# (test_torch_categorical.py), and its case held a pandas categorical
# column under its old id. Sparse and pandas input train since A12b: the
# test keeps its name and ids and holds each input against the reference
@pytest.mark.parametrize("kind", [
    pytest.param("sparse", id="kw0-A11"),
    pytest.param("pandas_categorical", id="kw1-A12"),
    pytest.param("pandas", id="kw2-A14")])
def test_out_of_slice_dataset_arguments_raise(kind):
    # exact: the first tree of a binary model (structure, categories; queue
    # C1) trained from a CSR matrix, a DataFrame with a category column
    # ("auto" takes it as categorical) or a numeric DataFrame equals the
    # reference's on the same input; predictions of that tree rtol 1e-4
    # (queue C2) on the same input
    X, yb, _ = _data()
    pd = (pytest.importorskip("pandas") if kind.startswith("pandas")
          else None)
    data = {"sparse": lambda: __import__("scipy.sparse").sparse.csr_matrix(X),
            "pandas": lambda: pd.DataFrame(X),
            "pandas_categorical": lambda: pd.DataFrame(
                {"c": pd.Categorical(np.round(X[:, 0] * 4)),
                 "x": X[:, 1]})}[kind]()
    p = dict(PALLAS_PARAMS, objective="binary")
    ref = lgb.train(p, lgb.Dataset(data, label=yb, params=p), 2)
    port = lt.train(dict(p, **CPU), lt.Dataset(data, label=yb,
                                               params=dict(p, **CPU)), 2)
    rt, ptr = _trees(ref, port)
    for name in STRUCT + ("is_cat_node",):
        np.testing.assert_array_equal(getattr(ptr[0], name),
                                      getattr(rt[0], name), err_msg=name)
    assert ptr[0].is_cat_node.any() == (kind == "pandas_categorical")
    np.testing.assert_allclose(port.predict(data, num_iteration=1),
                               ref.predict(data, num_iteration=1), rtol=1e-4)


@pytest.mark.parametrize("exclusive", [True, False])
def test_refuses_exactly_the_data_the_reference_bundles(exclusive):
    # the data the reference bundles (mutually exclusive sparse columns)
    # and the data it does not (sparse columns that overlap) both train;
    # the port bundles exactly where the reference does (EFB, A12b), and
    # its first tree equals the reference's (structure exact, queue C1);
    # with bundling off the same data trains unbundled
    rng = np.random.RandomState(1)
    X, yb, _ = _data()
    X[:, :4] = 0.0
    which = rng.randint(0, 4, 400)
    for j in range(4):
        rows = (which == j) & (rng.rand(400) < 0.6) if exclusive \
            else rng.rand(400) < 0.15
        X[rows, j] = 1.0 + j
    p = dict(PALLAS_PARAMS, objective="binary")
    ref_ds = lgb.Dataset(X, label=yb, params=p).construct()
    assert (ref_ds.bundle_meta is not None) == exclusive
    pt = dict(p, **CPU)
    if exclusive:
        ref = lgb.train(p, ref_ds, 1)
        port = lt.train(pt, lt.Dataset(X, label=yb, params=pt), 1)
        assert port.train_set.bundle_meta is not None
        rt, ptr = _trees(ref, port)
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(ptr[0], name),
                                          getattr(rt[0], name), err_msg=name)
        np.testing.assert_allclose(port.predict(X), ref.predict(X),
                                   rtol=1e-4)
        pt["enable_bundle"] = False
    off = lt.train(pt, lt.Dataset(X, label=yb, params=pt), 1)
    assert off.num_trees() and off.train_set.bundle_meta is None


def test_train_feature_name_matches_reference():
    # C8: train(feature_name=) names the train set's features; the model
    # text's feature_names= line equals the reference's
    rng = np.random.RandomState(0)
    X = rng.rand(200, 3)
    y = (X[:, 0] > 0.5).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 4, "verbosity": -1,
         "prewarm": 0}
    names = ["a", "b", "c"]
    ref = lgb.train(p, lgb.Dataset(X, label=y), 2, feature_name=names,
                    verbose_eval=False)
    port = lt.train(dict(p, **CPU), lt.Dataset(X, label=y), 2,
                    feature_name=names, verbose_eval=False)
    line = [ln for ln in port.model_to_string().splitlines()
            if ln.startswith("feature_names=")]
    assert line == [ln for ln in ref.model_to_string().splitlines()
                    if ln.startswith("feature_names=")]
    assert line == ["feature_names=a b c"]


def test_train_parameters_in_reference_order():
    # C8: train's parameters, their order and defaults are the
    # reference's, resume_from_snapshot included (A16), so a positional
    # call binds alike
    import inspect
    ref = [(q.name, q.default) for q in
           inspect.signature(lgb.train).parameters.values()]
    port = [(q.name, q.default) for q in
            inspect.signature(lt.train).parameters.values()]
    assert port == ref


def test_train_categorical_feature_matches_reference():
    # C8: train(categorical_feature=[0]) trains column 0 as categorical, as
    # the reference: first binary tree exact with its categories (queue
    # C1), predictions rtol 1e-4 (queue C2)
    X, yb, _ = _data()
    X = X.copy()
    X[:, 0] = np.floor(X[:, 0] * 9)
    p = dict(PALLAS_PARAMS, objective="binary", max_cat_to_onehot=2,
             cat_smooth=1.0, min_data_per_group=5)
    ref = lgb.train(p, lgb.Dataset(X, label=yb, params=p), 2,
                    categorical_feature=[0], verbose_eval=False)
    pt = dict(p, **CPU)
    port = lt.train(pt, lt.Dataset(X, label=yb, params=pt), 2,
                    categorical_feature=[0], verbose_eval=False)
    rt, ptr = _trees(ref, port)
    for name in STRUCT + ("is_cat_node",):
        np.testing.assert_array_equal(getattr(ptr[0], name),
                                      getattr(rt[0], name), err_msg=name)
    assert ptr[0].is_cat_node.any()
    for a, b in zip(rt[0].cat_sets, ptr[0].cat_sets):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4)


def test_custom_objective_raises():
    # custom objectives train since A11a (test_torch_custom.py); what still
    # raises is a custom objective without gradients, and gradients of the
    # wrong size
    X, yb, _ = _data()
    p = dict(PALLAS_PARAMS, objective="none", **CPU)
    with pytest.raises(LightGBMError, match="fobj"):
        lt.train(p, lt.Dataset(X, label=yb, params=p), 1)
    p["objective"] = "binary"
    with pytest.raises(LightGBMError, match="grad"):
        lt.train(p, lt.Dataset(X, label=yb, params=p), 1,
                 fobj=lambda s, d: (s[:10], s[:10]))


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert, "
            "lightgbm_tpu_torch.ops.hist_kernels; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'lightgbm_tpu' or "
            "m.startswith('lightgbm_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _port_files():
    for root, _dirs, files in os.walk(os.path.join(REPO, "lightgbm_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_neither_jax_nor_reference():
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for nm in names:
                top = nm.split(".")[0]
                assert top not in ("jax", "jaxlib", "lightgbm_tpu"), \
                    f"{path} imports {nm}"


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    # exits non-zero and prints no result line without a card, and outside
    # a checkout of the repository
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(lone), str(tmp_path))):
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
