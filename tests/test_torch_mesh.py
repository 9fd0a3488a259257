"""Mesh-native data-parallel training of the PyTorch/CUDA port
(lightgbm_tpu_torch/parallel/), on the CPU: the cases of the reference's
tests/test_mesh_training.py on the port, with ``virtual_devices(8, "cpu")``
on the port's side and the reference's 8 virtual XLA devices (conftest.py)
on the other, plus the C15 fault (the mesh knobs were read nowhere).

Exact: on gradients of a dyadic lattice (multiples of 2^-9, hessian 0.25)
every histogram and leaf sum is exact in f32, so a model trained on 2, 8
or 2 x 2 (rows x feature blocks) shards equals the one-shard model byte
for byte, in the port as in the reference, and the port's sharded trees
equal the reference's sharded trees (structure and leaf values) bit for
bit. 4097 rows make shards of ceil(4097 / 8) = 513 rows, the last one
506 real rows and 7 padding rows. Off the lattice (the binary objective)
the shards' sums round in another order: predictions within atol 1e-5 of
the one-shard model (the reference's own tolerance). Both packages run unquantized, as
the reference's ``use_quantized_grad=auto`` does on the CPU.
"""
import hashlib
import logging

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.parallel.mesh import (device_count, local_devices,
                                              make_mesh, pad_rows_to_devices,
                                              plan_row_sharding, replicate,
                                              resolve_num_shards, shard_rows,
                                              virtual_devices)

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

N = 4097            # non-divisible by 8: the last shard's padding
F = 10
ROUNDS = 5
CPU = {"device_type": "cpu"}
_P = {"objective": "none", "num_leaves": 15, "learning_rate": 0.1,
      "min_data_in_leaf": 5, "verbose": -1, "seed": 3, "metric": "l2",
      "use_quantized_grad": False, "prewarm": 0}
_STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
           "right_child", "leaf_value", "leaf_weight", "leaf_count")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, F)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.25 * X[:, 2] ** 2 > 0).astype(
        np.float32)
    return X, y


@pytest.fixture
def mesh8():
    with virtual_devices(8, "cpu") as devs:
        yield devs


def _lattice_fobj(preds, train_data):
    labels = train_data.get_label()
    g = np.round((np.asarray(preds, np.float64) - labels) * 512.0) / 512.0
    return g.astype(np.float32), np.full(g.shape, 0.25, np.float32)


def _train(X, y, num_shards, rounds=ROUNDS, pkg=lt, **extra):
    params = {**_P, "num_shards": num_shards, **extra}
    if pkg is lt:
        params.update(CPU)
    ds = pkg.Dataset(X, label=y, params=params)
    evals = {}
    bst = pkg.train(params, ds, num_boost_round=rounds, fobj=_lattice_fobj,
                    valid_sets=[ds], valid_names=["train"],
                    evals_result=evals, verbose_eval=False)
    return bst, evals


def _tree_section(model_str):
    """The model text without its parameter echo, which differs by
    construction (num_shards, feature_shards)."""
    return model_str.split("\nparameters:\n")[0]


def test_plan_published_and_sharded(data, mesh8):
    X, y = data
    ds = lt.Dataset(X, label=y, params={"num_shards": 8, "verbose": -1,
                                        **CPU})
    ds.construct()
    plan = ds.shard_plan
    assert plan is not None and plan.num_shards == 8
    assert plan.n_rows == N
    assert plan.n_padded == plan.num_shards * plan.rows_per_shard
    assert plan.pad_rows == plan.n_padded - N
    # one contiguous block a shard, each on its shard's device, the
    # padding rows zero; their real rows are the Dataset's bins
    assert len(ds.shard_bins) == 8
    assert all(b.shape == (plan.rows_per_shard, ds.num_features)
               and b.is_contiguous() for b in ds.shard_bins)
    assert [b.device for b in ds.shard_bins] == plan.devices
    lo, hi = plan.shard_rows_range(7)
    assert (hi - lo, plan.pad_rows) == (506, 7)
    assert not ds.shard_bins[-1][hi - lo:].any()
    assert np.array_equal(np.concatenate([b.numpy() for b in
                                          ds.shard_bins])[:N],
                          ds.bins.numpy())
    assert ds.num_data == N         # padding never leaks into the API
    flat = lt.Dataset(X, label=y, params={"verbose": -1, **CPU}).construct()
    assert flat.shard_plan is None
    assert np.array_equal(flat.bins.numpy(), ds.bins.numpy())


@pytest.mark.parametrize("num_shards", [2, 8])
def test_sharded_training_bit_identical(data, mesh8, num_shards):
    X, y = data
    b1, ev1 = _train(X, y, num_shards=1)
    bk, evk = _train(X, y, num_shards=num_shards)
    s1 = _tree_section(b1.model_to_string())
    sk = _tree_section(bk.model_to_string())
    assert hashlib.sha256(s1.encode()).hexdigest() == \
        hashlib.sha256(sk.encode()).hexdigest()
    assert ev1 == evk
    np.testing.assert_array_equal(b1.predict(X), bk.predict(X))
    # exact across the packages too: the reference's sharded trees on its
    # 8 virtual devices, structure and leaf values bit for bit
    ref, _ = _train(X, y, num_shards=num_shards, pkg=lgb)
    rt, pt = ref._gbdt.finalize(), bk._host_trees()
    assert len(rt) == len(pt) == ROUNDS
    for a, b in zip(rt, pt):
        for name in _STRUCT:
            np.testing.assert_array_equal(np.asarray(getattr(b, name)),
                                          np.asarray(getattr(a, name)),
                                          err_msg=name)


def test_sharded_training_divisible_rows(data, mesh8):
    """8 | 4096: the padding is empty."""
    X, y = data
    X, y = X[:4096], y[:4096]
    b1, _ = _train(X, y, num_shards=1, rounds=3)
    b8, _ = _train(X, y, num_shards=8, rounds=3)
    assert _tree_section(b1.model_to_string()) == \
        _tree_section(b8.model_to_string())


def test_two_d_mesh_bit_identical(data, mesh8):
    """A 2-D (data, feature) mesh: 4 row shards x 2 feature blocks, each
    histogram sum split into 2 blocks of 5 features, equals the 1-D
    4-shard model byte for byte, and the reference's 2-D trees."""
    X, y = data
    b4, _ = _train(X, y, num_shards=4, rounds=3)
    b2d, _ = _train(X, y, num_shards=4, rounds=3, feature_shards=2)
    assert _tree_section(b4.model_to_string()) == \
        _tree_section(b2d.model_to_string())
    ref, _ = _train(X, y, num_shards=4, rounds=3, feature_shards=2, pkg=lgb)
    for a, b in zip(ref._gbdt.finalize(), b2d._host_trees()):
        for name in _STRUCT:
            np.testing.assert_array_equal(np.asarray(getattr(b, name)),
                                          np.asarray(getattr(a, name)),
                                          err_msg=name)


def test_builtin_objective_close_across_shards(data, mesh8):
    """The binary objective's gradients are off the lattice: the shards'
    sums may round otherwise, predictions within atol 1e-5 (the
    reference's tolerance)."""
    X, y = data
    params = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
              "min_data_in_leaf": 5, "verbose": -1, "seed": 3,
              "use_quantized_grad": False, "prewarm": 0, **CPU}
    p1 = lt.train(dict(params, num_shards=1),
                  lt.Dataset(X, label=y, params=params),
                  num_boost_round=3).predict(X)
    p8 = lt.train(dict(params, num_shards=8),
                  lt.Dataset(X, label=y, params=dict(params, num_shards=8)),
                  num_boost_round=3).predict(X)
    np.testing.assert_allclose(p1, p8, rtol=0, atol=1e-5)


def test_mesh_shard_commit_telemetry(data, mesh8):
    """One mesh_shard_commit event a committed chunk, every shard id of
    [0, 8) among them, their rows summing to N."""
    X, y = data
    obs.configure(enabled=True)
    obs.reset()
    try:
        ds = lt.Dataset(X, label=y, params={"num_shards": 8, "verbose": -1,
                                            "ingest_chunk_rows": 300, **CPU})
        ds.construct()
        ev = [e for e in obs.EVENTS.snapshot()
              if e["type"] == "mesh_shard_commit"]
        assert {e["shard"] for e in ev} == set(range(8))
        assert all(e["rows"] > 0 and e["bytes"] == e["rows"] * F
                   for e in ev)
        assert sum(e["rows"] for e in ev) == N
        # the chunk grid is aligned to the shard grid: 513 rows a shard in
        # chunks of 300 and 213, the last shard's 506 in 300 and 206
        assert len(ev) == 8 * 2
    finally:
        obs.configure(enabled=False)
        obs.reset()


# ---- C15: the mesh knobs took no effect and warned nothing ----

def test_c15_num_shards_clamps_without_devices(data, caplog):
    """num_shards=2 on the CPU without virtual devices: one device exists,
    so the count is clamped to it with the reference's warning and the
    Dataset is not sharded."""
    X, y = data
    assert device_count("cpu") == 1
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        ds = lt.Dataset(X, label=y, params={"num_shards": 2, "verbose": -1,
                                            **CPU}).construct()
    assert "num_shards=2 exceeds the 1 available devices; clamping" in \
        caplog.text
    assert ds.shard_plan is None


def test_c15_each_mesh_knob_takes_effect(data, mesh8, caplog):
    """num_shards, feature_shards, mesh_axis and voting_parallel each
    reach the trainer; counts beyond the devices clamp with the
    reference's warnings."""
    X, y = data
    assert len(local_devices("cpu")) == 8
    # auto stays one shard on a virtual list, as on the reference's cpu
    assert resolve_num_shards(0, "cpu") == 1
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        assert resolve_num_shards(16, "cpu") == 8
    assert "num_shards=16 exceeds the 8 available devices" in caplog.text
    p = {**_P, **CPU, "num_shards": 2, "feature_shards": 2,
         "mesh_axis": "rows", "voting_parallel": 1, "top_k": 3}
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), num_boost_round=1,
                   fobj=_lattice_fobj)
    gb = bst._gbdt
    plan = gb._shard_plan
    assert gb._dp and plan is not None
    assert (plan.num_shards, plan.feature_shards, plan.axis_name) == \
        (2, 2, "rows")
    assert gb.gp.axis_name == "rows" and gb.gp.feature_shards == 2
    assert gb.gp.voting_top_k == 3
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        ds = lt.Dataset(X, label=y, params={**CPU, "num_shards": 4,
                                            "feature_shards": 3,
                                            "verbose": -1}).construct()
    assert "feature_shards=3 needs 4x3 devices but only 8 exist" in \
        caplog.text
    assert ds.shard_plan.feature_shards == 2
    with pytest.raises(lt.basic.LightGBMError, match="mesh_axis"):
        lt.Config({"feature_shards": 2, "mesh_axis": "feature"})
    with pytest.raises(lt.basic.LightGBMError, match="top_k"):
        lt.Config({"voting_parallel": 1, "top_k": 0})


def test_plan_matches_reference_arithmetic():
    """The plan's row arithmetic and the mesh helpers equal the
    reference's: the shard grid, the padding, a 2-D mesh's shape, the
    row split with its zero padding, replication."""
    from lightgbm_tpu.parallel import mesh as ref_mesh
    with virtual_devices(8, "cpu"):
        for n, k in ((4097, 8), (4096, 8), (7, 4), (1, 2)):
            a, b = ref_mesh.plan_row_sharding(n, k), plan_row_sharding(n, k)
            assert (a.rows_per_shard, a.n_padded, a.pad_rows) == \
                (b.rows_per_shard, b.n_padded, b.pad_rows)
            assert [a.shard_rows_range(s) for s in range(k)] == \
                [b.shard_rows_range(s) for s in range(k)]
        a = ref_mesh.plan_row_sharding(100, 4, feature_shards=2)
        b = plan_row_sharding(100, 4, feature_shards=2)
        assert a.mesh.devices.shape == b.mesh.devices.shape == (4, 2)
        assert a.mesh.axis_names == b.mesh.axis_names
        assert len(b.devices) == 4 and len(b.feature_devices) == 2
        x = np.arange(21, dtype=np.float32).reshape(7, 3)
        pa, na = ref_mesh.pad_rows_to_devices(x, 4)
        pb, nb = pad_rows_to_devices(x, 4)
        assert na == nb == 7 and np.array_equal(pa, pb)
        parts = shard_rows(torch.from_numpy(x), make_mesh(4))
        assert np.array_equal(torch.cat(parts).numpy(), pb)
        reps = replicate(torch.from_numpy(x), make_mesh(4))
        assert len(reps) == 4 and all(np.array_equal(r.numpy(), x)
                                      for r in reps)
