"""Mesh fault tolerance of the PyTorch/CUDA port on the CPU: the cases of
the reference's tests/test_zz_mesh_faults.py on the port, on
``virtual_devices(8, "cpu")``.

Every recovered run is held to the uninterrupted one-shard run byte for
byte (the model text without its parameter echo), on gradients of a dyadic
lattice, where every sum is exact whatever the shard count: a kill at
iteration 3 resumed on the same or another shard count; an injected device
OOM during the sharded ingest recovered by halving the chunk, then by
re-planning over more devices (``reshard``) or dropping the plan
(``fallback_single``), while ``fatal`` fails at once; a device fault at
the data-parallel step (``hist_allreduce``) retried; a failed prewarm an
adoption miss. The mesh preflight names a bad plan's fields before step 0.
The port's trees of the one-shard run equal the reference's too. The
simulated OOM is torch's ``OutOfMemoryError`` (the reference raises XLA's
RESOURCE_EXHAUSTED).
"""
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import ingest, obs, prewarm
from lightgbm_tpu_torch import snapshot as snap
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.parallel.fence import mesh_preflight
from lightgbm_tpu_torch.parallel.mesh import local_devices, virtual_devices
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.faults import FaultInjected

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

N, F = 1025, 5          # odd row count: every shard grid needs padding
ROUNDS = 4              # resume tests; the chaos tests train 3 rounds

_P = {"objective": "none", "num_leaves": 7, "max_bin": 63,
      "min_data_in_leaf": 5, "verbose": -1, "seed": 7,
      "feature_fraction": 0.7, "prewarm": 0}
CPU = {"device_type": "cpu", "use_quantized_grad": False}


@pytest.fixture(autouse=True)
def _mesh_and_faults():
    faults.reset()
    with virtual_devices(8, "cpu"):
        yield
    faults.reset()


def _lattice_fobj(preds, train_data):
    labels = train_data.get_label()
    g = np.round((np.asarray(preds, np.float64) - labels) * 512.0) / 512.0
    return g.astype(np.float32), np.full(g.shape, 0.25, np.float32)


def _model_bytes(bst):
    # the trees and the feature importances: the parameter echo differs
    return bst.model_to_string().split("\nparameters:\n")[0]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(5)
    return rng.rand(N, F).astype(np.float32), rng.rand(N).astype(np.float32)


def _train(data, num_shards, rounds, **extra):
    X, y = data
    params = {**_P, **CPU, "num_shards": num_shards, **extra}
    ds = lt.Dataset(X, label=y, params=params)
    bst = lt.train(params, ds, num_boost_round=rounds, fobj=_lattice_fobj)
    return bst, ds


@pytest.fixture(scope="module")
def ref_bytes(data):
    with virtual_devices(8, "cpu"):
        return _model_bytes(_train(data, 1, ROUNDS)[0])


@pytest.fixture(scope="module")
def ref3_bytes(data):
    with virtual_devices(8, "cpu"):
        return _model_bytes(_train(data, 1, 3)[0])


def _device_fault_events():
    return [e for e in obs.EVENTS.snapshot() if e["type"] == "device_fault"]


@pytest.fixture
def telemetry():
    obs.configure(enabled=True)
    obs.reset()
    yield
    obs.configure(enabled=False)
    obs.reset()


# ---------------- sharded kill-and-resume ----------------

@pytest.mark.parametrize("k_crash,k_resume", [(2, 2), (8, 8), (8, 2)])
def test_kill_and_resume_sharded_byte_identical(tmp_path, data, ref_bytes,
                                                k_crash, k_resume):
    """A k_crash-shard run killed at iteration 3 (tree_update), resumed
    from its newest snapshot onto k_resume shards: the one-shard
    uninterrupted model byte for byte, feature_fraction's draws
    included; the snapshot records its shard count and stores the state
    unsharded."""
    d = str(tmp_path / f"snaps_{k_crash}_{k_resume}")
    X, y = data
    with pytest.raises(FaultInjected):
        lt.train({**_P, **CPU, "num_shards": k_crash, "snapshot_freq": 1,
                  "snapshot_dir": d, "faults": "tree_update@3"},
                 lt.Dataset(X, label=y,
                            params={**_P, **CPU, "num_shards": k_crash}),
                 num_boost_round=ROUNDS, fobj=_lattice_fobj)
    faults.reset()
    payload = snap.load_latest_valid(d)
    assert payload is not None and payload.iteration == 3
    assert int(payload.meta.get("num_shards", 0)) == k_crash
    assert payload.arrays["train_score"].shape == (N,)
    bst = lt.train({**_P, **CPU, "num_shards": k_resume, "snapshot_freq": 1,
                    "snapshot_dir": d},
                   lt.Dataset(X, label=y,
                              params={**_P, **CPU, "num_shards": k_resume}),
                   num_boost_round=ROUNDS, fobj=_lattice_fobj,
                   resume_from_snapshot=d)
    assert bst.current_iteration == ROUNDS
    assert bst._gbdt._shard_plan.num_shards == k_resume
    assert _model_bytes(bst) == ref_bytes
    if (k_crash, k_resume) == (8, 2):
        # and the reference's uninterrupted one-shard trees, bit for bit
        ref = lgb.train({**_P, "use_quantized_grad": False},
                        lgb.Dataset(X, label=y), num_boost_round=ROUNDS,
                        fobj=_lattice_fobj)
        for a, b in zip(ref._gbdt.finalize(), bst._host_trees()):
            for name in ("split_feature", "threshold_bin", "leaf_value"):
                np.testing.assert_array_equal(getattr(b, name),
                                              getattr(a, name))


# ---------------- OOM-adaptive degradation ----------------

def test_device_put_oom_recovers_by_chunk_halving(data, ref3_bytes,
                                                  telemetry):
    """One injected OOM on a chunk's copy: the chunk halves, the ingest
    retries on the same 2-shard plan, one device_fault event; the model
    is the one-shard model."""
    bst, ds = _train(data, 2, 3, ingest_chunk_rows=400, telemetry=True,
                     faults="device_put_oom:1", on_device_fault="reshard")
    ev = _device_fault_events()
    assert len(ev) == 1, ev
    assert ev[0]["point"] == "device_put_oom"
    assert ev[0]["policy"] == "reshard"
    assert ev[0]["action"] == "halve_chunk"
    assert ev[0]["chunk_rows"] == 200
    assert "out of memory" in ev[0]["error"]
    assert ingest.last_stats()["chunk_rows"] == 200
    assert ds.shard_plan is not None and ds.shard_plan.num_shards == 2
    assert _model_bytes(bst) == ref3_bytes


def test_device_put_oom_fatal_fails_fast(data, telemetry):
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _train(data, 2, 3, telemetry=True, faults="device_put_oom:1",
               on_device_fault="fatal")
    assert _device_fault_events() == []


def test_persistent_oom_reshards_to_more_devices(data, ref3_bytes,
                                                 telemetry):
    """Four OOMs spend the three halvings; reshard re-plans 2 -> 4
    shards."""
    bst, ds = _train(data, 2, 3, ingest_chunk_rows=400, telemetry=True,
                     faults="device_put_oom:4", on_device_fault="reshard")
    ev = _device_fault_events()
    assert [e["action"] for e in ev] == ["halve_chunk"] * 3 + ["reshard"]
    assert (ev[-1]["shards_before"], ev[-1]["shards_after"]) == (2, 4)
    assert ds.shard_plan is not None and ds.shard_plan.num_shards == 4
    assert len(ds.shard_bins) == 4
    assert bst._gbdt._shard_plan.num_shards == 4
    assert _model_bytes(bst) == ref3_bytes


def test_persistent_oom_falls_back_to_single_device(data, ref3_bytes):
    bst, ds = _train(data, 2, 3, ingest_chunk_rows=400,
                     faults="device_put_oom:4",
                     on_device_fault="fallback_single")
    assert ds.shard_plan is None and ds.shard_bins is None
    assert not bst._gbdt._dp
    assert _model_bytes(bst) == ref3_bytes


def test_reshard_without_more_devices_raises(data):
    """A plan over every device cannot grow: after the halvings the OOM is
    raised (the reference's ladder ends there too)."""
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _train(data, 8, 1, ingest_chunk_rows=400, faults="device_put_oom:4",
               on_device_fault="reshard")


def test_shard_commit_fault_recovers(data, ref3_bytes, telemetry):
    """A failed commit into a shard's block (shard_commit) is a device
    fault: the chunk halves and the ingest retries."""
    bst, ds = _train(data, 4, 3, telemetry=True, faults="shard_commit:1")
    ev = _device_fault_events()
    assert [(e["point"], e["action"]) for e in ev] == \
        [("shard_commit", "halve_chunk")]
    assert ds.shard_plan.num_shards == 4
    assert _model_bytes(bst) == ref3_bytes


def test_hist_allreduce_fault_recovers_by_retry(data, ref3_bytes,
                                                telemetry):
    """A device fault at the data-parallel step is retried with backoff
    from the iteration's saved state."""
    bst, _ds = _train(data, 2, 3, telemetry=True, faults="hist_allreduce:1",
                      on_device_fault="reshard")
    ev = _device_fault_events()
    assert len(ev) == 1 and ev[0]["point"] == "hist_allreduce"
    assert ev[0]["action"] == "retry"
    assert _model_bytes(bst) == ref3_bytes
    assert [e for e in obs.EVENTS.snapshot()
            if e["type"] == "hist_allreduce"][0]["shards"] == 2


def test_hist_allreduce_fault_fatal_raises(data):
    with pytest.raises(FaultInjected):
        _train(data, 2, 3, faults="hist_allreduce:1",
               on_device_fault="fatal")


def test_prewarm_compile_fault_is_adoption_miss(data, ref3_bytes,
                                                monkeypatch):
    """A fault in the background prewarm is a miss at adoption, never a
    failed run; the prewarm under a plan warms the plan's devices and
    predicts its shard count."""
    monkeypatch.setattr(prewarm, "MIN_PREWARM_ROWS", 0)
    monkeypatch.setattr(prewarm, "CUDA_ONLY", False)
    params = {k: v for k, v in _P.items() if k != "prewarm"}
    X, y = data
    bst = lt.train({**params, **CPU, "num_shards": 2,
                    "faults": "prewarm_compile:1"},
                   lt.Dataset(X, label=y,
                              params={**params, **CPU, "num_shards": 2}),
                   num_boost_round=3, fobj=_lattice_fobj)
    assert faults.hits("prewarm_compile") >= 1
    assert not bst._gbdt.prewarm_adopted
    assert _model_bytes(bst) == ref3_bytes
    faults.reset()
    ds = lt.Dataset(X, label=y, params={**params, **CPU, "num_shards": 2})
    ds.construct()
    handle = ds._prewarm.join()
    assert handle.spec["shards"] == 2
    bst = lt.train({**params, **CPU, "num_shards": 2}, ds,
                   num_boost_round=3, fobj=_lattice_fobj)
    assert bst._gbdt.prewarm_adopted


# ---------------- the mesh preflight ----------------

def _plan_shim(**over):
    base = dict(axis_name="data", num_shards=2, n_rows=N,
                rows_per_shard=-(-N // 2), devices=local_devices("cpu")[:2])
    base.update(over)
    return SimpleNamespace(**base)


def _ts_shim(n=N):
    return SimpleNamespace(num_data=n, mappers=None, feature_map=None,
                           num_features=F)


def test_mesh_preflight_passes_on_healthy_plan(telemetry):
    assert mesh_preflight(Config({}), _ts_shim(), _plan_shim()) is True
    ev = [e for e in obs.EVENTS.snapshot() if e["type"] == "mesh_preflight"]
    assert len(ev) == 1 and ev[0]["ok"] is True and ev[0]["shards"] == 2
    assert mesh_preflight(Config({}), _ts_shim(), None) is True


def test_mesh_preflight_names_axis_mismatch():
    with pytest.raises(LightGBMError, match=r"plan\.axis_name"):
        mesh_preflight(Config({}), _ts_shim(), _plan_shim(axis_name="rows"))


def test_mesh_preflight_names_stale_row_count():
    with pytest.raises(LightGBMError, match=r"plan\.n_rows"):
        mesh_preflight(Config({}), _ts_shim(n=N - 100), _plan_shim())


def test_mesh_preflight_catches_dead_device(caplog):
    """A device that fails the liveness probe (here not a device at all)
    is named, one line a device, instead of failing a sum later."""
    plan = _plan_shim(devices=["not-a-device"], num_shards=1,
                      rows_per_shard=N)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        ok = mesh_preflight(Config({}), _ts_shim(), plan,
                            raise_on_mismatch=False)
    assert ok is False
    assert "mesh preflight FAILED" in caplog.text
    assert "not-a-device" in caplog.text


# ---------------- fault registry hygiene ----------------

def test_unknown_fault_point_rejected():
    with pytest.raises(ValueError) as ei:
        faults.configure("device_put_oops:1")
    msg = str(ei.value)
    assert "device_put_oops" in msg
    for known in ("device_put_oom", "tree_update", "shard_commit"):
        assert known in msg
    with pytest.raises(ValueError):
        lt.train({**_P, **CPU, "faults": "device_put_oops:1"},
                 lt.Dataset(np.zeros((8, 2), np.float32),
                            label=np.zeros(8, np.float32), params=CPU),
                 num_boost_round=1)
