"""Fault tolerance of the PyTorch/CUDA port (lightgbm_tpu_torch) against
the JAX reference (lightgbm_tpu), on the CPU: the non-finite guard (the
repair of ROADMAP C9), the fault-injection harness, retries, atomic
writes, snapshots with their retention and validation, kill-and-resume,
and the snapshot sidecar against the reference's.

The reference trains on its Pallas kernels in interpret mode; the port
with device_type="cpu", on the kernels' plain versions. Tolerances: trees'
structures exact, leaf values, scores and predictions rtol 1e-4 (C2: the
reference renews leaves from bf16 hi/lo sums). Kill-and-resume compares
the port with itself, byte for byte. Models here are L2: a logloss model's
first torch.exp call in a process may differ by an ulp from the later
ones (ROADMAP C10), which a byte comparison of two runs would see.
"""
import logging
import os
import re

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import snapshot as ref_snap
from lightgbm_tpu.utils import faults as ref_faults
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import snapshot as snap
from lightgbm_tpu_torch.convert import resume_state_from_reference
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.utils import atomic_io, faults
from lightgbm_tpu_torch.utils.faults import FaultInjected
from lightgbm_tpu_torch.utils.retry import backoff_delays, call_with_backoff

PALLAS = {"histogram_impl": "pallas", "use_quantized_grad": "true",
          "prewarm": 0}
CPU = {"device_type": "cpu"}
P = {"verbosity": -1, "num_leaves": 7, "min_data_in_leaf": 5}
SAMPLED = {"bagging_fraction": 0.8, "bagging_freq": 1,
           "feature_fraction": 0.7, "seed": 7}


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _reg(n=300, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = X[:, 0] * 2.0 - X[:, 1] + 0.5 * rng.randn(n)
    return X, y


def _both(params, X, y, rounds, fobj=None, **kw):
    """The same training in the reference and the port: (ref, port), each
    a Booster or the exception it raised. ``fobj``: a factory, called
    once a package."""
    out = []
    for pkg, extra in ((lgb, PALLAS), (lt, CPU)):
        p = {**params, **extra}
        if fobj is not None:
            kw["fobj"] = fobj()
        try:
            out.append(pkg.train(p, pkg.Dataset(X, label=y, params=p),
                                 rounds, **kw))
        except Exception as e:      # noqa: BLE001 - compared below
            out.append(e)
    return out


def _label(ds):
    return np.asarray(ds.get_label() if hasattr(ds, "get_label")
                      else ds.label, np.float64)


def _nan_fobj(nan_from, rows=None):
    """A custom L2 objective that turns non-finite at its call
    ``nan_from``: every row, or the first ``rows``."""
    state = {"n": 0}

    def fobj(preds, ds):
        state["n"] += 1
        g = np.asarray(preds, np.float64) - _label(ds)
        if state["n"] >= nan_from:
            if rows is None:
                g = g + np.nan
            else:
                g[:rows] = np.nan
        return g, np.ones_like(g)
    return fobj


def _assert_same_outcome(ref, port, X):
    if isinstance(ref, Exception):
        assert isinstance(port, LightGBMError), port
        assert str(port) == str(ref)
        return
    assert not isinstance(port, Exception), port
    assert port.num_trees() == ref.num_trees()
    a = np.asarray(ref.predict(X, raw_score=True))
    b = port.predict(X, raw_score=True)
    assert np.isfinite(b).all() == np.isfinite(a).all()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * np.abs(a).max())


# ---------------- C9: the non-finite guard ----------------

@pytest.mark.parametrize("policy", ["fatal", "warn_skip_tree", "clip"])
@pytest.mark.parametrize("nan_from,rows", [(1, None), (3, 50)])
def test_c9_custom_gradients_against_reference(policy, nan_from, rows):
    """A custom objective's NaN gradients: fatal raises the reference's
    message at the same iteration, warn_skip_tree leaves the same trees,
    clip the same finite model."""
    X, y = _reg(500, 4)
    ref, port = _both({**P, "num_leaves": 4, "nonfinite_policy": policy},
                      X, y, 5, fobj=lambda: _nan_fobj(nan_from, rows))
    _assert_same_outcome(ref, port, X)
    if policy == "fatal":
        assert isinstance(port, LightGBMError)
        assert f"at iteration {nan_from - 1} (nonfinite_policy=fatal)" \
            in str(port)


@pytest.mark.parametrize("policy", ["fatal", "warn_skip_tree", "clip"])
def test_c9_overflowing_scores_against_reference(policy):
    """L2 on labels near 1e38 with learning_rate 1e38 (the fused front):
    fatal raises "non-finite scores detected at iteration 0" as the
    reference does; the other policies leave the reference's trees."""
    X, _ = _reg(500, 4)
    y = 1e38 + 1e37 * np.random.RandomState(1).rand(500)
    ref, port = _both({**P, "num_leaves": 4, "objective": "regression",
                       "learning_rate": 1e38, "nonfinite_policy": policy},
                      X, y, 3)
    _assert_same_outcome(ref, port, X)
    if policy == "fatal":
        assert str(port).startswith("non-finite scores detected at "
                                    "iteration 0")


def test_nonfinite_fatal_aborts():
    X, y = _reg(300, 6, 1)
    ref, port = _both({**P, "objective": "none",
                       "nonfinite_policy": "fatal"}, X, y, 6,
                      fobj=lambda: _nan_fobj(3))
    assert isinstance(ref, Exception) and "non-finite" in str(ref)
    assert isinstance(port, LightGBMError) and str(port) == str(ref)


def test_nonfinite_warn_skip_tree_drops_iterations(caplog):
    caplog.set_level(logging.WARNING, logger="lightgbm_tpu_torch")
    X, y = _reg(300, 6, 1)
    ref, port = _both({**P, "objective": "none",
                       "nonfinite_policy": "warn_skip_tree"}, X, y, 6,
                      fobj=lambda: _nan_fobj(3))
    assert port.current_iteration == ref.current_iteration == 6
    assert port.num_trees() == ref.num_trees() == 2
    assert "skipping this iteration" in caplog.text
    _assert_same_outcome(ref, port, X)


def test_nonfinite_clip_completes_finite():
    X, y = _reg(300, 6, 1)
    ref, port = _both({**P, "objective": "none",
                       "nonfinite_policy": "clip"}, X, y, 6,
                      fobj=lambda: _nan_fobj(3, rows=5))
    assert port.num_trees() == ref.num_trees() == 6
    assert np.isfinite(port.predict(X)).all()
    _assert_same_outcome(ref, port, X)


# ---------------- C13: accepted but ignored parameters ----------------

def test_c13_ignored_parameters_warn_as_in_reference(caplog):
    """pred_early_stop, gpu_use_dp and force_col_wise away from their
    defaults: the port warns "<name> is ignored" for the names the
    reference warns for and for no other; device_type (the port's own
    device choice) never warns."""
    from lightgbm_tpu.utils import log as ref_log
    X, _ = _reg(500, 4)
    y = (X[:, 0] > 0).astype(np.float64)
    knobs = {"pred_early_stop": True, "gpu_use_dp": True,
             "force_col_wise": True}
    p = {"objective": "binary", "num_leaves": 4, "verbosity": 0, **knobs}
    lines = []
    ref_log.set_callback(lines.append)
    try:
        lgb.train({**p, **PALLAS}, lgb.Dataset(X, label=y), 1)
    finally:
        ref_log.set_callback(None)
    caplog.set_level(logging.WARNING, logger="lightgbm_tpu_torch")
    lt.train({**p, **CPU}, lt.Dataset(X, label=y, params={**p, **CPU}), 1)

    def ignored(text):
        return sorted(set(re.findall(r"(\w+) is ignored: ", text)))
    assert ignored("".join(lines)) == sorted(knobs)
    assert ignored(caplog.text) == sorted(knobs)
    caplog.clear()
    q = {"objective": "binary", "num_leaves": 4, "verbosity": 0, **CPU}
    lt.train(q, lt.Dataset(X, label=y, params=q), 1)
    assert ignored(caplog.text) == []


def _nan_feval(score, ds):
    return [("explodes", float("nan"), False)]


def test_nonfinite_eval_fatal_names_metric():
    X, y = _reg(300, 6, 1)
    for pkg, extra in ((lgb, PALLAS), (lt, CPU)):
        p = {**P, "objective": "regression", "nonfinite_policy": "fatal",
             **extra}
        ds = pkg.Dataset(X, label=y, params=p)
        with pytest.raises(Exception) as ei:
            pkg.train(p, ds, 3, valid_sets=[ds], feval=_nan_feval,
                      verbose_eval=False)
        assert "explodes" in str(ei.value)
        assert "at iteration 1 (nonfinite_policy=fatal)" in str(ei.value)


def test_nonfinite_eval_warn_once(caplog):
    caplog.set_level(logging.WARNING, logger="lightgbm_tpu_torch")
    X, y = _reg(300, 6, 1)
    p = {**P, "objective": "regression", "verbosity": 0,
         "nonfinite_policy": "warn_skip_tree", **CPU}
    ds = lt.Dataset(X, label=y, params=p)
    bst = lt.train(p, ds, 4, valid_sets=[ds], feval=_nan_feval,
                   verbose_eval=False)
    assert bst.current_iteration == 4
    assert caplog.text.count("non-finite eval value") == 1
    ref = lgb.train({**p, **PALLAS, "device_type": "tpu"},
                    lgb.Dataset(X, label=y), 4)
    _assert_same_outcome(ref, bst, X)


def test_nonfinite_policy_knobs_are_checked():
    with pytest.raises(LightGBMError, match="nonfinite_policy"):
        lt.Config({"nonfinite_policy": "ignore"})
    with pytest.raises(LightGBMError, match="snapshot_keep"):
        lt.Config({"snapshot_keep": 0})
    with pytest.raises(LightGBMError, match="on_device_fault"):
        lt.Config({"on_device_fault": "ignore"})
    X, y = _reg()
    # every policy trains: the recovery rungs re-plan or drop a mesh plan
    # (A21a; tests/test_torch_mesh_faults.py drives them)
    for policy in ("fallback_single", "reshard", "fatal"):
        assert lt.train({**P, **CPU, "on_device_fault": policy},
                        lt.Dataset(X, label=y, params=CPU),
                        1).num_trees() == 1


# ---------------- the fault-injection harness ----------------

def test_fault_spec_counts_skips_and_forever():
    faults.configure("snapshot_write:2,tree_update@3")
    for _ in range(2):
        with pytest.raises(FaultInjected):
            faults.fault_point("snapshot_write")
    faults.fault_point("snapshot_write")        # exhausted: passes
    assert not faults.is_armed("snapshot_write")
    for _ in range(3):
        faults.fault_point("tree_update")       # skipped
    for _ in range(3):
        with pytest.raises(FaultInjected) as ei:
            faults.fault_point("tree_update")   # forever
    assert ei.value.point == "tree_update" and ei.value.hit == 6
    assert faults.hits("tree_update") == 6
    faults.configure(None)
    faults.fault_point("tree_update")
    assert not faults.is_armed("tree_update")


def test_fault_spec_unknown_and_unported_points():
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.configure("snapshot_wirte:1")
    # armed points whose site is not ported are refused, never ignored;
    # device_put_oom and prewarm_compile fire in ingest.py, serving.py and
    # prewarm.py and arm, and so do the continuous-learning points (wal.py,
    # join.py, online.py, Dataset.append)
    faults.configure("device_put_oom:1,prewarm_compile:1")
    assert faults.is_armed("device_put_oom")
    faults.configure(None)
    # the sharded device points fire since A21a (ingest.py, models/gbdt.py)
    faults.configure("shard_commit:1,hist_allreduce:1")
    assert faults.is_armed("shard_commit")
    assert faults.is_armed("hist_allreduce")
    faults.configure(None)
    with pytest.raises(NotImplementedError, match="A21b"):
        faults.configure("mapper_allgather:1")
    with pytest.raises(NotImplementedError, match="A21b"):
        faults.configure("dist_init:1")
    online = ("wal_append", "dataset_append", "online_train",
              "online_publish", "join_capture", "join_label", "join_commit")
    faults.configure(",".join(f"{p}:1" for p in online))
    assert all(faults.is_armed(p) for p in online)
    with pytest.raises(FaultInjected, match="wal_append"):
        faults.fault_point("wal_append")
    faults.fault_point("wal_append")
    faults.configure(None)
    assert set(faults.UNPORTED_POINTS) == {"mapper_allgather", "dist_init"}
    assert set(faults.KNOWN_POINTS) == set(ref_faults.KNOWN_POINTS)
    assert faults.DEVICE_FAULT_POINTS == ref_faults.DEVICE_FAULT_POINTS


def test_fault_env_arming(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "snapshot_write:1")
    faults.reset()
    assert faults.is_armed("snapshot_write")
    with pytest.raises(FaultInjected):
        faults.fault_point("snapshot_write")
    faults.fault_point("snapshot_write")
    # an explicit configure overrides the environment
    faults.configure("")
    assert not faults.is_armed("snapshot_write")


def test_device_fault_classification():
    import torch
    assert faults.is_device_fault(torch.cuda.OutOfMemoryError("oom"))
    assert faults.is_resource_exhausted(torch.cuda.OutOfMemoryError("x"))
    assert not faults.is_device_fault(RuntimeError("RESOURCE_EXHAUSTED"))
    assert not faults.is_device_fault(FaultInjected("tree_update", 1))
    assert faults.is_device_fault(FaultInjected("device_put_oom", 1))


# ---------------- retry ----------------

def test_backoff_delays_deterministic():
    assert list(backoff_delays(4, base_delay=0.1, max_delay=0.25)) \
        == [0.1, 0.2, 0.25]
    assert list(backoff_delays(1)) == []


def test_call_with_backoff():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"
    assert call_with_backoff(flaky, attempts=3, base_delay=0.01,
                             sleep=sleeps.append) == "ok"
    assert len(calls) == 3 and sleeps == [0.01, 0.02]

    def broken():
        raise OSError("down")
    with pytest.raises(OSError, match="down"):
        call_with_backoff(broken, attempts=2, sleep=lambda _s: None)
    seen = []

    def fatal():
        seen.append(1)
        raise ValueError("not transient")
    with pytest.raises(ValueError):
        call_with_backoff(fatal, attempts=5, sleep=lambda _s: None,
                          should_retry=lambda e: not isinstance(e,
                                                                ValueError))
    assert len(seen) == 1


# ---------------- atomic writes ----------------

def test_atomic_write_crash_leaves_no_partial_file(tmp_path):
    path = str(tmp_path / "model.txt")
    atomic_io.atomic_write_text(path, "old model\n")
    faults.configure("snapshot_write:1")
    with pytest.raises(FaultInjected):
        atomic_io.atomic_write_text(path, "new model, half written",
                                    fault_name="snapshot_write")
    with open(path) as fh:
        assert fh.read() == "old model\n"
    assert os.listdir(tmp_path) == ["model.txt"]
    atomic_io.atomic_write_text(path, "new model\n",
                                fault_name="snapshot_write")
    with open(path) as fh:
        assert fh.read() == "new model\n"
    assert os.listdir(tmp_path) == ["model.txt"]


def test_save_model_and_save_binary_are_atomic(tmp_path):
    X, y = _reg()
    p = {**P, **CPU}
    ds = lt.Dataset(X, label=y, params=p)
    bst = lt.train(p, ds, 2)
    faults.configure("snapshot_write:1")
    bst.save_model(str(tmp_path / "m.txt"))     # no fault point armed here
    ds.save_binary(str(tmp_path / "d.bin"))
    assert sorted(os.listdir(tmp_path)) == ["d.bin", "m.txt"]
    loaded = lt.Booster(model_file=str(tmp_path / "m.txt"), params=CPU)
    assert np.array_equal(loaded.predict(X), bst.predict(X))


# ---------------- snapshots ----------------

def test_snapshot_retention_and_truncated_snapshot(tmp_path):
    d = str(tmp_path / "snaps")
    X, y = _reg()
    p = {**P, **CPU, "objective": "regression", "snapshot_freq": 2,
         "snapshot_dir": d, "snapshot_keep": 2}
    lt.train(p, lt.Dataset(X, label=y, params=p), 6)
    assert sorted(os.listdir(d)) == sorted(
        [snap.model_name(4), snap.state_name(4), snap.model_name(6),
         snap.state_name(6), snap.MANIFEST_NAME])
    assert snap.load_latest_valid(d).iteration == 6
    # a truncated newest model is skipped, never loaded
    p6 = os.path.join(d, snap.model_name(6))
    with open(p6) as f:
        head = f.read(120)
    with open(p6, "w") as f:
        f.write(head)
    assert snap.load_latest_valid(d).iteration == 4
    s4 = os.path.join(d, snap.state_name(4))
    with open(s4, "rb") as f:
        raw = f.read()
    with open(s4, "wb") as f:
        f.write(raw[: len(raw) // 2])
    assert snap.load_latest_valid(d) is None
    assert snap.booster_from_latest(d) == (None, 0)
    assert snap.snapshot_dir_for(lt.Config(
        {"output_model": "/x/y/model.txt"})) == "/x/y"


def test_snapshot_write_retries_through_injected_faults(tmp_path):
    d = str(tmp_path / "snaps")
    X, y = _reg()
    p = {**P, **CPU, "snapshot_freq": 2, "snapshot_dir": d,
         "faults": "snapshot_write:2"}
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), 2)
    payload = snap.load_latest_valid(d)
    assert payload.iteration == 2 and bst.num_trees() == 2
    b, it = snap.booster_from_latest(d, params=CPU)
    assert it == 2 and np.array_equal(b.predict(X), bst.predict(X))


def _model_bytes(bst):
    """The model text up to the parameters echo (which records the resumed
    run's snapshot settings)."""
    return bst.model_to_string().split("\nparameters:\n")[0]


# ROADMAP C11's CEGB runs: 600 x 8 rows of RandomState(0), regression, a
# lazy or a coupled feature penalty beside the split penalty
CEGB_RUN = {"num_leaves": 8, "min_data_in_leaf": 10, "seed": 3,
            "cegb_penalty_split": 1e-3}
CEGB = {"cegb_lazy": {**CEGB_RUN, "cegb_penalty_feature_lazy": [0.01] * 8},
        "cegb_coupled": {**CEGB_RUN,
                         "cegb_penalty_feature_coupled": [0.5] * 8}}


@pytest.mark.parametrize("boosting", ["gbdt", "dart", "goss", "cegb_lazy",
                                      "cegb_coupled"])
def test_kill_and_resume_byte_identical(tmp_path, boosting):
    """A run killed by tree_update@7 and resumed from its iteration-6
    snapshot ends with the uninterrupted run's model text, byte for byte,
    with bagging and feature_fraction on (every RNG stream crosses the
    snapshot; DART's drops and tree weights, GOSS's draws too), and with
    CEGB's bookkeeping (the columns split on, the (row, column) pairs that
    paid the lazy penalty) across the snapshot (ROADMAP C11)."""
    if boosting in CEGB:
        (X, y), extra, rounds = _reg(600, 8, 0), CEGB[boosting], 10
    else:
        (X, y), rounds = _reg(500, 8, 5), 12
        extra = {"gbdt": SAMPLED, "dart": {**SAMPLED, "boosting": "dart"},
                 "goss": {"boosting": "goss", "feature_fraction": 0.7,
                          "seed": 7}}[boosting]
    p = {**P, **CPU, "objective": "regression", **extra}
    ref_text = _model_bytes(lt.train(p, lt.Dataset(X, label=y, params=p),
                                     rounds))
    d = str(tmp_path / "snaps")
    with pytest.raises(FaultInjected):
        lt.train({**p, "snapshot_freq": 2, "snapshot_dir": d,
                  "faults": "tree_update@7"},
                 lt.Dataset(X, label=y, params=p), rounds)
    faults.reset()
    payload = snap.load_latest_valid(d)
    assert payload.iteration == 6
    if boosting == "cegb_lazy":
        # the lazy bitset [N, F] crossed the snapshot with paid pairs in it
        assert payload.arrays["cegb_data_used"].shape == (600, 8)
        assert payload.arrays["cegb_data_used"].any()
    bst = lt.train({**p, "snapshot_freq": 2, "snapshot_dir": d},
                   lt.Dataset(X, label=y, params=p), rounds,
                   resume_from_snapshot=d)
    assert bst.current_iteration == rounds
    assert _model_bytes(bst) == ref_text
    if boosting in CEGB:
        full = lt.Booster(params=p, train_set=lt.Dataset(X, label=y,
                                                         params=p))
        for _ in range(rounds):
            full.update()
        a, b = full._gbdt.cegb, bst._gbdt.cegb
        assert torch.equal(a.feature_used, b.feature_used)
        assert (a.data_used is None) == (boosting == "cegb_coupled")
        assert a.data_used is None or torch.equal(a.data_used, b.data_used)
        assert torch.equal(a.lazy_pen, b.lazy_pen)
        assert (a.lazy_cols is None and b.lazy_cols is None) or \
            torch.equal(a.lazy_cols, b.lazy_cols)


def test_resume_refuses_other_cegb_penalties(tmp_path, caplog):
    """A snapshot of another lazy penalty vector is refused before any
    state changes (the penalties are not in the fingerprint)."""
    X, y = _reg(600, 8, 0)
    p = {**P, **CPU, "objective": "regression", **CEGB["cegb_lazy"]}
    d = str(tmp_path)
    lt.train({**p, "snapshot_freq": 2, "snapshot_dir": d},
             lt.Dataset(X, label=y, params=p), 2)
    q = {**p, "cegb_penalty_feature_lazy": [0.02] * 8}
    caplog.set_level(logging.WARNING, logger="lightgbm_tpu_torch")
    bst = lt.train(q, lt.Dataset(X, label=y, params=q), 3,
                   resume_from_snapshot=d)
    assert bst.current_iteration == 3
    assert "cannot resume" in caplog.text and "cegb_lazy_pen" in caplog.text


def test_resume_from_empty_dir_trains_from_scratch(tmp_path, caplog):
    caplog.set_level(logging.WARNING, logger="lightgbm_tpu_torch")
    X, y = _reg()
    p = {**P, **CPU}
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), 5,
                   resume_from_snapshot=str(tmp_path / "nothing"))
    assert bst.current_iteration == 5
    assert "no valid snapshot" in caplog.text


def test_resume_config_mismatch_falls_back_to_scratch(tmp_path, caplog):
    d = str(tmp_path)
    X, y = _reg()
    p = {**P, **CPU, "learning_rate": 0.1}
    lt.train({**p, "snapshot_freq": 2, "snapshot_dir": d},
             lt.Dataset(X, label=y, params=p), 4)
    caplog.set_level(logging.WARNING, logger="lightgbm_tpu_torch")
    q = {**p, "learning_rate": 0.3}
    bst = lt.train(q, lt.Dataset(X, label=y, params=q), 4,
                   resume_from_snapshot=d)
    assert bst.current_iteration == 4
    assert "cannot resume" in caplog.text and "learning_rate" in caplog.text
    # the snapshot at 4 >= num_boost_round: nothing more to boost
    done = lt.train(p, lt.Dataset(X, label=y, params=p), 3,
                    resume_from_snapshot=d)
    assert done.current_iteration == 4


def test_early_stopping_survives_resume(tmp_path):
    """best_iteration does not move across a snapshot and resume: early
    stopping's bookkeeping rides the sidecar (_es_export/_es_import)."""
    rng = np.random.RandomState(3)
    X = rng.randn(600, 10)
    y = X[:, 0] + X[:, 1] + 2.0 * rng.randn(600)
    p = {**P, **CPU, "objective": "regression", "metric": "l2",
         "learning_rate": 0.3, "seed": 11}
    d = str(tmp_path / "snaps")

    def run(resume):
        ds = lt.Dataset(X[:450], label=y[:450], params=p)
        kw = {"resume_from_snapshot": d} if resume else {}
        return lt.train({**p, "snapshot_freq": 2, "snapshot_dir": d}, ds,
                        100, valid_sets=[ds.create_valid(X[450:],
                                                         label=y[450:])],
                        early_stopping_rounds=5, verbose_eval=False, **kw)
    full = run(False)
    assert 0 < full.best_iteration < 100
    resumed = run(True)
    assert resumed.best_iteration == full.best_iteration
    assert resumed.best_score == full.best_score


# ---------------- the sidecar against the reference's ----------------

# the sidecar runs: sampled L2, and the same with each CEGB penalty
SIDECAR = {"sampled": {},
           **{k: {**v, "num_leaves": 7, "min_data_in_leaf": 5}
              for k, v in CEGB.items()}}


def _payload_pair(tmp_path, rounds, extra=(), **kw):
    """Both packages' snapshot at ``rounds`` of the same sampled L2 run,
    with the parameters ``extra`` (6 features: CEGB vectors cut to 6)."""
    X, y = _reg(400, 6, 2)
    extra = {k: (v[:6] if isinstance(v, list) else v)
             for k, v in dict(extra).items()}
    out = []
    for pkg, mod, dev in ((lgb, ref_snap, PALLAS),
                          (lt, snap, {**PALLAS, **CPU})):
        d = str(tmp_path / pkg.__name__)
        p = {**P, **SAMPLED, "objective": "regression", "snapshot_freq":
             rounds, "snapshot_dir": d, **extra, **dev}
        pkg.train(p, pkg.Dataset(X, label=y, params=p), rounds, **kw)
        out.append(mod.load_latest_valid(d))
    return X, y, out


@pytest.mark.parametrize("run", list(SIDECAR))
def test_sidecar_matches_reference_after_four_iterations(tmp_path, run):
    """The port's sidecar has the reference's keys; its RNG states, bag key
    and bag mask equal the reference's bit for bit, its trees' structure
    too, and its train score and leaves lie within C2. Under CEGB the four
    cegb_* arrays (the columns split on, the lazy bitset or its [1, 1]
    placeholder, the two penalty vectors) equal the reference's too."""
    _, _, (ref, port) = _payload_pair(tmp_path, 4, SIDECAR[run])
    assert ref.iteration == port.iteration == 4
    assert set(port.arrays) == set(ref.arrays)
    assert (run in CEGB) == ("cegb_feature_used" in port.arrays)
    for k in ref.arrays:
        if k.startswith(("rng", "cegb_")) or k in ("bag_key", "bag_mask"):
            assert port.arrays[k].shape == ref.arrays[k].shape, k
            assert np.array_equal(port.arrays[k], ref.arrays[k]), k
    for f in ("split_feature", "threshold_bin", "default_left",
              "left_child", "right_child", "num_leaves"):
        assert np.array_equal(port.arrays[f"trees_{f}"],
                              ref.arrays[f"trees_{f}"]), f
    a, b = ref.arrays["train_score"], port.arrays["train_score"]
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * np.abs(a).max())
    np.testing.assert_allclose(port.arrays["trees_leaf_value"],
                               ref.arrays["trees_leaf_value"], rtol=1e-4,
                               atol=1e-6)
    # the boost-from-average mean: f32 sums in another order, one ulp
    np.testing.assert_allclose(port.arrays["init_scores"],
                               ref.arrays["init_scores"], rtol=2.4e-7)
    assert port.meta["fingerprint"] == ref.meta["fingerprint"]
    for k in ("iter", "num_trees", "learning_rate", "has_init_score",
              "has_bag_mask"):
        assert port.meta[k] == ref.meta[k], k


@pytest.mark.parametrize("run", list(SIDECAR))
def test_port_resumes_a_reference_snapshot(tmp_path, run):
    """resume_state_from_reference: the port resumes, at iteration 2, a run
    that the reference snapshotted (with its CEGB bookkeeping under CEGB),
    and ends with the reference's uninterrupted trees (structure exact,
    leaves within C2)."""
    X, y, (ref2, _) = _payload_pair(tmp_path, 2, SIDECAR[run])
    arrays, meta = resume_state_from_reference(ref2.arrays, ref2.meta)
    extra = {k: (v[:6] if isinstance(v, list) else v)
             for k, v in SIDECAR[run].items()}
    p = {**P, **SAMPLED, "objective": "regression", **extra, **PALLAS,
         **CPU}
    bst = lt.Booster(params=p, train_set=lt.Dataset(X, label=y, params=p))
    bst._gbdt.set_resume_state(arrays, meta)
    if run in CEGB:
        assert np.array_equal(bst._gbdt.cegb.feature_used.numpy(),
                              ref2.arrays["cegb_feature_used"])
    for _ in range(2):
        bst.update()
    full = lgb.train({**P, **SAMPLED, "objective": "regression", **extra,
                      **PALLAS}, lgb.Dataset(X, label=y), 4)
    ta, tb = full._ensure_host_trees(), bst._host_trees()
    assert len(ta) == len(tb) == 4
    for a, b in zip(ta, tb):
        for f in ("split_feature", "left_child", "right_child",
                  "default_left"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-6)
