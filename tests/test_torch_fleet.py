"""The serving fleet of the PyTorch/CUDA port (lightgbm_tpu_torch/fleet/:
drift comparator, SLO admission control, artifact store, replica pool,
canary/shadow rollout, FleetServer, worker processes), on the CPU: the
reference's tests/test_fleet.py cases on the port.

The comparator's PSI and KS equal the reference's on the same streams
(f64, exactly) and the admission controller walks the reference's state
sequence for the same burn rates; every replica answers bit for bit as
Booster.predict does; a drifted shadow candidate rolls back on PSI, a clean
canary promotes by handing its warmed engine over, and no rollback frees
an engine under an in-flight flush. The reference's
``test_zero_new_lowerings_on_warmed_fleet`` counts XLA lowerings; here a
warmed fleet's storm and re-publish meet no bucket the warm-up did not.
Its throughput test is marked slow there and has no counterpart here.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu.fleet import admission as ref_admission
from lightgbm_tpu.fleet.drift import StreamingComparator as RefComparator
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.fleet.admission import (ADMIT, DEGRADE, SHED,
                                                AdmissionController,
                                                _PROBE_EVERY)
from lightgbm_tpu_torch.fleet.drift import (CANDIDATE, INCUMBENT,
                                            StreamingComparator)
from lightgbm_tpu_torch.fleet.replica import replica_devices
from lightgbm_tpu_torch.fleet.rollout import canary_name
from lightgbm_tpu_torch.fleet.service import FleetServer
from lightgbm_tpu_torch.fleet.store import ArtifactStore
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.server import (PredictServer, ServeOverload,
                                       handle_line)

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _lockwatch_zero_inversions():
    """The runtime watchdog conftest installs before any lock exists (its
    prefix also matches the port's files) must record no lock-order
    inversion after this file's real concurrency (ROADMAP A22)."""
    from lightgbm_tpu.analysis import lockwatch
    yield
    lockwatch.WATCH.assert_clean("tests/test_torch_fleet.py")

N_FEAT = 8
CPU = {"device_type": "cpu"}


def _train(rounds=5, seed=11, target_col=1):
    """A deterministic booster: the same arguments give the same model."""
    rng = np.random.RandomState(seed)
    X = rng.rand(500, N_FEAT)
    y = (X[:, 0] + X[:, target_col] > 1).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, **CPU}
    return lt.train(params, lt.Dataset(X, label=y, params=params),
                    num_boost_round=rounds)


@pytest.fixture(scope="module")
def boosters():
    live = _train()
    divergent = _train(seed=29, target_col=5)   # another concept: drift
    clean = _train()                            # the same model as live
    return live, divergent, clean


@pytest.fixture(scope="module")
def queries():
    return np.random.RandomState(7).rand(64, N_FEAT)


def _mk_server(b, **conf):
    conf = {"verbosity": -1, "serve_max_batch_rows": 64, **CPU, **conf}
    return PredictServer(conf, model=b)


def _fleet(model, **conf):
    return FleetServer({"verbosity": -1, "fleet_replicas": 2, **CPU,
                        **conf}, model=model)


_CANARY_CONF = dict(canary_fraction=0.5, canary_min_samples=40,
                    canary_cmp_window=256, canary_psi_max=0.25,
                    canary_window_s=30.0)


# ---- drift comparator ----

@pytest.mark.parametrize("shift", [1e-3, 0.5])
def test_comparator_equals_reference(shift):
    rng = np.random.RandomState(3)
    a = rng.rand(300)
    b = a[:256] + rng.rand(256) * shift
    mine, ref = StreamingComparator(window=256), RefComparator(window=256)
    for c in (mine, ref):
        c.observe(INCUMBENT, a)
        c.observe(CANDIDATE, b[:100])
        c.observe(CANDIDATE, b[100:])
    assert mine.psi() == ref.psi() and mine.ks() == ref.ks()
    assert mine.snapshot() == ref.snapshot()
    if shift > 0.1:
        assert mine.psi() > 0.25 and mine.ks() > 0.25
    else:
        assert mine.psi() < 0.05 and mine.ks() < 0.1


def test_comparator_needs_min_samples():
    c = StreamingComparator(window=64, bins=10)
    c.observe(INCUMBENT, np.arange(9))
    c.observe(CANDIDATE, np.arange(9) + 10.0)
    assert c.psi() == 0.0


# ---- artifact store ----

def test_artifact_store_versioning(tmp_path, boosters):
    live, div, _ = boosters
    store = ArtifactStore(str(tmp_path))
    v1, p1 = store.put("m", live)
    v2, p2 = store.put("m", div)
    assert (v1, v2) == (1, 2) and p1 != p2
    assert store.latest_version("m") == 2
    assert store.current_path("m") == p2
    assert store.versions("m") == [1, 2]
    q = np.random.RandomState(1).rand(4, N_FEAT)
    assert np.array_equal(lt.Booster(model_file=p1, params=CPU).predict(q),
                          live.predict(q))
    v3, _ = store.put("m", p1)
    v4, _ = store.put("m", open(p1).read())
    assert (v3, v4) == (3, 4)
    with pytest.raises(ValueError, match="bad model name"):
        store.put("a/b", live)


# ---- admission control ----

class _FakeTracker:
    """slo.TRACKER stand-in: a fixed burn rate, always active."""

    def __init__(self, burn=0.0):
        self.burn = burn
        self.active = True

    def snapshot(self):
        return {"default": {"burn_rate": self.burn, "attainment": 0.9}}


def test_admission_states_follow_reference_sequence():
    burns = [0.5, 2.0, 5.0, 5.0, 1.0, 0.1, 3.0, 1.49, 1.5]
    seqs = []
    for mod in (None, ref_admission):
        cls = AdmissionController if mod is None \
            else mod.AdmissionController
        tr = _FakeTracker()
        ac = cls(burn_degrade=1.5, burn_shed=3.0, batch_cap=4, ttl_s=0.0,
                 tracker=tr)
        seq = []
        for b in burns:
            tr.burn = b
            seq.append((ac.decide("default"), ac.batch_cap("default")))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert [s for s, _ in seqs[0]][:3] == [ADMIT, DEGRADE, SHED]


def test_admission_shed_probes_and_recovers():
    tr = _FakeTracker(9.0)
    ac = AdmissionController(ttl_s=0.0, tracker=tr)
    decisions = [ac.decide("default") for _ in range(3 * _PROBE_EVERY)]
    assert decisions.count(ADMIT) == 3
    assert decisions.count(SHED) == 3 * _PROBE_EVERY - 3
    assert ac.snapshot()["stats"]["probes"] == 3
    assert _PROBE_EVERY == ref_admission._PROBE_EVERY
    tr.burn = 0.2
    assert ac.decide("default") == ADMIT


def test_admission_from_config_gate():
    from lightgbm_tpu_torch.config import params_to_config
    assert AdmissionController.from_config(
        params_to_config({"serve_admission": 0})) is None
    ac = AdmissionController.from_config(
        params_to_config({"admission_burn_degrade": 2.0,
                          "admission_burn_shed": 4.0,
                          "serve_degraded_batch_rows": 16}))
    assert (ac.burn_degrade, ac.burn_shed) == (2.0, 4.0)


def test_admission_shed_and_degrade_on_serve_path(boosters, queries):
    live, _, _ = boosters
    srv = _mk_server(live)
    tr = _FakeTracker(9.0)
    ac = AdmissionController(batch_cap=2, ttl_s=0.0, tracker=tr)
    try:
        srv.admission = srv.batcher._admission = ac
        with pytest.raises(ServeOverload):
            srv.predict(queries[0])
        assert srv.batcher.stats["admission_shed"] == 1
        tr.burn = 2.0   # degrade: admitted, flushes capped at 2 rows
        want = live.predict(queries)
        errs = []

        def client(i):
            try:
                got = srv.predict(queries[i])
                if got[0] != want[i]:
                    raise AssertionError(f"row {i}: {got[0]} != {want[i]}")
            except Exception as e:              # pragma: no cover
                errs.append(e)

        ths = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        [t.start() for t in ths]
        [t.join() for t in ths]
        assert not errs, errs
        assert ac.snapshot()["stats"]["degraded_flushes"] > 0
        tr.burn = 0.0
        assert np.array_equal(srv.predict(queries[:8]), want[:8])
    finally:
        srv.close()


# ---- replicas ----

def test_replica_devices_are_explicit():
    from lightgbm_tpu_torch.config import params_to_config
    assert replica_devices(3, params_to_config(CPU)) == \
        [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replica_devices(2, params_to_config({}))


def test_fleet_predicts_bit_exact_across_replicas(boosters, queries):
    live, _, _ = boosters
    fs = _fleet(live, serve_max_batch_rows=64)
    try:
        assert len(fs.pool) == 2
        want = live.predict(queries)
        for n in (1, 2, 7, 33):
            assert np.array_equal(fs.predict(queries[:n]), want[:n]), n
        # every replica, addressed directly
        for r in fs.pool.replicas:
            assert r.registry.device == torch.device("cpu")
            got = r.submit_async(queries[:9]).result(10)
            assert np.array_equal(got, want[:9]), r.rid
        out, ver = fs.predict_versioned(queries[0])
        assert ver == 1 and out[0] == want[0]
        for r in fs.pool.replicas:
            assert r.registry.models()["default"]["version"] == 1
        snap = fs.fleet_stats()
        assert snap["mode"] == "inproc" and snap["replicas"] == 2
        assert snap["pool"]["routed"] >= 5
        assert fs.pool.check_health() == 2
    finally:
        fs.close()


def test_balancer_prefers_least_outstanding(boosters):
    live, _, _ = boosters
    fs = _fleet(live, fleet_health_s=0)
    try:
        r0, r1 = fs.pool.replicas
        r0.outstanding = 5
        assert fs.pool.pick() is r1
        fs.pool._done(r1)
        r1.healthy = False                       # a red replica is avoided
        assert fs.pool.pick() is r0
        fs.pool._done(r0)
        r0.healthy = False                       # all red: fail open
        assert fs.pool.pick() in (r0, r1)
    finally:
        fs.close()


def test_warmed_fleet_meets_no_new_bucket(boosters, queries):
    live, _, _ = boosters
    fs = _fleet(live, serve_max_batch_rows=8)
    try:
        engines = [r.registry.current().engine for r in fs.pool.replicas]
        seen = [set(e.stats["buckets_seen"]) for e in engines]

        # 4 threads of at most 2 rows: at most 8 rows in flight, so no
        # coalesced flush leaves the warmed buckets
        def worker(t):
            for n in (1, 2, 2, 1, 2):
                fs.predict(queries[:n])
        ths = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        [t.start() for t in ths]
        [t.join() for t in ths]
        assert [e.stats["buckets_seen"] for e in engines] == seen
        assert fs.publish(live) == 2
        assert all(r.registry.current().engine.stats["buckets_seen"] ==
                   seen[0] for r in fs.pool.replicas)
    finally:
        fs.close()


# ---- canary / shadow rollout ----

def _drain_traffic(srv, ro, queries, want_live, n=400, deadline_s=30.0):
    t_end = time.monotonic() + deadline_s
    i = 0
    while i < n or (ro.active and time.monotonic() < t_end):
        q = i % len(queries)
        out, ver = srv.predict_versioned(queries[q])
        assert ver == 1 and out[0] == want_live[q], (i, ver)
        i += 1
        if i % 64 == 0:
            ro.tick()
        if not ro.active and i >= n:
            break
    return i


def _wait_released(engine, timeout=10.0):
    t_end = time.monotonic() + timeout
    while not engine.released and time.monotonic() < t_end:
        time.sleep(0.01)
    assert engine.released, "retired engine never released after drain"


def test_shadow_divergent_candidate_auto_rolls_back(boosters, queries):
    live, divergent, _ = boosters
    srv = _mk_server(live, **_CANARY_CONF)
    try:
        want_live = live.predict(queries)
        ro = srv.ensure_rollout()
        assert ro.start(divergent, shadow=True) == 1
        assert ro.state == "shadow"
        cname = canary_name("default")
        cand_engine = srv.registry.current(cname).engine
        served = _drain_traffic(srv, ro, queries, want_live)
        assert ro.state == "idle", ro.statusz()
        assert ro.stats["rolled_back"] == 1 and ro.stats["promoted"] == 0
        assert ro.history[-1]["event"] == "rollback"
        assert ro.history[-1]["psi"] > 0.25
        assert served >= 400
        with pytest.raises(KeyError):
            srv.registry.current(cname)
        _wait_released(cand_engine)
        out, ver = srv.predict_versioned(queries[0])
        assert ver == 1 and out[0] == want_live[0]
    finally:
        srv.close()


def test_clean_candidate_auto_promotes_via_engine_handoff(boosters, queries):
    live, _, clean = boosters
    srv = _mk_server(live, **_CANARY_CONF)
    try:
        want = live.predict(queries)
        ro = srv.ensure_rollout()
        t = [1000.0]
        ro.clock = lambda: t[0]
        ro.start(clean)
        cand_engine = srv.registry.current(canary_name("default")).engine
        # request 2j goes to the incumbent and 2j+1 to the candidate
        # (fraction 0.5): both sides see query j, so the identical model's
        # windows hold the same scores
        i = 0
        while min(*ro.comparator.counts()) < ro.min_samples:
            q = (i // 2) % len(queries)
            assert srv.predict(queries[q])[0] == want[q]
            i += 1
            assert i < 5000
        time.sleep(0.05)
        assert ro.tick() == "canary"
        t[0] += ro.window_s + 1.0
        assert ro.tick() == "idle"
        assert ro.stats["promoted"] == 1 and ro.stats["rolled_back"] == 0
        live_sm = srv.registry.current("default")
        assert live_sm.version == 2
        assert live_sm.engine is cand_engine      # handed over, not rebuilt
        assert not cand_engine.released
        with pytest.raises(KeyError):
            srv.registry.current(canary_name("default"))
        out, ver = srv.predict_versioned(queries[3])
        assert ver == 2 and out[0] == want[3]
    finally:
        srv.close()


def test_superseding_canary_rolls_back_the_old_one(boosters):
    live, divergent, clean = boosters
    srv = _mk_server(live, **_CANARY_CONF)
    try:
        ro = srv.ensure_rollout()
        ro.start(divergent, shadow=True)
        ro.start(clean)
        assert ro.stats["started"] == 2 and ro.stats["rolled_back"] == 1
        assert ro.history[0]["reason"] == "superseded"
        assert ro.state == "canary"
        ro.rollback()
        assert not ro.active
        with pytest.raises(LightGBMError):
            ro.promote()
    finally:
        srv.close()


def test_candidate_route_falls_back_to_incumbent_after_rollback(boosters,
                                                                queries):
    live, divergent, _ = boosters
    srv = _mk_server(live, **_CANARY_CONF)
    try:
        want = live.predict(queries)
        ro = srv.ensure_rollout()
        ro.start(divergent, fraction=1.0)
        srv.registry.unpublish(ro.cname)    # the candidate vanishes
        for i in range(4):
            assert srv.predict(queries[i])[0] == want[i]
        assert srv.batcher.stats["canary_fallback"] == 4
        assert ro.stats["routed_candidate"] == 4
        with pytest.raises(KeyError):
            srv.predict(queries[0], model="nosuch@canary")
    finally:
        srv.close()


def test_rollback_never_frees_engine_under_inflight(boosters):
    live, divergent, _ = boosters
    srv = _mk_server(live, **_CANARY_CONF)
    try:
        ro = srv.ensure_rollout()
        ro.start(divergent, shadow=True)
        sm = srv.registry.acquire(canary_name("default"))   # in flight
        eng = sm.engine
        ro.rollback()
        assert sm.retired and not eng.released
        srv.registry.release(sm)
        assert eng.released
    finally:
        srv.close()


def test_rollback_from_completion_callback_mid_flight(boosters, queries):
    """The request in flight on the candidate trips the rollback from its
    own completion callback (on the scheduler thread, inside the flush):
    its answer arrives bit for bit and the engine is released only after
    the flush drains."""
    live, divergent, _ = boosters
    srv = _mk_server(live, **_CANARY_CONF)
    try:
        ro = srv.ensure_rollout()
        ro.start(divergent, shadow=True)
        cname = canary_name("default")
        eng = srv.registry.current(cname).engine
        released_in_cb = []

        def cb(req):
            ro.rollback()
            released_in_cb.append(eng.released)

        req = srv.batcher.submit_async(queries[0], model=cname, on_done=cb)
        out = req.result(30.0)
        assert out[0] == divergent.predict(queries[:1])[0]
        assert released_in_cb == [False]
        assert not ro.active
        _wait_released(eng)
    finally:
        srv.close()


# ---- pool-level rollout ----

def test_fleet_canary_promote_fans_across_replicas(boosters, queries):
    live, _, clean = boosters
    fs = _fleet(live, **_CANARY_CONF)
    try:
        ro = fs.ensure_rollout()
        ro.start(clean)
        cname = canary_name("default")
        cand_engines = [r.registry.current(cname).engine
                        for r in fs.pool.replicas]
        ro.promote(reason="manual")
        for r, eng in zip(fs.pool.replicas, cand_engines):
            sm = r.registry.current("default")
            assert sm.version == 2 and sm.engine is eng
            with pytest.raises(KeyError):
                r.registry.current(cname)
        out, ver = fs.predict_versioned(queries[0])
        assert ver == 2 and out[0] == clean.predict(queries)[0]
    finally:
        fs.close()


def test_fleet_canary_rollback_drops_candidate_everywhere(boosters):
    live, divergent, _ = boosters
    fs = _fleet(live, **_CANARY_CONF)
    try:
        ro = fs.ensure_rollout()
        ro.start(divergent, shadow=True)
        cname = canary_name("default")
        ro.rollback()
        for r in fs.pool.replicas:
            with pytest.raises(KeyError):
                r.registry.current(cname)
            assert r.registry.models()["default"]["version"] == 1
    finally:
        fs.close()


def test_fleet_store_shared_artifacts(tmp_path, boosters):
    live, _, _ = boosters
    fs = _fleet(live, fleet_store=str(tmp_path))
    try:
        assert fs.store.latest_version("default") == 1
        fs.publish(live)
        assert fs.store.latest_version("default") == 2
        assert fs.fleet_stats()["store"]["default"]["versions"] == [1, 2]
    finally:
        fs.close()


# ---- line protocol and the C API ----

def test_protocol_canary_promote_rollback_fleet_stats(tmp_path, boosters,
                                                      queries):
    live, divergent, clean = boosters
    cand_path = str(tmp_path / "cand.txt")
    divergent.save_model(cand_path)
    clean_path = str(tmp_path / "clean.txt")
    clean.save_model(clean_path)
    for make in (lambda: _mk_server(live, **_CANARY_CONF),
                 lambda: _fleet(live, **_CANARY_CONF)):
        srv = make()
        try:
            resp = handle_line(srv, f"!canary {cand_path} 0.5 shadow")
            assert resp == "ok version=1 mode=shadow"
            stats = json.loads(handle_line(srv, "!fleet_stats"))
            assert stats["mode"] == ("single" if isinstance(
                srv, PredictServer) else "inproc")
            assert stats["rollout"]["state"] == "shadow"
            assert handle_line(srv, "!rollback") == "ok version=1"
            assert handle_line(srv, f"!canary {clean_path}") == \
                "ok version=1 mode=canary"
            assert handle_line(srv, "!promote") == "ok version=2"
            line = ",".join("%.17g" % v for v in queries[0])
            ver, vals = handle_line(srv, line).split("\t")
            assert int(ver) == 2
            assert float(vals) == clean.predict(queries[:1])[0]
            assert handle_line(srv, "!rollback").startswith("error:")
        finally:
            srv.close()


def test_capi_fleet_surface(tmp_path, boosters, queries):
    from lightgbm_tpu_torch import capi_impl
    live, divergent, _ = boosters
    path = str(tmp_path / "cand.txt")
    divergent.save_model(path)
    srv = _mk_server(live, **_CANARY_CONF)
    try:
        assert capi_impl.server_promote(srv) == -1      # nothing active
        assert capi_impl.server_canary(srv, path, 0.5, 1) == 1
        stats = json.loads(capi_impl.server_fleet_stats_json(srv))
        assert stats["rollout"]["state"] == "shadow"
        assert capi_impl.server_rollback(srv) == 1
        assert capi_impl.server_canary(srv, path, 0.0, 0) == 1
        assert capi_impl.server_promote(srv) == 2
    finally:
        srv.close()
    live_path = str(tmp_path / "live.txt")
    live.save_model(live_path)
    fs = capi_impl.server_create(live_path, "device_type=cpu verbosity=-1 "
                                            "fleet_replicas=2")
    try:
        assert isinstance(fs, FleetServer)
        x = np.ascontiguousarray(queries[:3])
        out = np.zeros(3)
        assert capi_impl.server_predict(fs, x.ctypes.data, 3, N_FEAT, 0, 0,
                                        out.ctypes.data, 3) == 3
        assert np.array_equal(out, live.predict(x))
        stats = json.loads(capi_impl.server_fleet_stats_json(fs))
        assert stats["replicas"] == 2
    finally:
        assert capi_impl.server_close(fs) == 0


# ---- a worker process ----

def test_process_mode_worker_round_trip(tmp_path, boosters, queries,
                                        monkeypatch):
    """One worker process (python -m lightgbm_tpu_torch.fleet.worker, on
    the CPU) behind the routed balancer: versioned predictions bit for bit,
    a fan-out publish, a green health probe; pool-level rollout is
    refused."""
    from lightgbm_tpu_torch.fleet import replica
    monkeypatch.setattr(replica.WorkerReplica, "START_TIMEOUT_S", 60.0)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the worker inherits it
    live, divergent, _ = boosters
    p1, p2 = str(tmp_path / "v1.txt"), str(tmp_path / "v2.txt")
    live.save_model(p1)
    divergent.save_model(p2)
    fs = FleetServer({"verbosity": -1, "fleet_replicas": 1,
                      "fleet_mode": "process", "fleet_health_s": 0,
                      "serve_max_batch_rows": 16, **CPU}, model=p1)
    try:
        want1 = live.predict(queries)
        for i in (0, 1, 2):
            out, ver = fs.predict_versioned(queries[i])
            assert ver == 1 and out[0] == want1[i], i
        assert fs.pool.check_health() == 1
        assert fs.publish(p2) == 2
        out, ver = fs.predict_versioned(queries[5])
        assert ver == 2 and out[0] == divergent.predict(queries)[5]
        with pytest.raises(LightGBMError):
            fs.ensure_rollout()
        snap = fs.fleet_stats()
        assert snap["mode"] == "process" and snap["replicas"] == 1
    finally:
        fs.close()
