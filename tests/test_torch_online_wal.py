"""Exactly-once continuous training of the PyTorch/CUDA port
(lightgbm_tpu_torch/wal.py, online.py), on the CPU: the cases of the
reference's tests/test_online_wal.py on the port, and the port's feed log
held against the reference's (lightgbm_tpu/wal.py).

The crash contract under test: a simulated ``kill -9`` (FaultInjected at a
registered crash point, trainer + dataset discarded) at ANY point between
``feed()`` and publish, followed by a restart (fresh trainer over the same
WAL dir, producer re-sending every batch with the same ids), yields a model
byte-identical to the uninterrupted run's — zero lost batches, zero
double-trained batches, asserted from the WAL's sequence numbers.

Across the packages: the same appends and commits write the same log file
byte for byte, a log either package wrote is scanned and recovered by the
other (the same seqs, ids, rows and commit), a trainer of either package
recovers a model from the other's log, and the sliding window's bins equal
the reference's. Exact throughout (bins, bytes, seqs, model texts within
one package). The reference's wall-clock bound on ``feed`` under a storm
is replaced by a deterministic one: the cycle is held on an Event while
every feed returns. The reference's sharded case
(test_eviction_window_bit_exact_sharded) runs on ``virtual_devices(8,
"cpu")`` against the reference's 8 virtual devices.
"""
import glob
import os
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu import wal as ref_wal
from lightgbm_tpu.online import OnlineTrainer as RefTrainer
from lightgbm_tpu.online import tail_source as ref_tail_source
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.basic import Dataset
from lightgbm_tpu_torch.config import params_to_config
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.online import OnlineTrainer, tail_source
from lightgbm_tpu_torch.parallel.mesh import virtual_devices
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.faults import FaultInjected
from lightgbm_tpu_torch.wal import FeedLog
import torch

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
    lockwatch.WATCH.assert_clean("tests/test_torch_online_wal.py")

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _clean_faults_and_obs():
    faults.reset()
    yield
    faults.reset()
    obs.configure(enabled=False)
    obs.reset()


N_FEAT = 4


def _make_data(n=120, f=N_FEAT, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    y = X[:, 0] + 0.5 * X[:, 1] + 0.05 * rng.rand(n)
    return X, y


def _batches(n_batches=10, rows=10, f=N_FEAT, seed=77):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_batches):
        X = rng.rand(rows, f)
        out.append((X, X[:, 0] + 0.5 * X[:, 1], f"b{i:03d}"))
    return out


def _params(wal_dir, **extra):
    p = {"objective": "regression", "num_leaves": 7, "verbose": -1,
         "min_data_in_leaf": 5, "num_iterations": 3,
         "online_refit_rows": 30, "online_boost_rounds": 2,
         "online_wal": True, "online_wal_dir": str(wal_dir), **CPU}
    p.update(extra)
    return p


def _fresh_trainer(params):
    """A from-scratch trainer over a from-scratch base dataset — what a
    restarted process would build before WAL recovery kicks in."""
    X0, y0 = _make_data()
    return OnlineTrainer(params, Dataset(X0, label=y0, params=params))


# ---- FeedLog units ----

def test_wal_roundtrip(tmp_path):
    fl = FeedLog(str(tmp_path / "w"))
    bs = _batches(3, rows=4)
    w = np.linspace(1.0, 2.0, 4)
    assert fl.append_batch(bs[0][0], bs[0][1], batch_id=bs[0][2]) == 1
    assert fl.append_batch(bs[1][0], bs[1][1], w) == 2
    assert fl.append_batch(bs[2][0], bs[2][1]) == 3
    assert fl.seen(bs[0][2]) and not fl.seen("nope")
    with pytest.raises(ValueError):
        fl.append_batch(bs[0][0], bs[0][1], batch_id=bs[0][2])
    fl.commit(2, version=7, model="model_00000002.txt", baseline=0.5,
              cycle=1)
    fl.close()
    # reopen: everything decodes back bit-exactly, split at the commit
    fl2 = FeedLog(str(tmp_path / "w"))
    assert fl2.last_seq == 3 and fl2.committed_seq == 2
    assert fl2.truncated_bytes == 0
    lc = fl2.last_commit
    assert lc["version"] == 7 and lc["model"] == "model_00000002.txt"
    assert lc["baseline"] == 0.5 and lc["cycle"] == 1
    committed, pending = fl2.committed(), fl2.pending()
    assert [b.seq for b in committed] == [1, 2]
    assert [b.seq for b in pending] == [3]
    np.testing.assert_array_equal(committed[0].X, bs[0][0])
    np.testing.assert_array_equal(committed[0].y, bs[0][1])
    assert committed[0].batch_id == bs[0][2]
    np.testing.assert_array_equal(committed[1].w, w)
    assert pending[0].w is None
    assert fl2.seen(bs[0][2])
    st = fl2.stats()
    assert st["batches"] == 3 and st["last_seq"] == 3
    assert st["committed_seq"] == 2 and st["bytes"] > 0
    fl2.close()
    assert fl2.closed


def test_wal_torn_tail_truncated(tmp_path):
    fl = FeedLog(str(tmp_path / "w"))
    bs = _batches(3, rows=6)
    for X, y, bid in bs:
        fl.append_batch(X, y, batch_id=bid)
    fl.close()
    # crash mid-append: chop the last record in half
    path = os.path.join(str(tmp_path / "w"), "feed.wal")
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size - 37)
    fl2 = FeedLog(str(tmp_path / "w"))
    assert fl2.truncated_bytes > 0
    assert [b.seq for b in fl2.pending()] == [1, 2]
    assert not fl2.seen(bs[2][2])   # the torn batch was never acknowledged
    # the log keeps appending after recovery, sequence numbers continue
    assert fl2.append_batch(bs[2][0], bs[2][1], batch_id=bs[2][2]) == 3
    fl2.close()
    fl3 = FeedLog(str(tmp_path / "w"))
    assert fl3.truncated_bytes == 0 and fl3.last_seq == 3
    assert [b.seq for b in fl3.pending()] == [1, 2, 3]
    fl3.close()


def test_wal_scan_dedups_duplicate_ids(tmp_path):
    # a producer re-send that raced a crash can leave two records with the
    # same id in the file; the scan keeps the first occurrence only
    fl = FeedLog(str(tmp_path / "w"))
    X, y, bid = _batches(1, rows=5)[0]
    fl.append_batch(X, y, batch_id=bid)
    with fl._lock:   # forge the duplicate the public API refuses to write
        fl._append_record(1, 2, {"rows": 5, "cols": N_FEAT, "w": False,
                                 "id": bid},
                          np.ascontiguousarray(X).tobytes() +
                          np.ascontiguousarray(y).tobytes())
    fl.close()
    fl2 = FeedLog(str(tmp_path / "w"))
    assert [b.seq for b in fl2.pending()] == [1]
    assert fl2.last_seq == 2
    fl2.close()


# ---- the kill-and-replay chaos drill ----

CRASH_POINTS = ("wal_append", "dataset_append", "online_train",
                "online_publish")


def _run_until_crash(tr, batches):
    """Feed + flush until a FaultInjected 'kills' the process; returns True
    if it crashed. The caller discards the trainer + dataset afterwards —
    that discard IS the kill -9 simulation (nothing in-memory survives)."""
    try:
        for X, y, bid in batches:
            tr.feed(X, y, batch_id=bid)
        tr.flush()
    except FaultInjected:
        return True
    return False


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The uninterrupted run of the kill-and-replay drill: its model text,
    rows and batches. The model text echoes every param, online_wal_dir
    included — byte-identity needs the SAME dir string in every run, so
    each run gets its own cwd and a relative "wal"."""
    batches = _batches(10, rows=10)
    base = tmp_path_factory.mktemp("base")
    cwd = os.getcwd()
    os.chdir(base)
    try:
        tr = _fresh_trainer(_params("wal"))
        assert not _run_until_crash(tr, batches)
        want = (tr.booster.model_to_string(), tr.dataset.num_data)
        assert tr.wal.committed_seq == tr.wal.last_seq == len(batches)
        tr.close()
    finally:
        os.chdir(cwd)
    return want, batches


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_kill_and_replay_byte_identical(tmp_path, monkeypatch, uninterrupted,
                                        point):
    (want_text, want_rows), batches = uninterrupted
    params = _params("wal")
    d = tmp_path / point
    d.mkdir()
    monkeypatch.chdir(d)
    faults.configure(f"{point}:1")
    tr1 = _fresh_trainer(params)
    crashed = _run_until_crash(tr1, batches)
    faults.reset()
    assert crashed, f"fault point {point} never fired"
    tr1.wal.close()   # the fd would leak; a real kill -9 drops it too
    del tr1           # kill -9: trainer + dataset state is gone

    # restart: fresh trainer recovers from the WAL, then the producer
    # re-sends EVERYTHING with the same ids (tail from the start)
    tr2 = _fresh_trainer(params)
    assert not _run_until_crash(tr2, batches)
    assert tr2.booster.model_to_string() == want_text, \
        f"recovered model differs after crash at {point}"
    assert tr2.dataset.num_data == want_rows
    # zero lost, zero double-trained: every batch exactly once
    seqs = tr2.wal.batch_seqs()
    assert len(seqs) == len(batches), f"{point}: lost/extra batches"
    assert len(set(seqs)) == len(seqs), f"{point}: duplicate batches"
    assert tr2.wal.committed_seq == tr2.wal.last_seq
    assert tr2.recovery["committed"] + tr2.recovery["replayed"] > 0
    st = tr2.statusz()
    assert st["wal"]["batches"] == len(batches)
    tr2.close()


def test_recovery_without_refeed_resumes_pending(tmp_path, monkeypatch):
    """Even with no producer re-send, restart alone must finish the job:
    pending batches replay through the trigger machinery on construction.
    The crash lands at online_publish during the cycle the 3rd batch
    triggers (30 rows = online_refit_rows), so exactly batches 0-2 are
    durable — the reference is an uninterrupted run over those three."""
    batches = _batches(6, rows=10)

    base = tmp_path / "base2"
    base.mkdir()
    monkeypatch.chdir(base)
    params = _params("wal")
    trb = _fresh_trainer(params)
    assert not _run_until_crash(trb, batches[:3])
    want_text = trb.booster.model_to_string()
    trb.close()

    d = tmp_path / "crash"
    d.mkdir()
    monkeypatch.chdir(d)
    faults.configure("online_publish:1")
    tr1 = _fresh_trainer(params)
    assert _run_until_crash(tr1, batches)
    faults.reset()
    assert tr1.wal.last_seq == 3   # the triggering batch was logged first
    tr1.wal.close()
    del tr1

    tr2 = _fresh_trainer(params)   # recovery replays pending; cycles fire
    assert tr2.cycles == 1         # the replayed 30 rows re-trigger
    tr2.flush()
    assert tr2.booster.model_to_string() == want_text
    assert tr2.wal.committed_seq == tr2.wal.last_seq == 3
    tr2.close()


# ---- async refit: feed never blocks on training ----

def test_async_feed_storm_and_freshness(tmp_path, monkeypatch):
    """online_async_refit=1: feed never waits on training. The worker's
    cycle is held on an Event while 8 feeders send 200 batches: every feed
    returns with the cycle still held (no wall-clock bound), then the
    released cycles train every batch exactly once."""
    obs.configure(enabled=True)
    params = _params(tmp_path / "w", online_async_refit=True,
                     online_refit_rows=16, online_boost_rounds=0,
                     online_freshness_slo_s=1e-4)   # every cycle breaches
    orig = OnlineTrainer._run_cycle
    gate, held = threading.Event(), threading.Event()

    def held_cycle(self, cyc):
        held.set()
        assert gate.wait(60)
        return orig(self, cyc)

    monkeypatch.setattr(OnlineTrainer, "_run_cycle", held_cycle)
    tr = _fresh_trainer(params)
    try:
        Xw, yw = _make_data(n=16, seed=123)
        assert tr.feed(Xw, yw, batch_id="warm") is None
        assert held.wait(30)          # the worker is inside a held cycle
        done, errs = [], []
        done_lock = threading.Lock()

        def feeder(t):
            try:
                rng = np.random.RandomState(100 + t)
                for i in range(25):
                    X = rng.rand(2, N_FEAT)
                    assert tr.feed(X, X[:, 0], batch_id=f"t{t}-{i}") is None
                    with done_lock:
                        done.append((t, i))
            except Exception as e:   # pragma: no cover
                errs.append(e)

        ths = [threading.Thread(target=feeder, args=(t,)) for t in range(8)]
        [t.start() for t in ths]
        [t.join(60) for t in ths]
        # every feed returned while the cycle was still held: a feed that
        # waited on training could not have
        assert not any(t.is_alive() for t in ths)
        assert not errs, errs
        assert len(done) == 200 and tr.cycles == 0
        assert not gate.is_set() and tr.pending_rows == 400
        gate.set()
        tr.flush()     # drains synchronously through the cycle lock
        assert tr.pending_rows == 0
        assert tr.cycles >= 2
        # exactly-once held under the storm: 201 unique durable batches
        seqs = tr.wal.batch_seqs()
        assert len(seqs) == 201 and len(set(seqs)) == 201
        assert tr.wal.committed_seq == tr.wal.last_seq
        assert tr.dataset.num_data == 120 + 16 + 400
        # freshness SLO plane: gauges exported, breaches counted
        snap = obs.slo.FRESHNESS.snapshot()["default"]
        assert snap["cycles"] == tr.cycles and snap["breaches"] >= 1
        mets = obs.METRICS.to_json()
        assert "refit_lag_seconds" in mets
        assert "refit_cycles" in mets and "freshness_violations" in mets
        obs.run_collectors()   # the trainer's pending-lag collector
        assert "refit_pending_lag_seconds" in obs.METRICS.to_json()
        st = tr.statusz()
        assert st["async"] and st["freshness"]["cycles"] == tr.cycles
    finally:
        gate.set()
        tr.close()
    assert tr.wal.closed


def test_failed_cycle_keeps_last_good(tmp_path, monkeypatch):
    flight_dir = tmp_path / "flight"
    flight_dir.mkdir()
    obs.configure(enabled=True)
    # another test may have tripped the process-global recorder <1s ago;
    # this test asserts dump-on-trip, not the debounce, so disable it
    monkeypatch.setattr(obs.flight, "_TRIP_DEBOUNCE_S", 0.0)
    monkeypatch.setattr(OnlineTrainer, "RETRY_BACKOFF_S", 0.4)
    # telemetry + flight_dir ride in the params: the cycle's engine.train
    # call re-applies the config's telemetry knobs (configure_from_config)
    params = _params(tmp_path / "w", online_async_refit=True,
                     online_refit_rows=10, telemetry=True,
                     flight_dir=str(flight_dir))
    tr = _fresh_trainer(params)
    try:
        last_good = tr.booster.model_to_string()
        faults.configure("online_train:1")   # first cycle attempt dies
        X, y = _make_data(n=10, seed=9)
        assert tr.feed(X, y, batch_id="fail-batch") is None
        deadline = time.time() + 30
        while tr.failures < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert tr.failures == 1
        # inside the backoff window: last-good keeps serving, bit-exactly,
        # and feeding still works (never blocked by the broken cycle)
        assert tr.cycles == 0
        assert tr.booster.model_to_string() == last_good
        st = tr.statusz()
        assert st["failures"] == 1 and "FaultInjected" in st["last_error"]
        # the failure event tripped the flight recorder
        events = obs.EVENTS.snapshot()
        fails = [e for e in events if e["type"] == "online_cycle_failed"]
        assert fails and fails[-1]["trigger"] == "rows"
        assert fails[-1]["attempt"] == 1
        assert fails[-1]["error_class"] == "FaultInjected"
        dumps = glob.glob(str(flight_dir / "flight_*online_cycle_failed*"))
        assert dumps, os.listdir(str(flight_dir))
        # the retry (fault exhausted) completes the SAME snapshot: rows
        # trained exactly once, model publishes, WAL commits
        deadline = time.time() + 60
        while tr.cycles < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert tr.cycles == 1 and tr.failures == 1
        assert tr.dataset.num_data == 130   # 120 base + the 10 fed, once
        assert tr.wal.committed_seq == tr.wal.last_seq == 1
        refits = [e for e in obs.EVENTS.snapshot()
                  if e["type"] == "online_refit"]
        assert refits and refits[-1]["attempt"] == 2
        assert tr.booster.model_to_string() != last_good
    finally:
        faults.reset()
        tr.close()


# ---- exactly-once under concurrent feeders ----

def test_concurrent_feed_cannot_commit_unbuffered_seq(tmp_path, monkeypatch):
    """Seq assignment + buffering are one atomic step: while a feeder is
    parked inside the WAL append (seq durable, rows not yet buffered), no
    other feeder may buffer a later seq and no cycle may snapshot — a
    commit through the later seq would make recovery classify the parked
    batch as already trained, silently losing it."""
    params = _params(tmp_path / "w", online_refit_rows=10_000)
    tr = _fresh_trainer(params)
    in_wal, release = threading.Event(), threading.Event()
    orig = FeedLog.append_batch

    def parked_append(self, X, y, w=None, batch_id=None, **kw):
        seq = orig(self, X, y, w, batch_id=batch_id, **kw)
        if batch_id == "parked":
            in_wal.set()
            release.wait(10)
        return seq

    monkeypatch.setattr(FeedLog, "append_batch", parked_append)
    Xa, ya = _make_data(n=4, seed=1)
    Xb, yb = _make_data(n=4, seed=2)
    ta = threading.Thread(target=tr.feed, args=(Xa, ya),
                          kwargs={"batch_id": "parked"})
    tb = threading.Thread(target=tr.feed, args=(Xb, yb),
                          kwargs={"batch_id": "other"})
    try:
        ta.start()
        assert in_wal.wait(10)
        tb.start()
        tb.join(timeout=0.3)
        assert tb.is_alive()            # serialized behind the feed lock
        # the race window: seq 1 durable but unbuffered — a cycle here
        # must find nothing to snapshot and nothing to commit
        assert tr.pending_rows == 0
        assert tr.refit_now() is None
        assert tr.wal.committed_seq == 0
    finally:
        release.set()
        ta.join()
        tb.join()
    assert tr.pending_rows == 8
    tr.flush()
    assert tr.wal.committed_seq == tr.wal.last_seq == 2
    assert sorted(tr.wal.batch_seqs()) == [1, 2]
    tr.close()


# ---- WAL retention: payload release, log rotation, artifact GC ----

def test_wal_release_and_rotation_bound_log(tmp_path):
    fl = FeedLog(str(tmp_path / "w"), keep_rows=20)
    rng = np.random.RandomState(0)
    seq = 0
    for i in range(10):
        X = rng.rand(10, N_FEAT)
        seq = fl.append_batch(X, X[:, 0], batch_id=f"r{i}")
    size_before = os.path.getsize(fl.path)
    fl.commit(seq, version=1)
    st = fl.stats()
    # committed payloads released from memory...
    assert st["resident_batches"] == 0
    # ...and the committed prefix outside the 20-row window rotated away
    # (newest two 10-row batches retained, eight batches = 80 rows dropped)
    assert st["rotations"] == 1
    assert st["rotated_batches"] == 8 and st["rotated_rows"] == 80
    assert st["batches"] == 2
    assert os.path.getsize(fl.path) < size_before
    fl.close()
    # reopen: retained frames + the ids tombstone reconstruct the state
    fl2 = FeedLog(str(tmp_path / "w"), keep_rows=20)
    assert fl2.last_seq == 10 and fl2.committed_seq == 10
    assert [b.seq for b in fl2.committed()] == [9, 10]
    assert sum(b.rows for b in fl2.committed()) == 20
    # rotated batch ids still deduplicate a producer re-send
    assert fl2.seen("r0") and fl2.seen("r7") and fl2.seen("r9")
    with pytest.raises(ValueError):
        fl2.append_batch(rng.rand(10, N_FEAT), np.zeros(10), batch_id="r0")
    # sequence numbering continues past the rotated prefix
    assert fl2.append_batch(rng.rand(2, N_FEAT), np.zeros(2)) == 11
    st2 = fl2.stats()
    assert st2["rotated_batches"] == 8 and st2["rotated_rows"] == 80
    fl2.close()


def test_wal_unbounded_mode_releases_memory_keeps_disk(tmp_path):
    fl = FeedLog(str(tmp_path / "w"))    # keep_rows=0: no rotation
    rng = np.random.RandomState(1)
    for i in range(5):
        fl.append_batch(rng.rand(10, N_FEAT), np.zeros(10))
    fl.commit(5, version=1)
    st = fl.stats()
    assert st["resident_batches"] == 0   # RAM bounded by the pending set
    assert st["rotations"] == 0 and st["batches"] == 5
    fl.close()
    fl2 = FeedLog(str(tmp_path / "w"))   # every committed row still on disk
    assert sum(b.rows for b in fl2.committed()) == 50
    assert all(b.has_payload for b in fl2.committed())
    fl2.close()


def test_wal_commit_gcs_stale_model_artifacts(tmp_path):
    fl = FeedLog(str(tmp_path / "w"))
    rng = np.random.RandomState(2)
    for seq in (1, 2):
        fl.append_batch(rng.rand(5, N_FEAT), np.zeros(5))
        with open(fl.model_artifact(seq), "w") as fh:
            fh.write(f"model {seq}\n")
        fl.commit(seq, version=seq,
                  model=os.path.basename(fl.model_artifact(seq)))
    left = sorted(fn for fn in os.listdir(fl.dir)
                  if fn.startswith("model_"))
    assert left == ["model_00000002.txt"]   # only the incumbent survives
    fl.close()


def test_trainer_rotation_recovery_window(tmp_path, monkeypatch):
    """Restart over a rotated log: the retained window rebuilds the same
    bounded dataset and the committed artifact is the same model."""
    base = tmp_path / "b"
    base.mkdir()
    monkeypatch.chdir(base)
    params = _params("wal", online_refit_rows=20, online_max_rows=40)
    tr = _fresh_trainer(params)
    stream_X, stream_y = [], []
    rng = np.random.RandomState(7)
    for i in range(5):
        X = rng.rand(20, N_FEAT)
        y = X[:, 0] + 0.5 * X[:, 1]
        stream_X.append(X)
        stream_y.append(y)
        tr.feed(X, y, batch_id=f"s{i}")
    assert tr.cycles == 5 and tr.dataset.num_data == 40
    assert tr.wal.stats()["rotations"] >= 1
    text = tr.booster.model_to_string()
    tr.wal.close()
    del tr
    tr2 = _fresh_trainer(params)
    try:
        assert tr2.booster.model_to_string() == text
        assert tr2.dataset.num_data == 40
        X0, y0 = _make_data()
        allX = np.concatenate([X0] + stream_X)
        ally = np.concatenate([y0] + stream_y)
        ref = Dataset(allX[-40:], label=ally[-40:], params=params,
                      reference=tr2.dataset)
        ref.construct()
        assert np.array_equal(np.asarray(tr2.dataset.bins[:40]),
                              np.asarray(ref.bins[:40]))
        np.testing.assert_array_equal(tr2.dataset.get_label(),
                                      ally[-40:].astype(np.float32))
    finally:
        tr2.close()


# ---- close() drains the in-flight cycle before the WAL closes ----

def test_close_drains_inflight_cycle_before_wal_close(tmp_path, monkeypatch):
    params = _params(tmp_path / "w", online_async_refit=True,
                     online_refit_rows=10)
    started = threading.Event()
    orig = OnlineTrainer._run_cycle

    def slow_cycle(self, cyc):
        started.set()
        time.sleep(0.4)
        return orig(self, cyc)

    monkeypatch.setattr(OnlineTrainer, "_run_cycle", slow_cycle)
    tr = _fresh_trainer(params)
    X, y = _make_data(n=10, seed=11)
    tr.feed(X, y, batch_id="one")
    assert started.wait(10)
    # close mid-cycle: the worker must finish — commit record landed in the
    # still-open WAL, booster swapped — before the log handle closes
    tr.close()
    assert tr._worker is None and tr.wal.closed
    assert tr.cycles == 1
    assert tr.wal.committed_seq == tr.wal.last_seq == 1


# ---- bounded sliding-window datasets ----

def test_eviction_window_bit_exact_flat():
    """The FIFO window of Dataset.append (max_rows): bins, labels and
    weights equal a reference= construct of the window and the reference
    package's appended window bit for bit; a train on it is byte-identical
    to a train on the construct."""
    X, y = _make_data(n=300, f=6, seed=31)
    w = np.linspace(0.5, 1.5, 300)
    params = {"objective": "regression", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 5, "max_bin": 63}
    pp = {**params, **CPU}
    ds = Dataset(X[:100], label=y[:100], weight=w[:100], params=pp)
    ds.construct()
    rd = lgb.Dataset(X[:100], label=y[:100], weight=w[:100], params=params)
    rd.construct()
    # grow past the cap: 100 + 80 = 180 -> keep the newest 120
    for d in (ds, rd):
        d.append(X[100:180], label=y[100:180], weight=w[100:180],
                 max_rows=120)
        assert d.num_data == 120
    ref = Dataset(X[60:180], label=y[60:180], weight=w[60:180],
                  params=pp, reference=ds)
    ref.construct()
    got = ds.bins.numpy()
    assert np.array_equal(got, ref.bins.numpy())
    assert np.array_equal(got, np.asarray(rd.bins[:120]))
    np.testing.assert_array_equal(ds.get_label(),
                                  y[60:180].astype(np.float32))
    np.testing.assert_array_equal(ds.get_weight(),
                                  w[60:180].astype(np.float32))
    np.testing.assert_array_equal(ds.label.numpy(), ds.get_label())
    # a from-scratch train over the window is byte-identical
    ma = lt.train(pp, ds, num_boost_round=3)
    mb = lt.train(pp, ref, num_boost_round=3)
    assert ma.model_to_string() == mb.model_to_string()
    # one append larger than the whole remaining window: only the newest
    # cap rows of the incoming chunk survive
    for d in (ds, rd):
        d.append(X[180:300], label=y[180:300], weight=w[180:300],
                 max_rows=120)
        assert d.num_data == 120
    ref2 = Dataset(X[180:300], label=y[180:300], weight=w[180:300],
                   params=pp, reference=ds)
    ref2.construct()
    assert np.array_equal(ds.bins.numpy(), ref2.bins.numpy())
    assert np.array_equal(ds.bins.numpy(), np.asarray(rd.bins[:120]))
    np.testing.assert_array_equal(ds.get_label(),
                                  y[180:300].astype(np.float32))


# ---- the log across the packages (byte-compatible format) ----

def _fill(fl, seed=4, rot=False):
    """The same appends, features, expiries and commits on either
    package's FeedLog; returns the batches appended."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(6):
        X = rng.rand(5, N_FEAT)
        w = np.linspace(1.0, 2.0, 5) if i == 2 else None
        out.append((X, X[:, 0], w, f"x{i}"))
        fl.append_batch(X, X[:, 0], w, batch_id=f"x{i}",
                        join_rid="r9" if i == 5 else None)
        if i == 1:
            fl.append_feature("r7", rng.rand(1, N_FEAT), ts=100.0)
            fl.append_feature("r8", rng.rand(2, N_FEAT), ts=101.0)
            fl.append_feature("r9", rng.rand(1, N_FEAT), ts=102.0)
            fl.append_expire(["r8"])
        if i == 3:
            fl.commit(fl.last_seq, version=2, model="model_00000008.txt",
                      baseline=0.25, cycle=1)
    return out


def _state(fl):
    return {"last_seq": fl.last_seq, "committed_seq": fl.committed_seq,
            "last_commit": fl.last_commit,
            "committed": [(b.seq, b.batch_id, b.rows)
                          for b in fl.committed()],
            "pending": [(b.seq, b.batch_id, b.rows) for b in fl.pending()],
            "features": fl.pending_features(),
            "expired": fl.expired_total,
            "seen": [fl.seen(f"x{i}") for i in range(7)]}


@pytest.mark.parametrize("keep_rows", [0, 10])
def test_wal_bytes_identical_across_packages(tmp_path, keep_rows):
    """The same appends, features, expiries and commits (a rotation with
    keep_rows=10) write the same file byte for byte in both packages."""
    logs = []
    for name, cls in (("port", FeedLog), ("ref", ref_wal.FeedLog)):
        fl = cls(str(tmp_path / name), keep_rows=keep_rows)
        _fill(fl)
        logs.append(fl)
        fl.close()
    a, b = (open(fl.path, "rb").read() for fl in logs)
    assert len(a) > 0 and a == b
    if keep_rows:
        assert logs[0].rotations == logs[1].rotations == 1


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_wal_recovered_across_packages(tmp_path, writer):
    """A log either package wrote, with a torn tail, is scanned and
    recovered by the other: the same truncation, seqs, ids, rows, payloads
    bit for bit, commit, pending features (read back) and expiries; the
    reader then appends on from the next seq."""
    cls = {"ref": ref_wal.FeedLog, "port": FeedLog}
    other = "port" if writer == "ref" else "ref"
    d = str(tmp_path / "w")
    fl = cls[writer](d)
    batches = _fill(fl)
    fl.append_batch(np.ones((3, N_FEAT)), np.zeros(3), batch_id="torn")
    fl.close()
    with open(fl.path, "r+b") as fh:   # a crash mid-append
        fh.truncate(os.path.getsize(fl.path) - 11)
    snap = open(fl.path, "rb").read()
    states = {}
    for pkg in (other, writer):
        with open(fl.path, "wb") as fh:
            fh.write(snap)
        r = cls[pkg](d)
        assert r.truncated_bytes > 0
        states[pkg] = (_state(r), r.truncated_bytes,
                       [(b.X.copy(), b.y.copy(),
                         None if b.w is None else b.w.copy())
                        for b in r.committed() + r.pending()],
                       r.read_feature("r7"))
        r.close()
    (st_o, tb_o, pay_o, f_o), (st_w, tb_w, pay_w, f_w) = \
        states[other], states[writer]
    assert st_o == st_w and tb_o == tb_w
    assert st_o["committed_seq"] == 8 and st_o["last_commit"]["version"] == 2
    assert [s for s, _, _ in st_o["pending"]] == [9, 10]
    assert [s["rid"] for s in st_o["features"]] == ["r7"]
    assert st_o["expired"] == 1 and not st_o["seen"][6]
    np.testing.assert_array_equal(f_o, f_w)
    for (X, y, w), (Xw, yw, ww), (X0, y0, w0, _) in zip(pay_o, pay_w,
                                                         batches):
        np.testing.assert_array_equal(X, X0)
        np.testing.assert_array_equal(X, Xw)
        np.testing.assert_array_equal(y, y0)
        assert (w is None) == (w0 is None) == (ww is None)
        if w is not None:
            np.testing.assert_array_equal(w, w0)
    r = cls[other](d)
    assert r.append_batch(np.ones((2, N_FEAT)), np.zeros(2),
                          batch_id="next") == st_o["last_seq"] + 1
    r.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_trainer_recovers_across_packages(tmp_path, monkeypatch, writer):
    """A reference trainer's WAL, killed at online_publish, is recovered by
    the port's trainer, and the port's by the reference's: the recovering
    trainer re-appends the committed rows, replays the pending batch (the
    same rows, in order) and its dataset holds the writer's rows; the
    re-sent batches all deduplicate. Models are each package's own (C2)."""
    from lightgbm_tpu.utils import faults as ref_faults
    monkeypatch.chdir(tmp_path)
    batches = _batches(6, rows=10)
    p_port = _params("wal")
    p_ref = {k: v for k, v in p_port.items() if k != "device_type"}
    X0, y0 = _make_data()
    mk = {"port": lambda: OnlineTrainer(p_port, Dataset(X0, label=y0,
                                                         params=p_port)),
          "ref": lambda: RefTrainer(p_ref, lgb.Dataset(X0, label=y0,
                                                       params=p_ref))}
    fmod = {"port": faults, "ref": ref_faults}
    fmod[writer].configure("online_publish@1")   # the second cycle dies
    tr1 = mk[writer]()
    with pytest.raises(Exception, match="online_publish"):
        for X, y, bid in batches:
            tr1.feed(X, y, batch_id=bid)
    fmod[writer].reset()
    assert tr1.wal.committed_seq == 3 and tr1.wal.last_seq == 6
    tr1.wal.close()
    del tr1
    reader = "port" if writer == "ref" else "ref"
    tr2 = mk[reader]()
    try:
        # seq 0's artifact and the first cycle's commit came from the
        # writer: the reader loads the committed model and re-appends
        # batches 1-3, then replays 4-6 (30 rows: one cycle)
        assert tr2.recovery["committed"] == 3
        assert tr2.recovery["replayed"] == 3
        assert tr2.cycles == 2 and tr2.dataset.num_data == 180
        assert tr2.wal.committed_seq == tr2.wal.last_seq == 6
        for X, y, bid in batches:
            assert tr2.feed(X, y, batch_id=bid) is None
        assert len(tr2.wal.batch_seqs()) == 6 and tr2.pending_rows == 0
        want = np.concatenate([y0] + [b[1] for b in batches])
        np.testing.assert_array_equal(np.asarray(tr2.dataset.get_label()),
                                      want.astype(np.float32))
    finally:
        tr2.close()


def test_eviction_window_bit_exact_sharded():
    """The FIFO window on a row-sharded Dataset: the window is re-planned
    over the same shard count; its bins equal a reference= construct of
    the window and the reference's sharded window bit for bit, and a
    4-shard train on it is byte-identical to a one-shard train on the
    construct (both unquantized, as the reference's CPU run is)."""
    X, y = _make_data(n=260, f=6, seed=32)
    params = {"objective": "regression", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 5, "num_shards": 4}
    pp = {**params, **CPU, "use_quantized_grad": False}
    with virtual_devices(8, "cpu"):
        ds = Dataset(X[:101], label=y[:101], params=pp)   # non-divisible
        ds.construct()
        ds.append(X[101:180], label=y[101:180], max_rows=96)
        assert ds.num_data == 96
        plan = ds.shard_plan
        assert plan is not None and plan.num_shards == 4 and \
            plan.n_rows == 96
        assert len(ds.shard_bins) == 4
        ref = Dataset(X[84:180], label=y[84:180], params=pp, reference=ds)
        ref.construct()
        assert ref.shard_plan is None
        assert np.array_equal(ds.bins.numpy(), ref.bins.numpy())
        rd = lgb.Dataset(X[:101], label=y[:101], params=params)
        rd.construct()
        rd.append(X[101:180], label=y[101:180], max_rows=96)
        assert np.array_equal(np.concatenate(
            [b.numpy() for b in ds.shard_bins]), np.asarray(rd.bins))
        ma = lt.train(pp, ds, num_boost_round=3)
        mb = lt.train(pp, ref, num_boost_round=3)
    assert ma._gbdt._shard_plan.num_shards == 4 and not mb._gbdt._dp
    assert ma.model_to_string() == mb.model_to_string()


def test_trainer_sliding_window_caps_dataset(tmp_path):
    params = _params(tmp_path / "w", online_refit_rows=20,
                     online_max_rows=150)
    tr = _fresh_trainer(params)   # 120 base rows
    try:
        stream_X, stream_y = [], []
        rng = np.random.RandomState(55)
        for i in range(5):
            X = rng.rand(20, N_FEAT)
            y = X[:, 0] + 0.5 * X[:, 1]
            stream_X.append(X)
            stream_y.append(y)
            tr.feed(X, y, batch_id=f"s{i}")   # each batch triggers a cycle
        assert tr.cycles == 5
        assert tr.dataset.num_data == 150    # capped, not 220
        # the window is the newest 150 rows of base+stream
        X0, y0 = _make_data()
        allX = np.concatenate([X0] + stream_X)
        ally = np.concatenate([y0] + stream_y)
        ref = Dataset(allX[-150:], label=ally[-150:], params=params,
                      reference=tr.dataset)
        ref.construct()
        assert np.array_equal(np.asarray(tr.dataset.bins[:150]),
                              np.asarray(ref.bins[:150]))
        np.testing.assert_array_equal(tr.dataset.get_label(),
                                      ally[-150:].astype(np.float32))
    finally:
        tr.close()


def test_window_smaller_than_trigger_rejected():
    with pytest.raises(LightGBMError, match="online_max_rows"):
        params_to_config({"online_max_rows": 10, "online_refit_rows": 20})
    conf = params_to_config({"online_max_rows": 0,
                             "online_refit_rows": 20})
    assert conf.online_max_rows == 0     # 0 = unbounded stays valid


# ---- tail_source: partial lines, truncation, rotation, ids ----

def test_tail_source_buffers_partial_lines(tmp_path):
    path = str(tmp_path / "feed.csv")
    fh = open(path, "w")
    fh.write("1.0,0.1,0.2\n2.0,0.3,")   # second line torn mid-write
    fh.flush()
    gen = tail_source(path, follow=True)
    try:
        b = next(gen)
        assert b is not None
        np.testing.assert_array_equal(b[1], [1.0])   # line 1 only
        assert next(gen) is None                     # caught up, tail held
        fh.write("0.4\n")                            # the line completes
        fh.flush()
        b = next(gen)
        assert b is not None
        np.testing.assert_array_equal(b[0], [[0.3, 0.4]])
        np.testing.assert_array_equal(b[1], [2.0])
    finally:
        gen.close()
        fh.close()


def test_tail_source_final_unterminated_line(tmp_path):
    path = str(tmp_path / "feed.csv")
    with open(path, "w") as fh:
        fh.write("1.0,0.1,0.2\n2.0,0.3,0.4")   # no trailing newline
    batches = [b for b in tail_source(path, follow=False) if b is not None]
    ys = np.concatenate([b[1] for b in batches])
    np.testing.assert_array_equal(ys, [1.0, 2.0])


def test_tail_source_detects_truncation_and_rotation(tmp_path):
    path = str(tmp_path / "feed.csv")
    with open(path, "w") as fh:
        fh.write("1.0,0.1,0.2\n2.0,0.3,0.4\n")
    gen = tail_source(path, follow=True)
    try:
        b = next(gen)
        np.testing.assert_array_equal(b[1], [1.0, 2.0])
        # truncation: the file shrank below the read position -> reopen
        with open(path, "w") as fh:
            fh.write("3.0,0.5,0.6\n")
        b = next(gen)
        assert b is not None
        np.testing.assert_array_equal(b[1], [3.0])
        # rotation: the path now names a different inode -> reopen at 0
        os.replace(path, path + ".1")
        with open(path, "w") as fh:
            fh.write("4.0,0.7,0.8\n")
        b = next(gen)
        assert b is not None
        np.testing.assert_array_equal(b[1], [4.0])
    finally:
        gen.close()


def test_tail_source_ids_stable_across_chunking(tmp_path):
    path = str(tmp_path / "feed.csv")
    with open(path, "w") as fh:
        fh.write("# header\n1.0,0.1,0.2\n2.0,0.3,0.4\n3.0,0.5,0.6\n")
    whole = [b for b in tail_source(path, follow=False, with_ids=True)
             if b is not None]
    assert len(whole) == 3 and all(len(b) == 4 for b in whole)
    ids_whole = [b[3] for b in whole]
    assert len(set(ids_whole)) == 3
    # a second pass (a restarted producer) derives the SAME ids, and so
    # does the reference's tailer: a feed file's ids dedup in either
    # package's log
    again = [b[3] for b in tail_source(path, follow=False, with_ids=True)
             if b is not None]
    assert again == ids_whole
    ref = [b for b in ref_tail_source(path, follow=False, with_ids=True)
           if b is not None]
    assert [b[3] for b in ref] == ids_whole
    for a_, r_ in zip(whole, ref):
        np.testing.assert_array_equal(a_[0], r_[0])
        np.testing.assert_array_equal(a_[1], r_[1])


def test_tail_source_truncation_rekeys_ids(tmp_path):
    """A copytruncate-style rotation reuses the inode AND the old byte
    offsets; without the content signature the rewritten file's rows would
    inherit the old rows' ids and wal.seen() would silently drop all the
    new data as duplicates."""
    path = str(tmp_path / "feed.csv")
    with open(path, "w") as fh:
        fh.write("1.0,0.1,0.2\n2.0,0.3,0.4\n")
    gen = tail_source(path, follow=True, with_ids=True)
    try:
        first = [next(gen)[3], next(gen)[3]]
        assert next(gen) is None           # caught up, holding the inode
        with open(path, "w") as fh:        # truncate + rewrite, same inode
            fh.write("3.0,0.5,0.6\n")
        b = next(gen)                      # truncation detected -> reopen
        assert b is not None
        np.testing.assert_array_equal(b[1], [3.0])
        # same inode, same offset 0 — the signature must re-key the id
        assert b[3] not in first
    finally:
        gen.close()


def test_producer_restart_dedups_through_wal(tmp_path):
    path = str(tmp_path / "feed.csv")
    rng = np.random.RandomState(3)
    with open(path, "w") as fh:
        for _ in range(5):
            v = rng.rand(N_FEAT + 1)
            fh.write(",".join("%.17g" % x for x in v) + "\n")
    params = _params(tmp_path / "w", online_refit_rows=3,
                     num_iterations=2, online_boost_rounds=1)
    tr1 = _fresh_trainer(params)
    fed = tr1.run(tail_source(path, follow=False, with_ids=True))
    assert fed == 5
    assert tr1.wal.committed_seq == tr1.wal.last_seq == 5
    text1 = tr1.booster.model_to_string()
    tr1.close()
    # restart both halves: trainer recovers, producer re-reads from the
    # start — every re-sent batch is already in the log and drops
    tr2 = _fresh_trainer(params)
    fed2 = tr2.run(tail_source(path, follow=False, with_ids=True))
    assert fed2 == 5                       # offered again...
    assert len(tr2.wal.batch_seqs()) == 5  # ...but logged exactly once
    assert tr2.booster.model_to_string() == text1
    tr2.close()


def test_kill_and_replay_across_processes(tmp_path):
    """scripts/torch_online_drill.py on the CPU: a process feeds four
    batches into a WAL-backed trainer and dies at online_publish (exit 3);
    a second process over the same log recovers, trains the pending
    batches once and commits them, deduplicates every re-sent batch, and
    ends with the model text of an uninterrupted trainer in this process,
    byte for byte."""
    import json
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.RandomState(21)
    X = rng.rand(520, N_FEAT)
    y = np.round((X[:, 0] + 0.5 * X[:, 1]) * 8) / 8
    np.save(tmp_path / "rows.npy", X)
    np.save(tmp_path / "labels.npy", y)
    base = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
            "min_data_in_leaf": 5, "online_refit_rows": 120,
            "online_boost_rounds": 2, "online_max_rows": 400}
    b1 = lt.train({**base, **CPU}, Dataset(X[:400], label=y[:400],
                                           params={**base, **CPU}), 3)
    model = str(tmp_path / "b1.txt")
    b1.save_model(model)
    cmd = [sys.executable, os.path.join(repo, "scripts",
                                        "torch_online_drill.py"),
           str(tmp_path / "rows.npy"), str(tmp_path / "labels.npy"), model,
           str(tmp_path / "wal"), json.dumps(base), "--base-rows", "400",
           "--batch-rows", "30", "--batches", "4", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([repo] + sys.path))
    r1 = subprocess.run(cmd + ["--crash"], capture_output=True, text=True,
                        timeout=600, env=env, cwd=str(tmp_path))
    assert r1.returncode == 3, r1.stderr[-2000:]
    c = json.loads(r1.stdout.strip().splitlines()[-1])
    assert c["died_at"] == "online_publish"
    assert (c["last_seq"], c["committed_seq"]) == (4, 0)
    out = str(tmp_path / "recovered.txt")
    r2 = subprocess.run(cmd + ["--recover", "--out", out],
                        capture_output=True, text=True, timeout=600, env=env,
                        cwd=str(tmp_path))
    assert r2.returncode == 0, r2.stderr[-2000:]
    rec = json.loads(r2.stdout.strip().splitlines()[-1])
    assert rec["recovery"]["replayed"] == 4 and rec["cycles"] == 1
    assert rec["batch_seqs"] == rec["batch_seqs_after_resend"] == [1, 2, 3, 4]
    assert rec["committed_seq"] == rec["last_seq"] == 4
    assert rec["resend_deduped"] and rec["num_data"] == 400
    # the uninterrupted run, in this process
    p = {**base, **CPU, "online_wal": True,
         "online_wal_dir": str(tmp_path / "wal2")}
    tr = OnlineTrainer(p, Dataset(X[:400], label=y[:400], params=p),
                       booster=lt.Booster(model_file=model, params=p))
    for i in range(4):
        tr.feed(X[400 + 30 * i:430 + 30 * i], y[400 + 30 * i:430 + 30 * i],
                batch_id=f"b{i}")
    assert tr.cycles == 1
    assert open(out).read() == tr.booster.model_to_string()
    arts = glob.glob(str(tmp_path / "wal" / "model_*.txt"))
    assert [os.path.basename(a) for a in arts] == ["model_00000004.txt"]
    assert open(arts[0]).read() == tr.booster.model_to_string()
    tr.close()
