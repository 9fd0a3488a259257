"""Label-resilient continuous learning of the PyTorch/CUDA port
(lightgbm_tpu_torch/join.py, online.py, wal.py), on the CPU: the cases of
the reference's tests/test_online_join.py on the port, its join buffer
held against the reference's (lightgbm_tpu/join.py), and a pure-C host
through the C API's continuous-learning entries.

Three drills anchor the contract:

- **join chaos**: a simulated ``kill -9`` (FaultInjected) at any crash point
  between feature capture, label arrival, and join-commit, followed by a
  restart + full producer re-send, yields a model byte-identical to the
  uninterrupted run's — zero lost rows, zero double-joined rows, asserted
  from the WAL's sequence numbers;
- **unlabeled drift**: a shifted *unlabeled* prediction stream fires the PSI
  trigger and publishes a refit with zero labeled batches involved in the
  trigger; alarm-only mode emits the event without cycling;
- **isolation**: in a two-model group, forcing model A's cycle failure — and
  separately corrupting A's WAL tail on disk — leaves model B's refit
  cadence and published model bit-exactly unaffected.

Across the packages: the same captures, labels, sweeps and spills through
both join buffers give the same fed rows, counters and events, exactly.
The C host's model text equals the same calls through the Python API.
"""
import errno
import glob
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time

import numpy as np
import pytest

from lightgbm_tpu import join as ref_join
from lightgbm_tpu import wal as ref_wal
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.basic import Dataset
from lightgbm_tpu_torch.join import JoinBuffer
from lightgbm_tpu_torch.online import OnlineTrainer, OnlineTrainerGroup
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.faults import FaultInjected
from lightgbm_tpu_torch.wal import FeedLog, WalUnavailable
import lightgbm_tpu_torch.join as join_module
import lightgbm_tpu_torch.wal as wal_module
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
    lockwatch.WATCH.assert_clean("tests/test_torch_online_join.py")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _clean_faults_and_obs():
    faults.reset()
    yield
    faults.reset()
    obs.configure(enabled=False)
    obs.reset()
    obs.flight.FLIGHT.reset()


N_FEAT = 4


def _make_data(n=120, f=N_FEAT, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    y = X[:, 0] + 0.5 * X[:, 1] + 0.05 * rng.rand(n)
    return X, y


def _events(rows=40, rows_per=1, f=N_FEAT, seed=77):
    """The delayed-label producer's stream: (rid, X, y) capture/label pairs."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(rows):
        X = rng.rand(rows_per, f)
        out.append((f"r{i:03d}", X, X[:, 0] + 0.5 * X[:, 1]))
    return out


def _params(wal_dir, **extra):
    p = {"objective": "regression", "num_leaves": 7, "verbose": -1,
         "min_data_in_leaf": 5, "num_iterations": 3,
         "online_refit_rows": 30, "online_boost_rounds": 2,
         "online_wal": True, "online_wal_dir": str(wal_dir), **CPU}
    p.update(extra)
    return p


def _fresh_trainer(params):
    X0, y0 = _make_data()
    return OnlineTrainer(params, Dataset(X0, label=y0, params=params))


def _event_types():
    return [e["type"] for e in obs.EVENTS.snapshot()]


def _last_event(etype):
    evs = [e for e in obs.EVENTS.snapshot() if e["type"] == etype]
    return evs[-1] if evs else None


# ---- JoinBuffer units ----

def test_join_capture_label_roundtrip():
    fed = []
    jb = JoinBuffer(lambda rid, X, y, w: fed.append((rid, X, y, w)) or 7,
                    timeout_s=300.0)
    X = np.array([[1.0, 2.0, 3.0, 4.0]])
    assert jb.capture("a", X) == 1
    assert jb.capture("b", X[0]) == 2        # 1-D row normalizes to (1, f)
    assert jb.label("a", 5.0) == 7
    assert len(fed) == 1 and fed[0][0] == "a"
    np.testing.assert_array_equal(fed[0][1], X)
    np.testing.assert_array_equal(fed[0][2], [5.0])
    st = jb.stats()
    assert st["captured"] == 2 and st["joined"] == 1 and st["pending"] == 1
    assert st["oldest_pending_age_s"] is not None
    # duplicate capture: first wins, counted
    assert jb.capture("b", X) == 1
    assert jb.stats()["duplicates"] == 1


def test_join_unmatched_label_counted_not_fed():
    fed = []
    jb = JoinBuffer(lambda rid, X, y, w: fed.append(rid))
    assert jb.label("ghost", 1.0) is None
    assert not fed
    assert jb.stats()["unmatched"] == 1


def test_join_scalar_label_broadcasts_over_rows():
    fed = []
    jb = JoinBuffer(lambda rid, X, y, w: fed.append((X, y)))
    jb.capture("m", np.ones((3, N_FEAT)))
    jb.label("m", 2.0)
    np.testing.assert_array_equal(fed[0][1], [2.0, 2.0, 2.0])


def test_join_timeout_expires_orphans_exactly_once(tmp_path):
    obs.configure(enabled=True)
    fl = FeedLog(str(tmp_path / "w"))
    jb = JoinBuffer(lambda rid, X, y, w: 0, wal=fl, timeout_s=10.0,
                    name="m1")
    t0 = time.time()
    for i in range(5):
        jb.capture(f"o{i}", np.ones((1, N_FEAT)), ts=t0)
    jb.capture("fresh", np.ones((1, N_FEAT)), ts=t0 + 9.0)
    assert jb.sweep(now=t0 + 11.0) == 5      # the fresh one survives
    assert jb.sweep(now=t0 + 11.0) == 0      # idempotent: already expired
    st = jb.stats()
    assert st["expired"] == 5 and st["pending"] == 1
    ev = _last_event("join_expired")
    assert ev and ev["expired"] == 5 and ev["pending"] == 1
    assert ev["model"] == "m1" and ev["reason"] == "timeout"
    assert ev["oldest_age_s"] >= 10.0
    # an expired rid's late label is unmatched — counted, never trained
    assert jb.label("o0", 1.0) is None
    assert jb.stats()["unmatched"] == 1
    fl.close()
    # the EXPIRE tombstone persists: a restart's rebuild neither resurrects
    # the orphans nor forgets the count
    fl2 = FeedLog(str(tmp_path / "w"))
    jb2 = JoinBuffer(lambda rid, X, y, w: 0, wal=fl2, timeout_s=10.0)
    assert jb2.rebuild() == 1
    st2 = jb2.stats()
    assert st2["pending"] == 1 and st2["expired"] == 5
    fl2.close()


def test_join_overflow_spills_to_wal_and_reads_back(tmp_path):
    fed = []
    fl = FeedLog(str(tmp_path / "w"))
    jb = JoinBuffer(lambda rid, X, y, w: fed.append((rid, X)) or 0,
                    wal=fl, max_pending=3)
    rows = {f"s{i}": np.full((1, N_FEAT), float(i)) for i in range(6)}
    for rid, X in rows.items():
        jb.capture(rid, X)
    st = jb.stats()
    # every entry still joinable, only the oldest payloads left memory
    assert st["pending"] == 6 and st["spilled"] == 3 and st["resident"] == 3
    assert st["expired"] == 0
    for rid in rows:
        assert jb.label(rid, 1.0) == 0
    assert jb.stats()["joined"] == 6
    # spilled payloads came back byte-exact from the log
    by_rid = dict(fed)
    for rid, X in rows.items():
        np.testing.assert_array_equal(by_rid[rid], X)
    fl.close()


def test_join_overflow_without_wal_drops_counted():
    obs.configure(enabled=True)
    jb = JoinBuffer(lambda rid, X, y, w: 0, wal=None, max_pending=2,
                    name="m2")
    for i in range(5):
        jb.capture(f"d{i}", np.ones((1, N_FEAT)))
    st = jb.stats()
    assert st["pending"] == 2 and st["expired"] == 3
    ev = _last_event("join_expired")
    assert ev and ev["reason"] == "overflow" and ev["model"] == "m2"


def test_join_rebuild_recovers_pending_from_wal(tmp_path):
    # the feed_fn seals the join like the trainer does: the WAL batch
    # record carries the rid, atomically retiring the FEAT stub
    def _feed_for(log, sink=None):
        def _feed(rid, X, y, w):
            if sink is not None:
                sink.append((rid, X))
            log.append_batch(X, y, w, batch_id=JoinBuffer.batch_id_for(rid),
                             join_rid=rid)
            return 0
        return _feed

    fl = FeedLog(str(tmp_path / "w"))
    jb = JoinBuffer(_feed_for(fl), wal=fl)
    X = np.arange(N_FEAT, dtype=np.float64).reshape(1, -1)
    jb.capture("keep", X)
    jb.capture("gone", X + 1)
    assert jb.label("gone", 1.0) == 0
    fl.close()

    fed = []
    fl2 = FeedLog(str(tmp_path / "w"))
    jb2 = JoinBuffer(_feed_for(fl2, fed), wal=fl2)
    assert jb2.rebuild() == 1                # only the unjoined rid returns
    assert jb2.stats()["pending"] == 1 and jb2.stats()["recovered"] == 1
    # the joined rid's re-sent label deduplicates (idempotent producer)
    assert jb2.label("gone", 1.0) is None
    assert jb2.stats()["duplicates"] == 1
    # the pending rid joins from its on-disk payload
    assert jb2.label("keep", 2.0) == 0
    np.testing.assert_array_equal(fed[0][1], X)
    fl2.close()


def _join_script(mod, wal_mod, d, max_pending, timeout_s):
    """One capture / label / sweep / spill script through a package's
    JoinBuffer over its FeedLog; returns what was fed, the counters, the
    join_expired events and the log's bytes."""
    fed = []
    fl = wal_mod.FeedLog(str(d)) if d is not None else None

    def feed(rid, X, y, w):
        fed.append((rid, X.copy(), y.copy()))
        if fl is not None:
            fl.append_batch(X, y, w, batch_id=mod.JoinBuffer.batch_id_for(rid),
                            join_rid=rid)
        return 0

    jb = mod.JoinBuffer(feed, wal=fl, timeout_s=timeout_s,
                        max_pending=max_pending, name="m")
    rng = np.random.RandomState(12)
    t0 = float(int(time.time()))
    for i in range(8):
        jb.capture(f"c{i}", rng.rand(1 + i % 2, N_FEAT), ts=t0 + i)
    jb.capture("c3", rng.rand(1, N_FEAT), ts=t0 + 9)   # duplicate
    labels = [jb.label(f"c{i}", float(i)) for i in (0, 2, 5, 7)]
    labels.append(jb.label("ghost", 1.0))
    labels.append(jb.label("c2", 1.0))                 # already joined
    expired = jb.sweep(now=t0 + timeout_s + 3.5)
    st = jb.stats()
    st.pop("oldest_pending_age_s")
    out = (fed, labels, expired, st)
    if fl is not None:
        fl.close()
        out += (open(fl.path, "rb").read(),)
    return out


@pytest.mark.parametrize("wal,max_pending", [(False, 100), (True, 3),
                                             (False, 3)])
def test_join_buffer_matches_reference(tmp_path, wal, max_pending):
    """The same script (captures with a duplicate, labels with an unmatched
    and a re-sent one, a timeout sweep; spills past max_pending with a
    WAL, drops without) through the port's and the reference's join
    buffers: the same fed rows, returns, counters and join_expired events,
    and with a WAL the same log bytes."""
    from lightgbm_tpu import obs as ref_obs
    outs, evs = [], []
    for name, mod, wmod, o in (("port", join_module, wal_module, obs),
                               ("ref", ref_join, ref_wal, ref_obs)):
        o.configure(enabled=True)
        o.EVENTS.clear()
        try:
            outs.append(_join_script(mod, wmod,
                                     tmp_path / name if wal else None,
                                     max_pending, 100.0))
            evs.append([{k: v for k, v in e.items() if k != "ts"}
                        for e in o.EVENTS.snapshot()
                        if e["type"] == "join_expired"])
        finally:
            o.configure(enabled=False)
            o.EVENTS.clear()
    (fa, la, xa, sa, *ba), (fb, lb, xb, sb, *bb) = outs
    assert la == lb and xa == xb and sa == sb and evs[0] == evs[1]
    assert [r for r, _, _ in fa] == [r for r, _, _ in fb]
    for (_, Xa, ya), (_, Xb, yb) in zip(fa, fb):
        np.testing.assert_array_equal(Xa, Xb)
        np.testing.assert_array_equal(ya, yb)
    assert ba == bb
    if wal:   # a re-sent label of a joined rid dedups against the log
        assert (sa["joined"], sa["unmatched"], sa["duplicates"]) == (4, 1, 2)
        assert sa["spilled"] > 0 and xa == 2
    elif max_pending == 100:
        assert (sa["joined"], sa["unmatched"], sa["duplicates"]) == (4, 2, 1)
    else:     # nothing to spill into: overflow drops, counted
        assert sa["expired"] > 0 and evs[0][0]["reason"] == "overflow"


# ---- WAL feature frames + rotation ----

def test_wal_feature_frames_survive_rotation(tmp_path):
    fl = FeedLog(str(tmp_path / "w"), keep_rows=20)
    rng = np.random.RandomState(0)
    Xp = rng.rand(2, N_FEAT)
    fl.append_feature("pend", Xp)
    seq = 0
    for i in range(10):
        X = rng.rand(10, N_FEAT)
        seq = fl.append_batch(X, X[:, 0], batch_id=f"r{i}")
    fl.commit(seq, version=1)               # rotates the committed prefix
    assert fl.stats()["rotations"] == 1
    # the pending FEAT frame rode through the rotation, offset re-homed
    np.testing.assert_array_equal(fl.read_feature("pend"), Xp)
    assert [s["rid"] for s in fl.pending_features()] == ["pend"]
    fl.close()
    fl2 = FeedLog(str(tmp_path / "w"), keep_rows=20)
    assert [s["rid"] for s in fl2.pending_features()] == ["pend"]
    np.testing.assert_array_equal(fl2.read_feature("pend"), Xp)
    fl2.close()


def test_wal_expired_total_survives_rotation(tmp_path):
    fl = FeedLog(str(tmp_path / "w"), keep_rows=10)
    rng = np.random.RandomState(1)
    fl.append_feature("o1", rng.rand(1, N_FEAT))
    fl.append_expire(["o1"])
    assert fl.expired_total == 1
    seq = 0
    for i in range(4):
        X = rng.rand(10, N_FEAT)
        seq = fl.append_batch(X, X[:, 0], batch_id=f"b{i}")
    fl.commit(seq, version=1)
    fl.close()
    fl2 = FeedLog(str(tmp_path / "w"), keep_rows=10)
    assert fl2.expired_total == 1           # carried by the ids tombstone
    assert fl2.pending_features() == []
    fl2.close()


# ---- the join kill-and-replay chaos drill ----

JOIN_CRASH_POINTS = ("join_capture", "join_label", "join_commit",
                     "online_publish")


def _run_stream_until_crash(tr, events):
    """Capture + label every event, then flush; returns True if a
    FaultInjected 'killed the process' first. The caller discards the
    trainer afterwards — that discard IS the kill -9 simulation."""
    try:
        for rid, X, y in events:
            tr.feed_features(rid, X)
            tr.feed_label(rid, float(y[0]) if y.shape[0] == 1 else y)
        tr.flush()
    except FaultInjected:
        return True
    return False


@pytest.fixture(scope="module")
def join_uninterrupted(tmp_path_factory):
    """The uninterrupted run of the join chaos drill. The model text echoes
    online_wal_dir — byte-identity needs the SAME dir string in every run,
    so each run gets its own cwd + a relative "wal"."""
    events = _events(40)
    base = tmp_path_factory.mktemp("base")
    cwd = os.getcwd()
    os.chdir(base)
    try:
        tr = _fresh_trainer(_params("wal"))
        assert not _run_stream_until_crash(tr, events)
        want = (tr.booster.model_to_string(), tr.dataset.num_data)
        assert tr.wal.committed_seq == tr.wal.last_seq
        assert len(tr.wal.batch_seqs()) == len(events)
        assert tr.join_stats()["joined"] == len(events)
        tr.close()
    finally:
        os.chdir(cwd)
    return want, events


@pytest.mark.parametrize("point", JOIN_CRASH_POINTS)
def test_join_kill_and_replay_byte_identical(tmp_path, monkeypatch,
                                             join_uninterrupted, point):
    (want_text, want_rows), events = join_uninterrupted
    params = _params("wal")
    d = tmp_path / point
    d.mkdir()
    monkeypatch.chdir(d)
    # fire mid-stream: the 13th capture / label / commit, or the first
    # publish (the cycle the 30th joined row triggers)
    spec = f"{point}@12" if point != "online_publish" else f"{point}:1"
    faults.configure(spec)
    tr1 = _fresh_trainer(params)
    crashed = _run_stream_until_crash(tr1, events)
    faults.reset()
    assert crashed, f"fault point {point} never fired"
    tr1.wal.close()   # the fd would leak; a real kill -9 drops it too
    del tr1           # kill -9: trainer + join buffer state is gone

    # restart: recovery rebuilds pending joins from FEAT records, then
    # the producer re-sends EVERY capture + label with the same rids
    tr2 = _fresh_trainer(params)
    assert not _run_stream_until_crash(tr2, events)
    assert tr2.booster.model_to_string() == want_text, \
        f"recovered model differs after crash at {point}"
    assert tr2.dataset.num_data == want_rows
    # zero lost, zero double-joined: every rid trained exactly once
    seqs = tr2.wal.batch_seqs()
    assert len(seqs) == len(events), f"{point}: lost/extra joins"
    assert len(set(seqs)) == len(seqs), f"{point}: double-joined rows"
    assert tr2.wal.committed_seq == tr2.wal.last_seq
    js = tr2.join_stats()
    assert js["pending"] == 0 and js["expired"] == 0
    assert js["unmatched"] == 0
    # every event either joined this run or deduplicated against a
    # pre-crash join (capture + label re-sends each count once)
    assert js["joined"] + js["duplicates"] >= len(events)
    assert tr2.wal.pending_features() == []
    tr2.close()


def test_join_restart_without_label_resend_keeps_pending(tmp_path):
    """Labels that never re-send still join after a crash: the FEAT records
    alone rebuild the pending set, and late labels complete the joins."""
    params = _params(tmp_path / "w", online_refit_rows=1000)
    events = _events(10)
    tr1 = _fresh_trainer(params)
    for rid, X, y in events:
        tr1.feed_features(rid, X)
    for rid, X, y in events[:4]:
        tr1.feed_label(rid, float(y[0]))
    tr1.wal.close()
    del tr1

    tr2 = _fresh_trainer(params)
    js = tr2.join_stats()
    assert js["pending"] == 6 and js["recovered"] == 6
    for rid, X, y in events[4:]:
        assert tr2.feed_label(rid, float(y[0])) is not None or True
    js = tr2.join_stats()
    assert js["pending"] == 0 and js["joined"] == 6
    assert len(tr2.wal.batch_seqs()) == 10
    tr2.flush()
    assert tr2.wal.committed_seq == tr2.wal.last_seq
    tr2.close()


# ---- unlabeled drift detection ----

def _drift_trainer(tmp_path, **extra):
    # telemetry rides in the params: the trainer's initial train (and every
    # cycle) re-applies the config's telemetry knobs, so the test's
    # obs.configure(enabled=True) would otherwise be reverted
    params = _params(tmp_path / "w", online_refit_rows=1000,
                     online_drift_psi_max=0.1, telemetry=True, **extra)
    tr = _fresh_trainer(params)
    tr.DRIFT_EVAL_EVERY = 8        # instance override: small test streams
    tr.DRIFT_MIN_SCORES = 32
    return tr


def test_unlabeled_drift_triggers_refit_without_labels(tmp_path):
    obs.configure(enabled=True)
    tr = _drift_trainer(tmp_path)
    try:
        X, y = _make_data(n=80, seed=21)
        # baseline: in-distribution served scores (no labels anywhere)
        tr.observe_served(tr.booster.predict(X[:40]))
        assert tr._drift_baseline_ts is not None
        # a few labeled rows pend but never trigger (refit_rows=1000) —
        # the cycle below is fired by drift alone
        tr.feed(X[:20], y[:20], batch_id="pend")
        assert tr.cycles == 0
        # undrifted traffic (same score distribution): no trip
        tr.observe_served(tr.booster.predict(X[:40]))
        assert tr.drift_trips == 0
        # shifted unlabeled traffic: PSI fires, refit publishes
        tr.observe_served(tr.booster.predict(X[:40] + 5.0))
        assert tr.drift_trips == 1
        assert tr.cycles == 1 and tr.version == 1
        ev = _last_event("drift_unlabeled")
        assert ev and ev["action"] == "refit" and ev["psi"] > 0.1
        assert ev["pending_rows"] == 20 and ev["model"] == "default"
        refit = _last_event("online_refit")
        assert refit and refit["trigger"] == "drift_unlabeled"
        # the cycle rebaselined: the latch cleared, post-refit
        # in-distribution traffic does not re-fire
        assert not tr._drift_fired
        tr.observe_served(tr.booster.predict(X[40:80]))
        assert tr.drift_trips == 1
        st = tr.statusz()
        assert st["drift"]["trips"] == 1
        assert st["drift"]["baseline_age_s"] is not None
    finally:
        tr.close()


def test_unlabeled_drift_alarm_mode_does_not_cycle(tmp_path):
    obs.configure(enabled=True)
    tr = _drift_trainer(tmp_path, online_drift_mode="alarm")
    try:
        X, y = _make_data(n=40, seed=22)
        tr.observe_served(tr.booster.predict(X))
        tr.feed(X[:20], y[:20], batch_id="pend")
        before = tr.booster.model_to_string()
        tr.observe_served(tr.booster.predict(X + 5.0))
        assert tr.drift_trips == 1
        assert tr.cycles == 0 and tr.version == 0
        assert tr.booster.model_to_string() == before   # last-good serves
        ev = _last_event("drift_unlabeled")
        assert ev and ev["action"] == "alarm"
        # the flight recorder tripped: drift is a postmortem-worthy event
        assert "drift_unlabeled" in obs.flight.TRIP_EVENTS
    finally:
        tr.close()


def test_unlabeled_drift_with_scarce_labels_degrades_to_alarm(tmp_path):
    """Graceful degradation: drift detected but ZERO labeled rows pending —
    nothing to refit on, so the trip alarms and last-good keeps serving."""
    obs.configure(enabled=True)
    tr = _drift_trainer(tmp_path)
    try:
        X, _ = _make_data(n=40, seed=23)
        tr.observe_served(tr.booster.predict(X))
        tr.observe_served(tr.booster.predict(X + 5.0))
        assert tr.drift_trips == 1
        assert tr.cycles == 0 and tr.version == 0
        ev = _last_event("drift_unlabeled")
        assert ev and ev["action"] == "alarm" and ev["pending_rows"] == 0
    finally:
        tr.close()


# ---- per-model trainer group: failure isolation drills ----

def _feed_group_stream(g, model, seed, n=5):
    rng = np.random.RandomState(seed)
    for i in range(n):
        X = rng.rand(10, N_FEAT)
        g.feed(X, X[:, 0] + 0.5 * X[:, 1], batch_id=f"{model}-{seed}-{i}",
               model=model)


def _fresh_group(params):
    Xa, ya = _make_data(seed=41)
    Xb, yb = _make_data(seed=42)
    g = OnlineTrainerGroup(params)
    g.add("a", Dataset(Xa, label=ya, params=params))
    g.add("b", Dataset(Xb, label=yb, params=params))
    return g


def test_group_per_model_wal_dirs_and_routing(tmp_path):
    params = _params(tmp_path / "gw")
    g = _fresh_group(params)
    try:
        assert g.names() == ["a", "b"]
        assert os.path.isdir(str(tmp_path / "gw" / "a"))
        assert os.path.isdir(str(tmp_path / "gw" / "b"))
        g.feed_features("q1", np.ones(N_FEAT), model="a")
        assert g.join_stats("a")["pending"] == 1
        assert g.join_stats("b")["pending"] == 0
        g.feed_label("q1", 1.0, model="a")
        assert g.join_stats("a")["joined"] == 1
        with pytest.raises(KeyError, match="'c'"):
            g.feed(np.ones((1, N_FEAT)), [1.0], model="c")
        with pytest.raises(ValueError, match="already exists"):
            g.add("a", Dataset(*_make_data(seed=9), params=params))
        st = g.statusz()
        assert sorted(st["models"]) == ["a", "b"]
        assert st["models"]["a"]["join"]["joined"] == 1
    finally:
        g.close()


def test_group_cycle_failure_isolated(tmp_path, monkeypatch):
    """Force model A's refit cycle to fail: B's cadence and published model
    must be bit-exactly what they are in a healthy run."""
    base = tmp_path / "ref"
    base.mkdir()
    monkeypatch.chdir(base)
    params = _params("gw", num_iterations=2)
    g0 = _fresh_group(params)
    _feed_group_stream(g0, "b", seed=88)
    g0.flush(model="b")
    want_b = g0.get("b").booster.model_to_string()
    want_b_cycles = g0.get("b").cycles
    g0.close()

    d = tmp_path / "drill"
    d.mkdir()
    monkeypatch.chdir(d)
    g = _fresh_group(params)
    try:
        tr_a = g.get("a")
        a_last_good = tr_a.booster.model_to_string()

        def broken_cycle(cyc):
            raise RuntimeError("model A cycle sabotaged")

        monkeypatch.setattr(tr_a, "_run_cycle", broken_cycle)
        with pytest.raises(RuntimeError, match="sabotaged"):
            _feed_group_stream(g, "a", seed=87)
        assert tr_a.failures >= 1 and tr_a.cycles == 0
        assert tr_a.booster.model_to_string() == a_last_good
        # B is untouched: same stream -> same cadence, same bytes
        _feed_group_stream(g, "b", seed=88)
        g.flush(model="b")
        tr_b = g.get("b")
        assert tr_b.failures == 0
        assert tr_b.cycles == want_b_cycles
        assert tr_b.booster.model_to_string() == want_b
        assert tr_b.wal.committed_seq == tr_b.wal.last_seq
    finally:
        g.close()


def test_group_wal_corruption_isolated(tmp_path, monkeypatch):
    """Corrupt model A's WAL tail on disk: A's restart recovers (truncating
    the torn tail), and B's log + recovered model are bit-exact."""
    base = tmp_path / "run"
    base.mkdir()
    monkeypatch.chdir(base)
    params = _params("gw", num_iterations=2)
    g = _fresh_group(params)
    _feed_group_stream(g, "a", seed=87)
    _feed_group_stream(g, "b", seed=88)
    want_b = g.get("b").booster.model_to_string()
    b_seqs = g.get("b").wal.batch_seqs()
    g.close()

    # scribble garbage over A's log tail (a torn final record)
    a_log = os.path.join("gw", "a", "feed.wal")
    size = os.path.getsize(a_log)
    with open(a_log, "r+b") as fh:
        fh.truncate(size - 21)
        fh.seek(size - 21)
        fh.write(b"\xde\xad\xbe\xef")

    g2 = _fresh_group(params)
    try:
        assert g2.get("a").wal.truncated_bytes > 0   # tail dropped, not fatal
        assert g2.get("b").wal.truncated_bytes == 0
        assert g2.get("b").wal.batch_seqs() == b_seqs
        assert g2.get("b").booster.model_to_string() == want_b
        # both models keep feeding after the recovery
        _feed_group_stream(g2, "a", seed=90, n=1)
        _feed_group_stream(g2, "b", seed=91, n=1)
        g2.flush()
        assert g2.get("a").wal.committed_seq == g2.get("a").wal.last_seq
    finally:
        g2.close()


def test_group_expired_counts_exact_under_concurrent_feeders(tmp_path):
    """joined + expired + pending == captured, exactly, per model, with
    concurrent capture/label threads racing the expiry sweep."""
    params = _params(tmp_path / "gw", online_refit_rows=100000,
                     online_label_timeout_s=900.0)
    g = _fresh_group(params)
    try:
        errs = []

        def feeder(model, t):
            try:
                rng = np.random.RandomState(t)
                for i in range(25):
                    rid = f"{model}-t{t}-{i}"
                    g.feed_features(rid, rng.rand(N_FEAT), model=model)
                    if i % 2 == 0:   # half the labels arrive...
                        g.feed_label(rid, float(rng.rand()), model=model)
            except Exception as e:   # pragma: no cover
                errs.append(e)

        ths = [threading.Thread(target=feeder, args=(m, t))
               for m in ("a", "b") for t in range(4)]
        [t.start() for t in ths]
        [t.join() for t in ths]
        assert not errs, errs
        # ...the other half expire, via the same sweep the group thread runs
        g.sweep_joins()
        for m in ("a", "b"):
            js = g.join_stats(m)
            assert js["captured"] == 100, js
            assert js["joined"] == 52, js     # 13 even i's x 4 threads
            assert js["joined"] + js["pending"] == 100, js
            assert js["expired"] == 0 and js["unmatched"] == 0, js
        # force the timeout: every orphan expires exactly once
        for tr in g.trainers():
            tr._join.sweep(now=time.time() + 1000.0)
        for m in ("a", "b"):
            js = g.join_stats(m)
            assert js["joined"] + js["expired"] == js["captured"], js
            assert js["expired"] == 48 and js["pending"] == 0, js
    finally:
        g.close()


# ---- WAL disk-full degrade mode ----

_REAL_FSYNC = os.fsync


def _enospc_for_wal(fd):
    """ENOSPC only for the feed WAL's own file: model artifacts and flight
    dumps (same shared ``os`` module) must keep writing — the degrade drill
    is about the log filling its volume, not the whole machine dying."""
    try:
        target = os.readlink(f"/proc/self/fd/{fd}")
    except OSError:
        target = ""
    if target.endswith("feed.wal"):
        raise OSError(errno.ENOSPC, "No space left on device")
    return _REAL_FSYNC(fd)


def test_wal_disk_full_degrades_and_rearms(tmp_path, monkeypatch):
    obs.configure(enabled=True)
    flight_dir = tmp_path / "flight"
    flight_dir.mkdir()
    monkeypatch.setattr(obs.flight, "_TRIP_DEBOUNCE_S", 0.0)
    obs.flight.FLIGHT.configure(out_dir=str(flight_dir))
    fl = FeedLog(str(tmp_path / "w"), full_mode="degrade")
    X = np.ones((3, N_FEAT))
    assert fl.append_batch(X, X[:, 0], batch_id="ok1") == 1
    monkeypatch.setattr(wal_module.os, "fsync", _enospc_for_wal)
    with pytest.raises(WalUnavailable):
        fl.append_batch(X, X[:, 0], batch_id="lost1")
    assert fl.degraded and fl.degrade_count == 1
    with pytest.raises(WalUnavailable):
        fl.append_batch(X, X[:, 0], batch_id="lost2")
    assert fl.skipped_appends == 2
    ev = _last_event("wal_degraded")
    assert ev and ev["recovered"] is False and "No space" in ev["error"]
    # the trip dumped the flight recorder
    assert glob.glob(str(flight_dir / "flight_*wal_degraded*"))
    # space returns: the next append is the re-arm probe
    monkeypatch.setattr(wal_module.os, "fsync", _REAL_FSYNC)
    assert fl.append_batch(X, X[:, 0], batch_id="ok2") == 2
    assert not fl.degraded
    ev = _last_event("wal_degraded")
    assert ev and ev["recovered"] is True and ev["skipped"] == 2
    fl.close()
    # restart: the log scans clean — no torn frames from the failed writes
    fl2 = FeedLog(str(tmp_path / "w"))
    assert fl2.truncated_bytes == 0
    assert fl2.seen("ok1") and fl2.seen("ok2")
    assert not fl2.seen("lost1") and not fl2.seen("lost2")
    fl2.close()


def test_wal_disk_full_fatal_mode_propagates(tmp_path, monkeypatch):
    fl = FeedLog(str(tmp_path / "w"), full_mode="fatal")
    monkeypatch.setattr(wal_module.os, "fsync", _enospc_for_wal)
    X = np.ones((2, N_FEAT))
    with pytest.raises(OSError) as ei:
        fl.append_batch(X, X[:, 0], batch_id="b1")
    assert ei.value.errno == errno.ENOSPC
    fl.close()


def test_trainer_keeps_training_through_degraded_wal(tmp_path, monkeypatch):
    """online_wal_full=degrade: a full disk downgrades to buffered-only
    continuous training — feeds keep landing, cycles keep publishing —
    instead of failing the serve path."""
    obs.configure(enabled=True)
    params = _params(tmp_path / "w", online_wal_full="degrade",
                     telemetry=True, online_refit_rows=50)
    tr = _fresh_trainer(params)
    try:
        rng = np.random.RandomState(31)
        X1 = rng.rand(10, N_FEAT)
        tr.feed(X1, X1[:, 0], batch_id="pre")
        monkeypatch.setattr(wal_module.os, "fsync", _enospc_for_wal)
        for i in range(2):
            X = rng.rand(10, N_FEAT)
            tr.feed(X, X[:, 0], batch_id=f"deg{i}")   # buffered, not logged
        assert tr.wal.degraded and tr.wal_skipped == 2
        assert tr.pending_rows == 30
        monkeypatch.setattr(wal_module.os, "fsync", _REAL_FSYNC)
        # the cycle still publishes from the buffer (trigger already armed)
        X = rng.rand(10, N_FEAT)
        tr.feed(X, X[:, 0], batch_id="post")
        tr.flush()
        assert tr.cycles >= 1 and tr.version >= 1
        assert tr.dataset.num_data == 160   # 120 base + all 40 fed rows
        # degraded-mode batch ids still deduplicate (in-memory fallback)
        tr.feed(X1, X1[:, 0], batch_id="deg0")
        assert tr.pending_rows == 0
        st = tr.statusz()
        assert st["wal_skipped"] == 2
        assert st["wal"]["degrade_count"] == 1
    finally:
        tr.close()


# ---- serve protocol: capture-at-ingress + !label + drift tap ----

def test_serve_protocol_capture_label_and_stats(tmp_path):
    from lightgbm_tpu_torch.server import PredictServer, handle_line
    X, y = _make_data()
    params = _params(tmp_path / "w", online_refit_rows=1000)
    ds = Dataset(X, label=y, params=params)
    bst = lt.train({"objective": "regression", "num_leaves": 7,
                    "verbose": -1, "min_data_in_leaf": 5, **CPU}, ds,
                   num_boost_round=3)
    srv = PredictServer(params, model=bst)
    tr = OnlineTrainer(params, ds, booster=bst, server=srv)
    srv.attach_online(tr)
    try:
        # "<rid>|<features>" captures at ingress, then predicts
        line = "req1|" + ",".join("%.6f" % v for v in X[0])
        reply = handle_line(srv, line)
        assert reply.startswith("1\t")
        assert tr.join_stats()["pending"] == 1
        # the late label joins
        reply = handle_line(srv, "!label req1 0.75")
        assert reply == "ok pending=0 joined=1"
        assert tr.pending_rows == 1
        # unmatched label: counted, reply still well-formed
        reply = handle_line(srv, "!label ghost 1.0")
        assert reply == "ok pending=0 joined=1"
        assert tr.join_stats()["unmatched"] == 1
        assert handle_line(srv, "!label req1") \
            == "error: !label needs <request-id> <label>"
        # join stats ride the server's stats surface (!stats parity)
        st = srv.stats()
        assert st["online"]["join"]["joined"] == 1
    finally:
        tr.close()
        srv.close()


def test_serve_protocol_capture_without_trainer_errors():
    from lightgbm_tpu_torch.server import PredictServer, handle_line
    X, y = _make_data()
    ds = Dataset(X, label=y, params=CPU)
    bst = lt.train({"objective": "regression", "num_leaves": 7,
                    "verbose": -1, "min_data_in_leaf": 5, **CPU}, ds,
                   num_boost_round=2)
    srv = PredictServer({"verbose": -1, **CPU}, model=bst)
    try:
        line = "req1|" + ",".join("%.6f" % v for v in X[0])
        assert "error" in handle_line(srv, line)
        assert "error" in handle_line(srv, "!label req1 1.0")
        # plain predict lines still serve
        plain = ",".join("%.6f" % v for v in X[0])
        assert handle_line(srv, plain).startswith("1\t")
    finally:
        srv.close()


def test_capi_capture_label_return_contract(tmp_path):
    """online_label distinguishes buffered join (0) / published version (>0)
    / unmatched (-1); online_capture ignores a duplicate rid (counted)."""
    from lightgbm_tpu_torch import capi_impl
    X, y = _make_data()
    params = _params(tmp_path / "w", online_refit_rows=1000)
    ds = Dataset(X, label=y, params=params)
    bst = lt.train({"objective": "regression", "num_leaves": 7,
                    "verbose": -1, "min_data_in_leaf": 5, **CPU}, ds,
                   num_boost_round=2)
    tr = OnlineTrainer(params, ds, booster=bst)
    try:
        row = np.ascontiguousarray(X[0], dtype=np.float64)
        addr = row.ctypes.data
        assert capi_impl.online_capture(tr, "c1", addr, 1, X.shape[1]) == 1
        # duplicate rid: counted and ignored, first capture wins
        assert capi_impl.online_capture(tr, "c1", addr, 1, X.shape[1]) == 1
        assert capi_impl.online_label(tr, "c1", 1.0, 0.0) == 0   # buffered
        assert capi_impl.online_label(tr, "ghost", 1.0, 0.0) == -1
        st = json.loads(capi_impl.online_join_stats_json(tr))
        assert st["joined"] == 1 and st["unmatched"] == 1
        assert st["duplicates"] == 1
    finally:
        tr.close()


# ---- the C API's continuous-learning entries from a pure-C host ----

def _capi_so():
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no g++/gcc to build the C ABI and its C host")
    if not os.path.exists(os.path.join(sysconfig.get_path("include"),
                                       "Python.h")):
        pytest.skip("no Python.h to build the C ABI against")
    from lightgbm_tpu_torch.native.build_capi import build_capi
    path = build_capi()
    assert path is not None, "the C ABI did not build"
    return path


def online_host_mirror(model_file, bx, by, fx, fy, params):
    """scripts/torch_online_host.c's calls through the Python API: the
    first quarter of the feed appended, the second fed in 50-row batches,
    the rest captured one row at a time and labeled, then a flush."""
    q = len(fy) // 4
    ds = lt.Dataset(bx, label=by, params=params)
    ds.append(fx[:q], label=fy[:q])
    tr = OnlineTrainer(params, ds,
                       booster=lt.Booster(model_file=model_file,
                                          params=params))
    for i in range(q, 2 * q, 50):
        tr.feed(fx[i:min(i + 50, 2 * q)], fy[i:min(i + 50, 2 * q)])
    for i in range(2 * q, len(fy)):
        tr.feed_features(f"r{i}", fx[i:i + 1])
    for i in range(2 * q, len(fy)):
        tr.feed_label(f"r{i}", float(fy[i]))
    tr.feed_label("ghost", 1.0)
    js = tr.join_stats()
    tr.flush()
    tr.close()
    return tr, js


def test_c_host_online_entries_match_python_api(tmp_path):
    """A pure-C host (gcc) through LGBMTPU_DatasetAppend and the
    LGBMTPU_Online* entries ends with the model the same calls through the
    Python API publish, byte for byte, with the same join counters."""
    so = _capi_so()
    rng = np.random.RandomState(8)
    bx, fx = rng.rand(300, N_FEAT), rng.rand(200, N_FEAT)
    by, fy = bx[:, 0] + 0.5 * bx[:, 1], fx[:, 0] + 0.5 * fx[:, 1]
    p = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
         "min_data_in_leaf": 5, **CPU}
    b1 = lt.train(p, lt.Dataset(bx, label=by, params=p), 3)
    model = str(tmp_path / "b1.txt")
    b1.save_model(model)
    for name, a in (("bx", bx), ("by", by), ("fx", fx), ("fy", fy)):
        np.ascontiguousarray(a, dtype=np.float64).tofile(
            str(tmp_path / f"{name}.bin"))
    online = {**p, "online_refit_rows": 60, "online_boost_rounds": 2,
              "online_wal": True}
    pstr = " ".join(f"{k}={v}" for k, v in online.items()) + \
        f" online_wal_dir={tmp_path / 'cwal'}"
    host = str(tmp_path / "online_host")
    subprocess.run(["gcc", os.path.join(REPO, "scripts",
                                        "torch_online_host.c"), so, "-o",
                    host, f"-Wl,-rpath,{os.path.dirname(so)}"], check=True,
                   capture_output=True, timeout=120)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO] + [q for q in sys.path
                                                    if q]))
    r = subprocess.run([host, model, *(str(tmp_path / f"{n}.bin")
                                       for n in ("bx", "by")), "300",
                        str(N_FEAT), *(str(tmp_path / f"{n}.bin")
                                       for n in ("fx", "fy")), "200", pstr],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout.splitlines()
    assert out[0] == "appended 50 rows: 350"
    assert "joined 100, ghost -1" in out[-3]
    js_c = json.loads(out[-2])
    tr, js = online_host_mirror(
        model, bx, by, fx, fy,
        {**online, "online_wal_dir": str(tmp_path / "pwal")})
    for k in ("captured", "joined", "unmatched", "pending", "duplicates"):
        assert js_c[k] == js[k], k
    assert (js["captured"], js["joined"], js["unmatched"]) == (100, 100, 1)
    assert out[-1] == f"flush: version {tr.version}"
    arts = glob.glob(str(tmp_path / "cwal" / "model_*.txt"))
    assert len(arts) == 1
    assert open(arts[0]).read() == tr.booster.model_to_string()
    assert tr.dataset.num_data == 500 and tr.cycles >= 2
