"""Continuous training: append-only Dataset growth -> streaming refit ->
zero-downtime hot-swap publish.

Port of ``lightgbm_tpu/online.py`` (host code; the device work is
``Dataset.append``'s binning on the card and the cycle's ``train`` or
``refit``). Beside the reference's fields, :func:`last_cycle_stats` splits
a cycle's seconds into ``append_s``, ``train_s``, ``merge_s`` and
``publish_s`` (the card synchronized at each boundary).

The reference ships the pieces separately — ``task=refit`` re-fits leaf
outputs (GBDT::RefitTree, gbdt.cpp:299) and continued training warm-starts
from an init model (boosting.h CreateBoosting + the python package's
``train(init_model=...)``) — but nothing closes the loop against live
traffic. This module is that loop:

1. rows arrive in batches (a callable, an iterator, a tailed CSV file, or
   the serve protocol's ``!learn`` lines) and buffer in
   :class:`OnlineTrainer`; with ``online_wal=1`` every batch is first made
   durable in a write-ahead feed log (:mod:`.wal`) so a crash at any point
   between feed and publish loses nothing and double-trains nothing;
2. a trigger fires — pending rows reached ``online_refit_rows``, the live
   model's eval metric drifted by more than ``online_drift_metric_delta``
   against the baseline recorded at the previous (re)fit, or an explicit
   :meth:`OnlineTrainer.flush` — and the pending rows stream into the
   training Dataset through :meth:`Dataset.append` (frozen bin boundaries +
   EFB plan, the chunked 3-stage ingest pipeline binning on the card;
   ``online_max_rows`` bounds the dataset as a FIFO sliding window);
3. the model updates — ``online_boost_rounds > 0`` continues boosting from
   the current model (``train(init_model=...)``; the delta trees are merged
   back into one servable model by :func:`merge_boosters`), else the leaf
   outputs of the existing tree structures are refit on the fresh rows
   (``Booster.refit``);
4. the new version publishes into the serving :class:`~.server.ModelRegistry`
   (engine built + warmed off the hot path, atomic pointer swap), so
   in-flight predict requests finish on their version and new ones see the
   refit model with zero dropped requests.

Thread-safety: ``feed``/``flush`` may be called from any thread (the serve
TCP handler threads do). Three locks split the trainer: ``_lock`` guards
the cheap mutable state (pend buffers, booster pointer, version/cycle
counters, drift baseline) and is only ever held briefly; ``_feed_lock``
makes WAL sequence assignment + buffering one atomic step, so a cycle
snapshot can never commit a sequence whose rows another feeder has not
buffered yet (the exactly-once invariant: every commit covers exactly the
batches at or below its sequence); ``_cycle_lock`` serializes refit cycles
end-to-end. ``feed`` never takes ``_cycle_lock``, so with
``online_async_refit=1`` feeding never blocks on training: triggers hand off
through a bounded queue to a dedicated worker thread (a full queue safely
coalesces — any queued cycle snapshots ALL pending rows). A failed cycle
keeps serving the last-good model, emits ``online_cycle_failed`` (which
trips the flight recorder), and retries with exponential backoff; the
feed->publish lag is watched against ``online_freshness_slo_s`` by
``obs.slo.FRESHNESS``. The module-level cycle stats mirror
``ingest.LAST_INGEST_STATS`` and take their own lock.

Three label-resilience layers ride on the loop:

- **delayed-label joins** (:mod:`.join`): :meth:`OnlineTrainer.feed_features`
  captures served features by request id (WAL-durable), a later
  :meth:`~OnlineTrainer.feed_label` joins the label against them, and only
  the *joined* rows enter the training buffer via the normal ``feed()``
  path — orphans expire into counted ``join_expired`` events, never
  silently;
- **unlabeled drift detection**: :meth:`~OnlineTrainer.observe_served`
  streams served prediction distributions through the fleet PSI/KS
  comparator against an at-last-fit baseline; past
  ``online_drift_psi_max`` a refit cycle is dispatched (or, in
  ``online_drift_mode=alarm`` — and always when no labeled rows pend — a
  ``drift_unlabeled`` trip fires and the last-good model keeps serving);
- **per-model trainers**: :class:`OnlineTrainerGroup` runs N independent
  feed->refit->publish loops against one server (per-model WAL dirs,
  per-model freshness gauges, one shared join-expiry sweep thread) with
  failure isolation — one model's cycle failure or WAL corruption never
  blocks or corrupts another's.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from . import log, obs
from .basic import Booster, Dataset
from .config import canonical_name, params_to_config
from .fleet.drift import CANDIDATE, INCUMBENT, StreamingComparator
from .join import JoinBuffer
from .log import LightGBMError
from .metrics import create_metrics, default_metric_for_objective
from .utils import faults
from .wal import FeedLog, WalUnavailable

# last completed refit cycle (bench + test introspection); written under
# _STATS_LOCK only — trainer threads and bench readers race otherwise
_STATS_LOCK = threading.Lock()
LAST_CYCLE_STATS: Dict[str, Any] = {}

# sentinel a callable source returns to end the run loop (None means
# "nothing right now, poll again")
STOP = object()


def last_cycle_stats() -> Dict[str, Any]:
    with _STATS_LOCK:
        return dict(LAST_CYCLE_STATS)


def _sync(device) -> None:
    """Wait for the card's queued work (a no-op off the card), so that a
    phase's host seconds include its device time."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def merge_boosters(init_model: Booster, delta: Booster) -> Booster:
    """One servable Booster holding ``init_model``'s trees followed by
    ``delta``'s.

    ``train(init_model=...)`` returns only the delta trees — the init
    model's contribution is baked into the warm-start scores, so the delta
    alone underpredicts (see tests/test_engine.py::test_continued_training:
    full prediction = init + delta). Serving needs a single artifact, so the
    merge round-trips the init model through its text form (thresholds and
    leaf values print at %.17g — exact f64 round-trip, io/model_text.py) and
    appends the delta's host trees. The init model's first-tree bias folding
    is already in its serialized leaf values; the warm-started delta skipped
    ``boost_from_average``, so plain tree-sum prediction of the merged model
    equals ``init.predict(x) + delta.predict(x)`` bit-for-bit."""
    k = init_model.num_model_per_iteration()
    params = dict(init_model.params)
    if k > 1:
        # dump_model_text reads num_class off the live config, which a
        # model_str-constructed Booster would otherwise default to 1
        params["num_class"] = k
    merged = Booster(params=params,
                     model_str=init_model.model_to_string(num_iteration=-1))
    merged.trees = list(merged.trees) + list(delta._host_trees())
    return merged


def tail_source(path: str, stop: Optional[threading.Event] = None,
                poll_s: float = 0.2, follow: bool = True,
                from_start: bool = True, with_ids: bool = False):
    """Generator over batches appended to a text file of label-first rows
    (``<label>,<v1>,<v2>,...``, comma or whitespace separated — the CLI
    ``label_index=0`` convention).

    A writer appends incrementally, so a read can end mid-line; the
    incomplete tail is buffered here until its newline arrives — a partial
    row is never parsed (and never half-fed). Rotation and truncation are
    detected when caught up (the path's inode differs from the open handle's,
    or the file shrank below the read position) and the file is reopened
    from the start.

    ``with_ids=False`` (default) yields ``(X, y)`` with all complete rows
    read this poll batched together. ``with_ids=True`` yields one row per
    batch as ``(X, y, None, batch_id)`` where the id is derived from the
    file's identity, a signature of its leading bytes, and the row's byte
    offset — stable across restarts and independent of read chunking, so a
    restarted producer re-feeding from the start is deduplicated by the
    trainer's WAL (exactly-once end to end). The content signature is what
    keeps truncation honest: a copytruncate-style rotation reuses the
    inode AND the old byte offsets, so identity+offset alone would make
    ``wal.seen()`` silently drop every row of the rewritten file as a
    duplicate — the rewritten content re-keys the ids instead. Offsets
    assume the ASCII feeds the CLI convention produces.

    Yields ``None`` when caught up with the file (the consumer's run loop
    does the bounded waiting — this generator never sleeps), and returns
    when ``follow=False`` and the end of the file is reached (a final
    unterminated line is flushed as end-of-stream), or when ``stop`` is
    set."""
    stop_ev = stop if stop is not None else threading.Event()

    def _parse(ln: str):
        ln = ln.split("#", 1)[0].strip()
        if not ln:
            return None
        return [float(t) for t in ln.replace(",", " ").split()]

    def _one(row, start: int, ino: int, sig: str):
        arr = np.asarray([row], dtype=np.float64)
        bid = f"{os.path.basename(path)}:{ino}:{sig}:{start}"
        return arr[:, 1:], arr[:, 0], None, bid

    def _filesig(f) -> str:
        # signature of the file's first bytes: pure function of current
        # content, so it is stable across tailer restarts but re-keys ids
        # when a truncated file (same inode, same offsets) is rewritten
        pos = f.tell()
        f.seek(0)
        head = f.read(64)
        f.seek(pos)
        return format(zlib.crc32(head.encode("utf-8", "replace"))
                      & 0xFFFFFFFF, "08x")

    fh = open(path, "r")
    try:
        ino = os.fstat(fh.fileno()).st_ino
        sig = None  # computed lazily, once content exists this generation
        if not from_start:
            fh.seek(0, 2)
        buf = ""
        off = fh.tell()  # offset of the first unconsumed char (id anchor)
        while not stop_ev.is_set():
            chunk = fh.read()
            if chunk:
                buf += chunk
                lines = buf.split("\n")
                buf = lines.pop()  # incomplete tail: carry to the next read
                if with_ids:
                    for ln in lines:
                        start = off
                        off += len(ln) + 1
                        row = _parse(ln)
                        if row is not None:
                            if sig is None:
                                sig = _filesig(fh)
                            yield _one(row, start, ino, sig)
                else:
                    rows = []
                    for ln in lines:
                        off += len(ln) + 1
                        row = _parse(ln)
                        if row is not None:
                            rows.append(row)
                    if rows:
                        arr = np.asarray(rows, dtype=np.float64)
                        yield arr[:, 1:], arr[:, 0]
                continue
            # caught up — before idling, check whether the file was rotated
            # (path now names a different inode) or truncated (shrank below
            # our read position): either way, reopen and restart from 0
            try:
                st = os.stat(path)
            except OSError:
                st = None
            if st is not None and (st.st_ino != ino or
                                   st.st_size < fh.tell()):
                fh.close()
                fh = open(path, "r")
                ino = os.fstat(fh.fileno()).st_ino
                sig = None  # new generation: ids re-key on the new content
                buf = ""
                off = 0
                continue
            if not follow:
                if buf:  # end-of-stream flushes a final unterminated line
                    row = _parse(buf)
                    if row is not None:
                        if with_ids:
                            if sig is None:
                                sig = _filesig(fh)
                            yield _one(row, off, ino, sig)
                        else:
                            arr = np.asarray([row], dtype=np.float64)
                            yield arr[:, 1:], arr[:, 0]
                return
            yield None
    finally:
        fh.close()


class OnlineTrainer:
    """The continuous-training loop: buffer -> trigger -> append -> refit ->
    publish.

    >>> trainer = OnlineTrainer(params, dataset, booster=bst, server=srv)
    >>> trainer.feed(X_batch, y_batch)        # buffers; may trigger a cycle
    >>> trainer.flush()                       # force one cycle now
    >>> trainer.run(tail_source("feed.csv"))  # or drive from a source

    ``params`` knobs (config.py):
      online_refit_rows         trigger a cycle once this many rows pend
      online_drift_metric_delta >0: also trigger when the live model's first
                                configured metric worsens by more than this
                                on an incoming batch vs the baseline taken
                                at the previous (re)fit
      online_boost_rounds       >0: continue boosting this many rounds per
                                cycle (mode "boost"); 0: leaf-output refit
                                of the existing structures (mode "refit")
      online_wal                1: write-ahead-log every feed batch and
                                replay unacknowledged ones on restart
                                (exactly-once; see :mod:`.wal`)
      online_wal_dir            where the log + model artifacts live
                                (default: <dir of output_model>/online_wal)
      online_max_rows           >0: FIFO sliding-window cap on the dataset
      online_async_refit        1: cycles run on a dedicated worker thread
                                behind a bounded queue — feed() never blocks
                                on training
      online_freshness_slo_s    >0: watch feed->publish lag against this SLO

    When ``booster`` is None an initial model is trained on ``dataset``
    (``num_iterations`` rounds). When a server/registry is given, the
    initial model is published only if the name has no current version —
    ``PredictServer(model=...)`` already published it as v1 (a WAL-recovered
    committed model supersedes both and republishes).

    Call :meth:`close` when done: it stops the async worker, deregisters
    the freshness collector and closes the WAL.
    """

    # retry pacing for failed async cycles: base * 2^(attempt-1), capped.
    # Class attributes so chaos tests can shrink the wait without waiting
    # wall-clock minutes for the third attempt.
    RETRY_BACKOFF_S = 0.05
    RETRY_BACKOFF_MAX_S = 30.0
    QUEUE_DEPTH = 4

    def __init__(self, params: Optional[Dict] = None,
                 dataset: Optional[Dataset] = None,
                 booster: Optional[Booster] = None,
                 server=None, registry=None, name: str = "default"):
        if dataset is None:
            log.fatal("OnlineTrainer needs the growing training Dataset")
        self.params = dict(params or {})
        self.conf = params_to_config(self.params)
        self.dataset = dataset
        self.server = server
        self.registry = registry if registry is not None else \
            (server.registry if server is not None else None)
        self.name = name
        self._lock = threading.RLock()
        # serializes WAL seq assignment + buffering (one atomic step: see
        # feed()); never held across a training cycle
        self._feed_lock = threading.Lock()
        self._pend_x: List[np.ndarray] = []
        self._pend_y: List[np.ndarray] = []
        self._pend_w: List[np.ndarray] = []
        self._baseline: Optional[float] = None
        self.pending_rows = 0
        self.cycles = 0
        self.version = 0
        # cycle machinery: _cycle_lock serializes refit cycles end-to-end
        # (never held by feed); _inflight is the snapshot of a cycle that
        # failed mid-flight — a retry must finish IT, not re-snapshot, or
        # already-appended rows would train twice
        self._cycle_lock = threading.RLock()
        self._inflight: Optional[Dict[str, Any]] = None
        self._pend_seq_hi = 0
        self._pend_oldest_ts: Optional[float] = None
        self.failures = 0
        self.coalesced = 0
        self.last_error = ""
        self.recovery: Dict[str, Any] = {}
        # ids fed while the WAL was degraded (disk full): not in the log,
        # so in-process dedup of producer re-sends falls back to this set
        self._unlogged_ids: set = set()
        self.wal_skipped = 0
        # unlabeled drift detection (online_drift_psi_max > 0): served
        # prediction distribution vs the at-last-fit baseline snapshot
        self._drift_cmp: Optional[StreamingComparator] = \
            StreamingComparator(window=self.conf.canary_cmp_window) \
            if self.conf.online_drift_psi_max > 0 else None
        self._drift_fired = False
        self._drift_baseline_ts: Optional[float] = None
        self._drift_since_eval = 0
        self.drift_trips = 0
        mnames = self.conf.metric or \
            [default_metric_for_objective(self.conf.objective)]
        ms = create_metrics(mnames[:1], self.conf)
        # group metrics (ndcg/map) need query boundaries feed() doesn't
        # carry; drift watching is for the pointwise metric families
        self._metric = ms[0] if ms and ms[0].eval_at is None else None
        # WAL first: a committed model artifact supersedes both the caller's
        # booster and a fresh initial train — it IS the durable incumbent
        self.wal: Optional[FeedLog] = None
        recovered: Optional[Booster] = None
        if self.conf.online_wal:
            wal_dir = self.conf.online_wal_dir or os.path.join(
                os.path.dirname(self.conf.output_model) or ".", "online_wal")
            # keep_rows = the sliding window: with online_max_rows set the
            # log rotates committed records the rebuilt dataset can never
            # contain, bounding disk and recovery time
            self.wal = FeedLog(wal_dir,
                               keep_rows=self.conf.online_max_rows or 0,
                               full_mode=self.conf.online_wal_full)
            lc = self.wal.last_commit
            if lc and lc.get("model"):
                mpath = os.path.join(self.wal.dir, str(lc["model"]))
                if os.path.exists(mpath):
                    recovered = Booster(params=self.params, model_file=mpath)
                else:
                    log.warning(
                        f"feed WAL commit names a missing model artifact "
                        f"{mpath}; recovering rows only, starting from the "
                        f"provided/trained initial model")
        if recovered is not None:
            booster = recovered
        elif booster is None:
            from .engine import train as _train
            booster = _train(self._train_params(), dataset,
                             num_boost_round=self.conf.num_iterations)
        self.booster = booster
        if self.registry is not None:
            try:
                self.version = self.registry.current(self.name).version
                if recovered is not None:
                    # something (PredictServer(model=...)) already published
                    # a stale initial model; the committed artifact is the
                    # incumbent, not a canary candidate — publish it direct
                    self.version = self._publish_direct(booster)
            except KeyError:
                self.version = self._publish(booster)
        if self.conf.online_freshness_slo_s > 0:
            obs.slo.FRESHNESS.configure(
                slo_s=self.conf.online_freshness_slo_s)
            self._collector_name = f"online_freshness:{self.name}"
            obs.add_collector(self._collector_name,
                              self._freshness_collector)
        else:
            self._collector_name = ""
        self._async = bool(self.conf.online_async_refit)
        self._stop = threading.Event()
        self._queue: Optional[queue.Queue] = \
            queue.Queue(maxsize=self.QUEUE_DEPTH) if self._async else None
        self._worker: Optional[threading.Thread] = None
        if self._async:
            self._worker = threading.Thread(
                target=self._worker_loop,
                name=f"lgbm-online-refit-{self.name}", daemon=True)
            self._worker.start()
        if self.wal is not None:
            self._recover(had_commit=recovered is not None)
        # delayed-label join buffer: built after WAL recovery so rebuild()
        # resurrects the pending features a crash left behind
        self._join = JoinBuffer(self._feed_joined, wal=self.wal,
                                timeout_s=self.conf.online_label_timeout_s,
                                max_pending=self.conf.online_join_max_pending,
                                name=self.name)
        if self.wal is not None:
            self._join.rebuild()

    # ---- internals ----
    def _train_params(self) -> Dict:
        """Params with iteration-count aliases stripped: engine.train honors
        an explicit params entry over the num_boost_round keyword (the
        was-set check), and the per-cycle round count is ours to pass."""
        return {k: v for k, v in self.params.items()
                if canonical_name(str(k)) != "num_iterations"}

    def _publish_direct(self, booster: Booster) -> int:
        if self.server is not None:
            return int(self.server.publish(booster, name=self.name))
        if self.registry is not None:
            return int(self.registry.publish(self.name, booster).version)
        return self.version + 1

    def _publish(self, booster: Booster) -> int:
        if self.server is not None and self.conf.canary_fraction > 0 and \
                self.version > 0 and hasattr(self.server, "ensure_rollout"):
            # with canary_fraction > 0 refit outputs enter through the
            # rollout gate (fleet/rollout.py) instead of hot-swapping into
            # live traffic: the comparator judges them against the incumbent
            # and promotes/rolls back on its own. The very first publish
            # (version 0 — nothing to compare against) goes direct.
            try:
                return int(self.server.ensure_rollout(self.name)
                           .submit_candidate(booster))
            except LightGBMError as e:
                log.warning(f"canary publish unavailable ({e}); "
                            "publishing direct")
        return self._publish_direct(booster)

    def _metric_value(self, X, y, w, booster: Optional[Booster] = None
                      ) -> float:
        bst = booster
        if bst is None:
            with self._lock:
                bst = self.booster
        pred = bst.predict(X, raw_score=not self._metric.use_prob)
        return float(self._metric(
            torch.as_tensor(np.asarray(y, dtype=np.float64)),
            torch.as_tensor(np.asarray(pred, dtype=np.float64)),
            None if w is None else torch.as_tensor(np.asarray(
                w, dtype=np.float64))))

    def _check_drift(self, X, y, w) -> Optional[str]:
        if self._metric is None or self.conf.online_drift_metric_delta <= 0:
            return None
        cur = self._metric_value(X, y, w)
        with self._lock:
            base = self._baseline
            if base is None:
                self._baseline = cur
                return None
        worse = (base - cur) if self._metric.greater_is_better \
            else (cur - base)
        if worse > self.conf.online_drift_metric_delta:
            obs.emit("drift_trigger", metric=self._metric.name,
                     baseline=base, current=cur, delta=float(worse),
                     rows=int(len(y)))
            return "drift"
        return None

    def _freshness_collector(self, reg) -> None:
        """Scrape-time gauge: age of the oldest row still unpublished."""
        with self._lock:
            oldest = self._pend_oldest_ts
        lag = (time.time() - oldest) if oldest else 0.0
        obs.slo.FRESHNESS.note_pending(self.name, lag)

    # ---- crash recovery (WAL replay) ----
    def _recover(self, had_commit: bool) -> None:
        """Rebuild state from the WAL: committed batches re-append their
        rows (their training effect is already baked into the committed
        model artifact — append, never retrain); pending batches replay
        through the normal trigger machinery, which is deterministic, so
        the recovered model is byte-identical to the uninterrupted run's."""
        t0 = time.time()
        # the recovered-model path skipped the initial train (which is what
        # normally constructs the dataset); replay appends need frozen bins
        self.dataset.construct()
        lc = self.wal.last_commit
        committed = self.wal.committed()
        pending = self.wal.pending()
        cap = self.conf.online_max_rows or None
        if lc is None:
            # fresh log: seal the starting model as the seq-0 artifact so a
            # crash before the first cycle commit replays on top of exactly
            # this model
            path = self.wal.model_artifact(0)
            self.booster.save_model(path)
            self.wal.commit(0, int(self.version),
                            model=os.path.basename(path), cycle=0)
            if not pending:
                return
        elif had_commit:
            if lc.get("baseline") is not None:
                self._baseline = float(lc["baseline"])
            self.cycles = int(lc.get("cycle", 0))
            if self.registry is None:
                self.version = int(lc.get("version", self.version))
        rows = 0
        for b in committed:
            self.dataset.append(b.X, label=b.y, weight=b.w, max_rows=cap)
            rows += b.rows
        replayed = 0
        for b in pending:
            self._buffer(b.X, b.y, b.w, seq=b.seq)
            replayed += 1
            rows += b.rows
        # the scan-loaded committed payloads are now re-appended into the
        # dataset; drop them from memory (the disk log keeps them)
        self.wal.release_committed()
        dur = time.time() - t0
        self.recovery = {"committed": len(committed),
                         "replayed": int(replayed), "rows": int(rows),
                         "truncated_bytes": int(self.wal.truncated_bytes),
                         "duration_s": dur}
        obs.emit("wal_recover", committed=len(committed),
                 replayed=int(replayed), rows=int(rows),
                 truncated_bytes=int(self.wal.truncated_bytes),
                 model=str((lc or {}).get("model", "")), duration_s=dur)

    # ---- the public loop surface ----
    def feed(self, data, label, weight=None,
             batch_id: Optional[str] = None,
             join_rid: Optional[str] = None) -> Optional[int]:
        """Buffer one batch; returns the new published version when this
        batch triggered a synchronous refit cycle, else None (always None
        with ``online_async_refit=1`` — the cycle runs on the worker).

        With ``online_wal=1`` the batch is appended to the write-ahead log
        (fsync'd) BEFORE buffering: once feed returns, the batch survives a
        crash. A ``batch_id`` already in the log (a producer re-send after
        its own restart) is dropped — exactly-once is decided by the id.
        ``join_rid`` (set by the join buffer) rides in the WAL record
        header, sealing that pending feature atomically with the append.

        A full disk cannot take the feed thread down when
        ``online_wal_full=degrade``: the failed append degrades the log to
        buffered-only (``wal_degraded`` trip), this batch trains from
        memory without durability, and the next append re-arms the log
        automatically once space returns."""
        X = np.asarray(data, dtype=np.float64)
        if X.ndim == 1:
            X = X[None, :]
        y = np.asarray(label, dtype=np.float64).reshape(-1)
        if X.shape[0] != y.shape[0]:
            log.fatal(f"feed: {X.shape[0]} rows but {y.shape[0]} labels")
        w = None if weight is None else \
            np.asarray(weight, dtype=np.float64).reshape(-1)
        if self.wal is None:
            return self._dispatch(self._buffer_rows(X, y, w, 0), X, y, w)
        # seq assignment and buffering are ONE atomic step under _feed_lock:
        # without it thread B could buffer seq N+1 before thread A buffers
        # seq N, a cycle snapshot taken in that gap would commit through
        # N+1 with N's rows still unbuffered, and recovery after a crash
        # would classify batch N as already trained — silently losing it
        with self._feed_lock:
            if batch_id is not None and (
                    self.wal.seen(batch_id) or
                    str(batch_id) in self._unlogged_ids):
                return None
            try:
                seq = self.wal.append_batch(X, y, w, batch_id=batch_id,
                                            join_rid=join_rid)
            except ValueError:
                return None  # duplicate id raced in from another thread
            except WalUnavailable:
                # degraded log (disk full): train the batch from memory —
                # it is NOT durable, so dedup its id in-process only
                seq = 0
                if batch_id is not None:
                    self._unlogged_ids.add(str(batch_id))
                with self._lock:
                    self.wal_skipped += 1
            trigger = self._buffer_rows(X, y, w, seq)
        return self._dispatch(trigger, X, y, w)

    def _buffer(self, X, y, w, seq: int = 0) -> Optional[int]:
        # recovery replay path (single-threaded, in __init__): buffer and
        # run the same trigger machinery a live feed would
        return self._dispatch(self._buffer_rows(X, y, w, seq), X, y, w)

    def _buffer_rows(self, X, y, w, seq: int) -> Optional[str]:
        """Insert one batch into the pending buffers; returns the row-count
        trigger if this batch crossed ``online_refit_rows``."""
        with self._lock:
            self._pend_x.append(X)
            self._pend_y.append(y)
            if w is not None:
                self._pend_w.append(w)
            self.pending_rows += int(y.shape[0])
            if seq:
                self._pend_seq_hi = max(self._pend_seq_hi, int(seq))
            if self._pend_oldest_ts is None:
                self._pend_oldest_ts = time.time()
            if self.pending_rows >= self.conf.online_refit_rows:
                return "rows"
        return None

    def _dispatch(self, trigger: Optional[str], X, y, w) -> Optional[int]:
        """Run the drift check and fire the triggered cycle (queue handoff
        in async mode, inline otherwise). Outside ``_feed_lock`` — a
        synchronous cycle must never stall the other feeders."""
        if trigger is None:
            trigger = self._check_drift(X, y, w)
        if trigger is not None:
            if self._async:
                self._submit(trigger)
                return None
            return self.refit_now(trigger=trigger)
        return None

    # ---- delayed-label join surface (join.py) ----
    def _feed_joined(self, rid: str, X, y, w) -> Optional[int]:
        """JoinBuffer's feed hook: a joined row trains through the normal
        feed() path under its derived batch id (idempotent re-sends), with
        the rid sealing the pending feature in the same WAL record."""
        return self.feed(X, y, weight=w,
                         batch_id=JoinBuffer.batch_id_for(rid),
                         join_rid=rid)

    def feed_features(self, rid: str, data) -> int:
        """Capture served features under request id ``rid`` (serve-time
        ingress half of the delayed-label join); returns the pending
        count. Durable before return when the WAL is on."""
        return self._join.capture(rid, data)

    def feed_label(self, rid: str, label, weight=None) -> Optional[int]:
        """Join an arriving label against the features captured under
        ``rid``; the completed rows enter the training buffer. Returns
        what feed() returned (a version for a sync-triggered cycle), or
        None for unmatched/duplicate/expired labels — counted in
        :meth:`join_stats`, never silent."""
        return self._join.label(rid, label, weight=weight)

    def sweep_joins(self) -> int:
        """Expire pending joins older than ``online_label_timeout_s`` (the
        trainer group's sweep loop calls this; single trainers sweep
        opportunistically on capture/label)."""
        return self._join.sweep()

    def join_stats(self) -> Dict[str, Any]:
        return self._join.stats()

    # ---- unlabeled drift detection ----
    # evaluate PSI once per this many fresh served scores (the comparator
    # itself is O(window) per evaluation — keep it off the per-request
    # path), and not before either side holds a meaningful sample
    DRIFT_EVAL_EVERY = 64
    DRIFT_MIN_SCORES = 64

    def observe_served(self, scores) -> None:
        """Stream served prediction values into the drift comparator
        (no-op unless ``online_drift_psi_max > 0``). Until the first
        baseline exists the scores seed the incumbent side — the serving
        model IS the last-fit model, so its early distribution is the
        at-last-fit snapshot; each refit re-baselines from the new model
        (:meth:`_rebaseline_drift`)."""
        cmp_ = self._drift_cmp
        if cmp_ is None:
            return
        vals = np.asarray(scores, dtype=np.float64).reshape(-1)
        if vals.size == 0:
            return
        with self._lock:
            seeded = self._drift_baseline_ts is not None
        if not seeded:
            cmp_.observe(INCUMBENT, vals)
            n_ref, _ = cmp_.counts()
            if n_ref >= self.DRIFT_MIN_SCORES:
                with self._lock:
                    self._drift_baseline_ts = time.time()
            return
        cmp_.observe(CANDIDATE, vals)
        with self._lock:
            if self._drift_fired:
                return
            self._drift_since_eval += int(vals.size)
            if self._drift_since_eval < self.DRIFT_EVAL_EVERY:
                return
            self._drift_since_eval = 0
        n_ref, n_cand = cmp_.counts()
        if min(n_ref, n_cand) < self.DRIFT_MIN_SCORES:
            return
        psi = cmp_.psi()
        if psi <= self.conf.online_drift_psi_max:
            return
        with self._lock:
            if self._drift_fired:
                return
            self._drift_fired = True
            self.drift_trips += 1
            pend = int(self.pending_rows)
        # graceful degradation: refit only when there are labeled rows to
        # train on — scarce labels mean alarm + keep serving last-good
        action = "refit" if (self.conf.online_drift_mode == "refit"
                             and pend > 0) else "alarm"
        obs.emit("drift_unlabeled", model=self.name, psi=float(psi),
                 ks=float(cmp_.ks()), samples=int(n_cand), action=action,
                 threshold=float(self.conf.online_drift_psi_max),
                 pending_rows=pend)
        if action == "refit":
            if self._async:
                self._submit("drift_unlabeled")
            else:
                try:
                    self.refit_now(trigger="drift_unlabeled")
                except Exception as e:
                    # recorded + flight-dumped by refit_now already; the
                    # serve request that happened to trip the detector
                    # must not fail because training did
                    log.warning(f"drift-triggered refit failed: {e}")

    def _rebaseline_drift(self, booster: Booster, X) -> None:
        """At-last-fit snapshot: a fresh comparator whose incumbent side is
        the refit model's own score distribution over the rows that closed
        the cycle. Swapping the comparator atomically re-arms the trigger."""
        old = self._drift_cmp
        cmp_ = StreamingComparator(window=old.window, bins=old.bins)
        take = min(int(X.shape[0]), int(old.window))
        cmp_.observe(INCUMBENT, booster.predict(X[-take:]))
        with self._lock:
            self._drift_cmp = cmp_
            self._drift_fired = False
            self._drift_baseline_ts = time.time()
            self._drift_since_eval = 0

    def flush(self) -> Optional[int]:
        """Drain pending rows through refit cycles now (end-of-stream).
        Synchronous even in async mode: serializes against the worker via
        the cycle lock and loops until nothing pends (a failed cycle may
        have left rows buffered behind the retrying in-flight snapshot)."""
        version = self.refit_now(trigger="flush")
        while True:
            with self._lock:
                pend = self.pending_rows
            if not pend:
                return version
            v = self.refit_now(trigger="flush")
            if v is None:
                return version
            version = v

    def refit_now(self, trigger: str = "manual") -> Optional[int]:
        """One full cycle: append pending rows, refit/continue the model,
        publish, commit to the WAL. Returns the published version, or None
        if nothing pended. On failure the last-good model keeps serving,
        the failure is recorded (``online_cycle_failed`` trips the flight
        recorder) and the snapshot is kept for an idempotent retry."""
        with self._cycle_lock:
            cyc = self._snapshot_cycle(trigger)
            if cyc is None:
                return None
            try:
                return self._run_cycle(cyc)
            except Exception as e:
                self._note_failure(cyc, e)
                raise

    def _snapshot_cycle(self, trigger: str) -> Optional[Dict[str, Any]]:
        # under _cycle_lock
        if self._inflight is not None:
            cyc = self._inflight
            cyc["attempt"] += 1
            return cyc
        with self._lock:
            if not self.pending_rows:
                return None
            X = np.concatenate(self._pend_x, axis=0)
            y = np.concatenate(self._pend_y)
            w = np.concatenate(self._pend_w) if self._pend_w else None
            cyc = {"trigger": trigger, "X": X, "y": y, "w": w,
                   "n": int(self.pending_rows),
                   "seq": int(self._pend_seq_hi),
                   "oldest": self._pend_oldest_ts,
                   "attempt": 1, "appended": False}
            self._pend_x, self._pend_y, self._pend_w = [], [], []
            self.pending_rows = 0
            self._pend_oldest_ts = None
            self._inflight = cyc
        return cyc

    def _run_cycle(self, cyc: Dict[str, Any]) -> int:
        # under _cycle_lock
        t0 = time.time()
        X, y, w, n = cyc["X"], cyc["y"], cyc["w"], cyc["n"]
        trigger = cyc["trigger"]
        parts = {"append_s": 0.0, "train_s": 0.0, "merge_s": 0.0}
        tp = time.perf_counter()
        if not cyc["appended"]:
            self.dataset.append(X, label=y, weight=w,
                                max_rows=self.conf.online_max_rows or None)
            cyc["appended"] = True  # a retry must not append twice
            _sync(self.dataset.device)
            parts["append_s"] = time.perf_counter() - tp
        faults.fault_point("online_train")
        with self._lock:
            init = self.booster
        mode = "boost" if self.conf.online_boost_rounds > 0 else "refit"
        tp = time.perf_counter()
        if mode == "boost":
            from .engine import train as _train
            delta = _train(self._train_params(), self.dataset,
                           num_boost_round=self.conf.online_boost_rounds,
                           init_model=init)
            _sync(self.dataset.device)
            parts["train_s"] = time.perf_counter() - tp
            tp = time.perf_counter()
            new_bst = merge_boosters(init, delta)
            parts["merge_s"] = time.perf_counter() - tp
        else:
            new_bst = init.refit(X, y, weight=w)
            _sync(self.dataset.device)
            parts["train_s"] = time.perf_counter() - tp
        faults.fault_point("online_publish")
        model_name = ""
        if self.wal is not None:
            # artifact BEFORE publish+commit, atomically (save_model goes
            # through utils/atomic_io): the commit record may only ever
            # name a fully-written model
            apath = self.wal.model_artifact(cyc["seq"])
            new_bst.save_model(apath)
            model_name = os.path.basename(apath)
        t_pub = time.time()
        version = self._publish(new_bst)
        publish_s = time.time() - t_pub
        with self._lock:
            self.booster = new_bst
            self.version = version
            self.cycles += 1
            # re-baseline on the refit model's own quality over the rows
            # that closed this cycle: drift is measured against "how good
            # was the model when it was last fit", not against history
            if self._metric is not None and \
                    self.conf.online_drift_metric_delta > 0:
                self._baseline = self._metric_value(X, y, w, booster=new_bst)
            baseline = self._baseline
            cycles = self.cycles
        if self.wal is not None:
            self.wal.commit(int(cyc["seq"]), int(version), model=model_name,
                            baseline=baseline, cycle=cycles)
        if self._drift_cmp is not None:
            self._rebaseline_drift(new_bst, X)
        lag_s = (time.time() - cyc["oldest"]) if cyc["oldest"] else 0.0
        obs.slo.FRESHNESS.observe_cycle(self.name, lag_s, rows=int(n))
        duration_s = time.time() - t0
        obs.emit("online_refit", trigger=trigger, rows=int(n),
                 version=int(version), duration_s=duration_s, mode=mode,
                 iteration=int(new_bst.current_iteration),
                 publish_s=publish_s, lag_s=float(lag_s),
                 wal_seq=int(cyc["seq"]), attempt=int(cyc["attempt"]))
        with _STATS_LOCK:
            LAST_CYCLE_STATS.clear()
            LAST_CYCLE_STATS.update({
                "trigger": trigger, "mode": mode, "rows": int(n),
                "total_rows": int(self.dataset.num_data),
                "version": int(version), "duration_s": duration_s,
                "publish_s": publish_s, "lag_s": float(lag_s),
                "wal_seq": int(cyc["seq"]), "attempt": int(cyc["attempt"]),
                **parts})
        self._inflight = None  # under _cycle_lock (refit_now holds it)
        return version

    def _note_failure(self, cyc: Dict[str, Any], err: Exception) -> None:
        with self._lock:
            self.failures += 1
            self.last_error = f"{type(err).__name__}: {err}"
        obs.emit("online_cycle_failed", trigger=str(cyc["trigger"]),
                 attempt=int(cyc["attempt"]),
                 error_class=type(err).__name__,
                 error=str(err), rows=int(cyc["n"]))

    # ---- async worker ----
    def _submit(self, trigger: str, attempt: int = 1) -> None:
        try:
            self._queue.put_nowait((str(trigger), int(attempt)))
        except queue.Full:
            # safe coalescing: any queued cycle snapshots ALL pending rows,
            # so a dropped trigger's rows still train with the next cycle
            with self._lock:
                self.coalesced += 1

    def _worker_loop(self) -> None:
        while True:
            if self._stop.is_set():
                return
            try:
                trigger, attempt = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self.refit_now(trigger=trigger)
            except Exception:
                # recorded + flight-dumped by refit_now already: keep
                # serving last-good, retry after bounded backoff
                delay = min(self.RETRY_BACKOFF_MAX_S,
                            self.RETRY_BACKOFF_S * (2.0 ** (attempt - 1)))
                if self._stop.wait(delay):
                    return
                self._submit(trigger, attempt + 1)

    def close(self) -> None:
        """Stop the async worker, deregister the freshness collector, close
        the WAL. Idempotent; don't feed the trainer afterwards."""
        if self._worker is not None:
            self._stop.set()
            # no timeout: an in-flight cycle (training can exceed any fixed
            # bound) must finish its WAL commit and booster swap before the
            # log handle below closes underneath it — a timed join would
            # strand the worker writing into a closed fd and could publish
            # a version whose commit record never lands
            self._worker.join()
            self._worker = None
        if self._collector_name:
            obs.remove_collector(self._collector_name)
            self._collector_name = ""
        if self.wal is not None:
            self.wal.close()

    def statusz(self) -> Dict[str, Any]:
        """Live trainer state for the ObsServer /statusz endpoint."""
        with self._lock:
            out = {"pending_rows": int(self.pending_rows),
                   "cycles": int(self.cycles),
                   "version": int(self.version),
                   "total_rows": int(self.dataset.num_data),
                   "mode": ("boost" if self.conf.online_boost_rounds > 0
                            else "refit"),
                   "drift_baseline": self._baseline,
                   "async": bool(self._async),
                   "failures": int(self.failures),
                   "coalesced": int(self.coalesced)}
            if self.last_error:
                out["last_error"] = self.last_error
            oldest = self._pend_oldest_ts
        out["pending_lag_s"] = (time.time() - oldest) if oldest else 0.0
        out["join"] = self._join.stats()
        if self._drift_cmp is not None:
            with self._lock:
                bts = self._drift_baseline_ts
                fired = self._drift_fired
                trips = self.drift_trips
            snap = self._drift_cmp.snapshot()
            out["drift"] = {
                "psi_max": float(self.conf.online_drift_psi_max),
                "mode": self.conf.online_drift_mode,
                "baseline_age_s":
                    None if bts is None else round(time.time() - bts, 3),
                "fired": bool(fired), "trips": int(trips), **snap}
        if self.wal_skipped:
            out["wal_skipped"] = int(self.wal_skipped)
        if self._queue is not None:
            out["queued"] = int(self._queue.qsize())
        if self.wal is not None:
            out["wal"] = self.wal.stats()
        if self.recovery:
            out["recovery"] = dict(self.recovery)
        fresh = obs.slo.FRESHNESS.snapshot().get(self.name)
        if fresh:
            out["freshness"] = fresh
        last = last_cycle_stats()
        if last:
            out["last_cycle"] = last
        return out

    def run(self, source, stop: Optional[threading.Event] = None,
            poll_s: float = 0.05, flush_at_end: bool = True) -> int:
        """Consume ``(X, y[, w[, batch_id]])`` batches from ``source`` until
        it ends or ``stop`` is set; returns the number of rows fed.

        ``source`` is an iterable/generator of batches (``tail_source``), or
        a zero-arg callable polled each step. ``None`` from either means
        "nothing right now" — the loop waits ``poll_s`` on the stop event
        (never a bare sleep, so that a stop is seen at once) and polls
        again. A callable ends the loop by returning :data:`STOP`;
        an iterable by exhausting."""
        stop_ev = stop if stop is not None else threading.Event()
        if callable(source) and not hasattr(source, "__iter__"):
            src_fn = source
        else:
            it = iter(source)
            def src_fn():
                return next(it, STOP)
        fed = 0
        while not stop_ev.is_set():
            batch = src_fn()
            if batch is STOP:
                break
            if batch is None:
                stop_ev.wait(poll_s)
                continue
            X, y = batch[0], batch[1]
            w = batch[2] if len(batch) > 2 else None
            bid = batch[3] if len(batch) > 3 else None
            self.feed(X, y, weight=w, batch_id=bid)
            fed += int(np.asarray(y).reshape(-1).shape[0])
        if flush_at_end and self.pending_rows:
            self.flush()
        return fed


class OnlineTrainerGroup:
    """N independent continuous-training loops keyed by model name, behind
    one server.

    >>> group = OnlineTrainerGroup(params, server=srv)
    >>> group.add("clicks", ds_a, booster=bst_a)
    >>> group.add("installs", ds_b, booster=bst_b)
    >>> group.feed(X, y, model="clicks")
    >>> group.feed_label(rid, y, model="installs")

    Isolation is the contract: each trainer owns its Dataset, booster,
    locks, async worker, join buffer, and — per-model subdirectory under
    ``online_wal_dir`` — its WAL, so one model's cycle failure or WAL
    corruption cannot block, corrupt, or delay another's feed/refit/publish
    path. Shared pieces are append-only or already keyed per model: the
    registry publishes under each trainer's name and the freshness tracker
    gauges per model. One daemon thread (``_sweep_loop``) sweeps every
    trainer's join expiry on a fixed cadence with per-trainer exception
    containment.

    The group quacks enough like a single trainer for the serve plumbing —
    ``feed``/``feed_label``/``feed_features``/``observe_served`` take an
    optional ``model=`` and default to the first trainer added, and
    ``statusz``/``pending_rows``/``flush``/``close`` span all models — so
    ``PredictServer.attach_online`` and the ``!learn``/``!label`` line
    protocol work unchanged.
    """

    SWEEP_INTERVAL_S = 0.5

    def __init__(self, params: Optional[Dict] = None, server=None,
                 registry=None):
        self.params = dict(params or {})
        self.conf = params_to_config(self.params)
        self.server = server
        self.registry = registry
        self._lock = threading.Lock()
        self._trainers: Dict[str, OnlineTrainer] = {}
        self._default: Optional[str] = None
        self._stop = threading.Event()
        self._sweeper: Optional[threading.Thread] = None

    # ---- membership ----
    def add(self, name: str, dataset: Dataset,
            booster: Optional[Booster] = None,
            params: Optional[Dict] = None) -> OnlineTrainer:
        """Create and register the trainer for ``name``. Per-model params
        overlay the group's; with the WAL on, each model logs under its own
        ``<online_wal_dir>/<name>`` subdirectory (corruption of one model's
        log is invisible to every other)."""
        name = str(name)
        with self._lock:
            if name in self._trainers:
                raise ValueError(f"online trainer {name!r} already exists")
        p = dict(self.params)
        p.update(params or {})
        conf = params_to_config(p)
        if conf.online_wal:
            base = conf.online_wal_dir or os.path.join(
                os.path.dirname(conf.output_model) or ".", "online_wal")
            p["online_wal_dir"] = os.path.join(base, name)
        tr = OnlineTrainer(p, dataset, booster=booster, server=self.server,
                           registry=self.registry, name=name)
        start_sweeper = False
        with self._lock:
            lost_race = name in self._trainers
            if not lost_race:
                self._trainers[name] = tr
            if not lost_race:
                if self._default is None:
                    self._default = name
                if self._sweeper is None and \
                        tr.conf.online_label_timeout_s > 0:
                    self._sweeper = threading.Thread(
                        target=self._sweep_loop,
                        name="lgbm-online-join-sweep", daemon=True)
                    start_sweeper = True
        if lost_race:   # a concurrent add won the name while we trained
            tr.close()
            raise ValueError(f"online trainer {name!r} already exists")
        if start_sweeper:
            self._sweeper.start()
        return tr

    def get(self, model: Optional[str] = None) -> OnlineTrainer:
        with self._lock:
            name = str(model) if model is not None else self._default
            if name is None or name not in self._trainers:
                raise KeyError(f"no online trainer named {name!r}; have "
                               f"{sorted(self._trainers)}")
            return self._trainers[name]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._trainers)

    def trainers(self) -> List[OnlineTrainer]:
        with self._lock:
            return list(self._trainers.values())

    # ---- single-trainer protocol parity (model= routes; default = first
    # added, so one-model groups behave exactly like a bare trainer) ----
    def feed(self, data, label, weight=None, batch_id: Optional[str] = None,
             model: Optional[str] = None) -> Optional[int]:
        return self.get(model).feed(data, label, weight=weight,
                                    batch_id=batch_id)

    def feed_features(self, rid: str, data,
                      model: Optional[str] = None) -> int:
        return self.get(model).feed_features(rid, data)

    def feed_label(self, rid: str, label, weight=None,
                   model: Optional[str] = None) -> Optional[int]:
        return self.get(model).feed_label(rid, label, weight=weight)

    def observe_served(self, scores, model: Optional[str] = None) -> None:
        self.get(model).observe_served(scores)

    def join_stats(self, model: Optional[str] = None) -> Dict[str, Any]:
        return self.get(model).join_stats()

    @property
    def pending_rows(self) -> int:
        return sum(tr.pending_rows for tr in self.trainers())

    @property
    def version(self) -> int:
        try:
            return self.get().version
        except KeyError:
            return 0

    def flush(self, model: Optional[str] = None) -> Optional[int]:
        if model is not None:
            return self.get(model).flush()
        out = None
        for tr in self.trainers():
            v = tr.flush()
            out = v if v is not None else out
        return out

    def sweep_joins(self) -> int:
        return sum(tr.sweep_joins() for tr in self.trainers())

    def statusz(self) -> Dict[str, Any]:
        return {"models": {tr.name: tr.statusz()
                           for tr in self.trainers()}}

    # ---- join-expiry sweep loop ----
    def _sweep_loop(self) -> None:
        """Walk every trainer's join buffer on a fixed cadence so orphaned
        pending features expire even when no captures/labels arrive. Waits
        on the stop event (never a bare sleep) and contains per-trainer
        failures — one model's broken sweep
        must not stall the others'."""
        while not self._stop.is_set():
            if self._stop.wait(self.SWEEP_INTERVAL_S):
                return
            for tr in self.trainers():
                try:
                    tr.sweep_joins()
                except Exception as e:
                    log.warning(
                        f"join sweep for model {tr.name!r} failed: {e}")

    def close(self) -> None:
        """Stop the sweep loop, then close every trainer. Idempotent."""
        self._stop.set()
        with self._lock:
            sweeper, self._sweeper = self._sweeper, None
        if sweeper is not None:
            sweeper.join()
        for tr in self.trainers():
            tr.close()
