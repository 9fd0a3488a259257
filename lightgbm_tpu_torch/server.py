"""Low-latency online serving: request-coalescing microbatcher + registry.

Port of ``lightgbm_tpu/server.py`` (host code, copied and adapted; the
reference analog is ``LGBM_BoosterPredictForMatSingleRow`` with a pre-built
``FastConfig``, c_api.cpp, which hoists all per-call set-up out of the hot
path). The per-call set-up is hoisted by serving.py's ``PredictEngine``
(tables on the card), but every batch still pays an upload, a walk of
small kernel launches and a read-back. Concurrent requests therefore
enqueue into a bounded staging queue; a scheduler thread drains it and
flushes one coalesced batch through the engine, so k concurrent single-row
requests cost about one walk instead of k:

- **flush policy**: flush when the staged rows fill ``serve_max_batch_rows``
  or when ``serve_batch_window_us`` has elapsed since the first staged
  request, whichever comes first; a lone request on an idle server is
  flushed at once (the n = 1 fast path);
- **bounded queue, bounded latency**: the staging queue holds at most
  ``serve_queue_max`` requests; at overload ``submit`` sheds with
  :class:`ServeOverload` instead of growing an unbounded backlog;
- **reused staging**: per-bucket host feature and pseudo-bin arrays are
  reused across flushes, the router bins into them in place;
- **multi-model registry with atomic hot-swap**: ``publish`` builds and
  warms the new version's engine off the hot path, then swaps the version
  pointer. In-flight flushes hold a refcount on the version serving them,
  so nothing is dropped; the old version's device tables are released when
  its last flush drains (and the work already queued on the card's stream
  finishes before the caching allocator hands their memory out again).
  Every response carries the version that produced it.

The engine's walk is row-independent and the padding rows are dropped
before any sum, so coalesced outputs equal per-request engine calls bit
for bit (tests/test_torch_server.py). A CUDA error in a flush fails that
flush's requests; nothing answers them from another path. An attached
online trainer (``attach_online``, ``online.py``) takes the ``!learn``
rows, the features of a request with a capture id (``<rid>|...``) and its
late ``!label``, and watches the served scores for drift.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from . import log, obs
from .config import Config, params_to_config
from .log import LightGBMError
from .obs import flight, slo, tracing
from .obs import http_server as obs_http
from .obs.metrics import histogram_quantiles
from .serving import PredictEngine, bucket_rows
from .utils import faults

# scheduler idle poll: the ONLY place the scheduler blocks is the staging
# queue, and only ever with a timeout, so close() is seen within this bound
_IDLE_POLL_S = 0.05


class ServeOverload(LightGBMError):
    """Bounded staging queue is full: the request was shed, not queued.
    Clients back off and retry; queue depth (and therefore queueing latency)
    stays bounded instead of growing without limit at overload."""


class _Request:
    """One submitted predict request: rows + options + a completion event.

    When request tracing is on (``serve_trace``) the ingress mints a
    ``trace_id`` that rides the request through the staging queue into the
    flush's span breakdown and the sampled trace exemplars, so a response
    can be correlated with its queue/bin/dispatch/readback timings."""
    __slots__ = ("x", "n", "model", "key", "enq_t", "out", "version",
                 "exc", "trace_id", "on_done", "_done")

    def __init__(self, x: np.ndarray, model: str, raw_score: bool,
                 pred_leaf: bool, on_done=None):
        self.x = x
        self.n = int(x.shape[0])
        self.model = model
        self.key = (bool(raw_score), bool(pred_leaf))
        self.enq_t = time.perf_counter()
        self.out: Optional[np.ndarray] = None
        self.version = -1
        self.exc: Optional[BaseException] = None
        self.trace_id: Optional[str] = None
        # completion tap, set BEFORE enqueue (submit_async param, never
        # attached after submit) so there is no set-after-done race; runs on
        # the scheduler thread inside the flush, i.e. while the serving
        # version still holds its in-flight refcount
        self.on_done = on_done
        self._done = threading.Event()

    def _finish(self, out: np.ndarray, version: int) -> None:
        self.out = out
        self.version = version
        self._done.set()
        self._notify()

    def _fail(self, exc: BaseException) -> None:
        self.exc = exc
        self._done.set()
        self._notify()

    def _notify(self) -> None:
        cb = self.on_done
        if cb is None:
            return
        try:
            cb(self)
        except Exception as e:
            log.warning(f"request on_done callback failed "
                        f"({type(e).__name__}: {e})")

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until served; returns the prediction rows (the serving
        version is in ``self.version``). Raises the flush error on failure."""
        if not self._done.wait(timeout):
            raise TimeoutError("predict request not served within timeout")
        if self.exc is not None:
            raise self.exc
        return self.out


class ServedModel:
    """One published model version: a warmed PredictEngine + refcount.

    The refcount counts in-flight flushes (not queued requests): a flush
    acquires the CURRENT version at flush time and releases it when its
    responses are set. ``retire`` marks the version stale; its device tables
    are freed the moment the refcount drains to zero."""

    def __init__(self, name: str, version: int, engine: PredictEngine):
        self.name = name
        self.version = int(version)
        self.engine = engine
        self.inflight = 0
        self.served_rows = 0
        self.retired = False
        self.retired_t = 0.0
        self.published_t = time.time()   # wall clock: model-age freshness
        # False when the engine was handed to another entry (canary promote
        # re-homes a warmed engine instead of rebuilding): retire-at-drain
        # still runs, but must not free device tables it no longer owns
        self.owns_engine = True


class ModelRegistry:
    """Named, versioned PredictEngines with atomic hot-swap.

    ``publish`` is the ONLY mutation: it builds and warms the new engine
    off-line, then swaps the name -> ServedModel pointer under the registry
    lock. Readers (``acquire``) take the same lock only for the pointer read
    + refcount bump, so a publish never blocks traffic for longer than a
    dict assignment."""

    def __init__(self, device: torch.device):
        self._models: Dict[str, ServedModel] = {}
        self._lock = threading.Lock()
        # every engine of the registry lives on this device (a fleet
        # replica's own)
        self.device = torch.device(device)

    def publish(self, name: str, booster=None, warmup_sizes=(1,),
                pred_leaf_warmup: bool = False,
                engine: Optional[PredictEngine] = None) -> ServedModel:
        """Build + warm an engine for ``booster`` and atomically make it the
        current version of ``name``. Returns the new ServedModel.

        Passing ``engine`` instead of ``booster`` re-homes an already-built,
        already-warmed engine as the next version (canary promote: the
        candidate's engine becomes live with zero rebuild/re-warm — the
        caller must clear ``owns_engine`` on the entry it came from)."""
        t0 = time.perf_counter()
        if engine is None:
            if booster is None:
                raise ValueError("publish needs a booster or an engine")
            trees = booster._host_trees()
            k = max(booster.num_model_per_iteration(), 1)
            engine = PredictEngine(trees, booster.num_feature(), k,
                                   booster.average_output(),
                                   objective=booster._objective_for_predict(),
                                   upload_reason="publish",
                                   device=self.device)
            if warmup_sizes:
                engine.warmup(sizes=warmup_sizes,
                              n_features=booster.num_feature())
                if pred_leaf_warmup:
                    engine.warmup(sizes=warmup_sizes,
                                  n_features=booster.num_feature(),
                                  pred_leaf=True)
        with self._lock:
            old = self._models.get(name)
            version = old.version + 1 if old is not None else 1
            sm = ServedModel(name, version, engine)
            self._models[name] = sm
            if old is not None:
                old.retired = True
                old.retired_t = time.perf_counter()
                free_old = old.inflight == 0
        obs.emit("serve_publish", model=name, version=version,
                 n_trees=int(engine.n_trees),
                 duration_s=time.perf_counter() - t0)
        if obs.enabled():
            obs.METRICS.counter("serve_publishes", "model versions published",
                                model=name).inc()
        if old is not None and free_old:
            self._free(old)
        return sm

    def current(self, name: str = "default") -> ServedModel:
        with self._lock:
            if name not in self._models:
                raise KeyError(f"no model {name!r} published "
                               f"(have: {sorted(self._models)})")
            return self._models[name]

    def acquire(self, name: str) -> ServedModel:
        """Current version of ``name`` with its in-flight refcount bumped.
        Pair with :meth:`release` once the flush's responses are set."""
        with self._lock:
            if name not in self._models:
                raise KeyError(f"no model {name!r} published "
                               f"(have: {sorted(self._models)})")
            sm = self._models[name]
            sm.inflight += 1
            return sm

    def release(self, sm: ServedModel, rows: int = 0) -> None:
        with self._lock:
            sm.inflight -= 1
            sm.served_rows += int(rows)
            free_now = sm.retired and sm.inflight == 0
        if free_now:
            self._free(sm)

    def unpublish(self, name: str) -> None:
        """Retire ``name`` entirely (canary rollback / shadow drop): the
        entry disappears from routing immediately, its device tables are
        freed only when the last in-flight flush on it drains — a rollback
        can never yank an engine out from under a request."""
        with self._lock:
            sm = self._models.pop(name, None)
            if sm is None:
                return
            sm.retired = True
            sm.retired_t = time.perf_counter()
            free_now = sm.inflight == 0
        if free_now:
            self._free(sm)

    def _free(self, sm: ServedModel) -> None:
        """Release a retired version's device tables (after drain)."""
        drain_s = time.perf_counter() - sm.retired_t if sm.retired_t else 0.0
        if sm.owns_engine:
            sm.engine.release()
        obs.emit("serve_retire", model=sm.name, version=sm.version,
                 served_rows=int(sm.served_rows), drain_s=drain_s)

    def models(self) -> Dict[str, Dict]:
        now = time.time()
        with self._lock:
            return {name: {"version": sm.version,
                           "n_trees": int(sm.engine.n_trees),
                           "inflight": sm.inflight,
                           "served_rows": sm.served_rows,
                           "published_t": sm.published_t,
                           "age_s": round(now - sm.published_t, 3)}
                    for name, sm in self._models.items()}


def _split_requests(reqs: List["_Request"],
                    cap: Optional[int]) -> List[List["_Request"]]:
    """Greedy-pack requests into chunks of at most ``cap`` rows (one flush
    group each); a single oversized request stays its own chunk. cap=None
    means no split."""
    if cap is None:
        return [reqs]
    chunks: List[List[_Request]] = []
    cur: List[_Request] = []
    rows = 0
    for r in reqs:
        if cur and rows + r.n > cap:
            chunks.append(cur)
            cur, rows = [], 0
        cur.append(r)
        rows += r.n
    if cur:
        chunks.append(cur)
    return chunks


class MicroBatcher:
    """Request-coalescing scheduler in front of a :class:`ModelRegistry`.

    Client threads call :meth:`submit` / :meth:`submit_async`; one daemon
    scheduler thread drains the bounded staging queue and flushes coalesced
    batches through the engine's power-of-two buckets. All cross-thread
    state is either the queue itself or guarded by ``_stats_lock``.
    """

    def __init__(self, registry: ModelRegistry, batch_window_us: int = 200,
                 queue_max: int = 8192, max_batch_rows: int = 1024,
                 start: bool = True, trace: bool = False,
                 trace_sample: int = 16, flush_interval_us: int = 0,
                 admission=None):
        if queue_max < 1:
            raise ValueError("serve_queue_max must be >= 1")
        if max_batch_rows < 1:
            raise ValueError("serve_max_batch_rows must be >= 1")
        self.registry = registry
        self._window_s = max(int(batch_window_us), 0) * 1e-6
        self._max_rows = int(max_batch_rows)
        self._trace = bool(trace)
        self._trace_sample = max(1, int(trace_sample))
        # flush pacing: minimum time between flush dispatches (0 = off).
        # This is the per-replica capacity model — one scheduler dispatches
        # at most max_batch_rows every flush_interval, so a fleet's capacity
        # scales with its replica count instead of with queue depth
        self._flush_min_s = max(int(flush_interval_us), 0) * 1e-6
        self._next_flush_t = 0.0
        # optional SLO admission controller (fleet.admission): consulted at
        # ingress (shed) and at flush grouping (degraded batch cap)
        self._admission = admission
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=int(queue_max))
        self._stop = threading.Event()
        # host staging reused across flushes: (bucket, F) -> f64 features,
        # (bucket, F) -> i32 pseudo-bins. Only the scheduler thread touches
        # these, so steady-state flushes allocate nothing on the host path.
        self._staging_x: Dict[Tuple[int, int], np.ndarray] = {}
        self._staging_bins: Dict[Tuple[int, int], np.ndarray] = {}
        self.stats = {"requests": 0, "rows": 0, "flushes": 0,
                      "flushed_rows": 0, "shed": 0, "admission_shed": 0,
                      "errors": 0, "max_queue_depth": 0, "fast_path": 0,
                      "paced_flushes": 0, "canary_fallback": 0}
        self._stats_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # ---- client side ----

    def submit_async(self, x, model: str = "default", raw_score: bool = False,
                     pred_leaf: bool = False, on_done=None) -> _Request:
        """Enqueue one request; returns a future-like :class:`_Request`.
        Sheds with :class:`ServeOverload` when the bounded queue is full, or
        earlier when the SLO admission controller says the error budget is
        burning too fast (``on_done`` is invoked on the scheduler thread
        when the request completes, success or failure)."""
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        adm = self._admission
        if adm is not None and adm.decide(model) == "shed":
            with self._stats_lock:
                self.stats["admission_shed"] += 1
            burn = adm.note_shed(model)
            raise ServeOverload(
                f"SLO error budget exhausted for {model!r} "
                f"(burn rate {burn:.2f}); request shed — back off")
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2:
            raise ValueError(f"expected [F] or [n, F] features, got "
                             f"shape {x.shape}")
        if x.shape[0] > self._max_rows:
            raise ValueError(
                f"request of {x.shape[0]} rows exceeds serve_max_batch_rows="
                f"{self._max_rows}; use Booster.predict for bulk batches")
        req = _Request(x, model, raw_score, pred_leaf, on_done=on_done)
        if self._trace:
            req.trace_id = tracing.mint_trace_id()
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self.stats["shed"] += 1
            obs.emit("serve_shed", queued=self._q.qsize(),
                     limit=self._q.maxsize, model=model)
            if obs.enabled():
                obs.METRICS.counter("serve_shed_total",
                                    "requests shed at overload",
                                    model=model).inc()
            raise ServeOverload(
                f"serving queue full ({self._q.maxsize} requests); "
                "request shed — retry with backoff")
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["rows"] += req.n
            depth = self._q.qsize()
            if depth > self.stats["max_queue_depth"]:
                self.stats["max_queue_depth"] = depth
        return req

    def submit(self, x, model: str = "default", raw_score: bool = False,
               pred_leaf: bool = False,
               timeout: Optional[float] = None) -> np.ndarray:
        """Blocking submit: returns prediction rows once the coalesced flush
        that served this request completes."""
        return self.submit_async(x, model=model, raw_score=raw_score,
                                 pred_leaf=pred_leaf).result(timeout)

    # ---- scheduler side ----

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        name="lgbm-serve-scheduler",
                                        daemon=True)
        self._thread.start()

    def close(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop the scheduler. With ``drain`` (default) queued requests are
        flushed first; without it they fail with RuntimeError."""
        self._drain_on_close = drain
        self._stop.set()
        th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout)

    def _scheduler_loop(self) -> None:
        """Single scheduler thread: drain -> coalesce -> flush.

        Never blocks on anything but the staging queue, and only ever with a
        timeout (the coalescing window or the idle poll): a blocking call
        here stalls EVERY queued request."""
        q = self._q
        while True:
            try:
                first = q.get(timeout=_IDLE_POLL_S)
            except queue.Empty:
                if self._stop.is_set():
                    break
                continue
            staged = [first]
            rows = first.n
            now = time.perf_counter()
            # empty queue at pickup = no concurrent demand: flush NOW (n=1
            # fast path — a lone sequential client never pays the window;
            # coalescing only engages when a backlog actually exists)
            idle = q.qsize() == 0
            if idle or self._window_s <= 0.0 or self._stop.is_set():
                # n=1 fast path: an unloaded server answers immediately —
                # still scooping up anything that raced in, for free
                while rows < self._max_rows:
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        break
                    staged.append(nxt)
                    rows += nxt.n
                if idle and rows == first.n:
                    with self._stats_lock:
                        self.stats["fast_path"] += 1
            else:
                # coalesce: flush on max(batch_window_us, bucket-full)
                deadline = now + self._window_s
                while rows < self._max_rows:
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        left = deadline - time.perf_counter()
                        if left <= 0.0:
                            break
                        try:
                            nxt = q.get(timeout=left)
                        except queue.Empty:
                            break
                    staged.append(nxt)
                    rows += nxt.n
            if self._flush_min_s > 0.0:
                # flush pacing: hold this dispatch until the interval since
                # the previous one has elapsed, scooping any rows that arrive
                # meanwhile (up to the batch cap). All waits are bounded and
                # interruptible — queue timeout or the stop event, never a
                # bare sleep
                paced = False
                while not self._stop.is_set():
                    left = self._next_flush_t - time.perf_counter()
                    if left <= 0.0:
                        break
                    paced = True
                    if rows < self._max_rows:
                        try:
                            nxt = q.get(timeout=left)
                        except queue.Empty:
                            continue
                        staged.append(nxt)
                        rows += nxt.n
                    else:
                        self._stop.wait(left)
                self._next_flush_t = time.perf_counter() + self._flush_min_s
                if paced:
                    with self._stats_lock:
                        self.stats["paced_flushes"] += 1
            self._flush(staged)
        # shutdown: drain or fail whatever is still queued
        leftovers: List[_Request] = []
        while True:
            try:
                leftovers.append(q.get_nowait())
            except queue.Empty:
                break
        if leftovers:
            if getattr(self, "_drain_on_close", True):
                self._flush(leftovers)
            else:
                for r in leftovers:
                    r._fail(RuntimeError("server shut down before serving"))

    def _flush(self, staged: List[_Request]) -> None:
        """Serve one coalesced batch: group by (model, options), run each
        group through its model's engine, scatter responses. A model in the
        admission controller's *degrade* state gets its groups split at the
        degraded batch cap — smaller buckets, shorter dispatches, lower
        per-request latency while the SLO budget recovers."""
        groups: Dict[Tuple[str, Tuple[bool, bool]], List[_Request]] = {}
        for r in staged:
            groups.setdefault((r.model, r.key), []).append(r)
        adm = self._admission
        for (model, key), reqs in groups.items():
            cap = adm.batch_cap(model) if adm is not None else None
            for chunk in _split_requests(reqs, cap):
                try:
                    sm = self.registry.acquire(model)
                except KeyError as e:
                    # a request staged for "<base>@<shadow>" can lose the
                    # race with a rollback that unpublishes the shadow name
                    # before the flush; serve it from the base entry — a
                    # rollback must never surface as a client error
                    base, sep, _ = model.partition("@")
                    try:
                        if not sep:
                            raise e
                        sm = self.registry.acquire(base)
                    except KeyError:
                        for r in chunk:
                            r._fail(e)
                        continue
                    with self._stats_lock:
                        self.stats["canary_fallback"] += len(chunk)
                n = sum(r.n for r in chunk)
                try:
                    self._flush_group(sm, key, chunk, n)
                except Exception as e:
                    with self._stats_lock:
                        self.stats["errors"] += 1
                    for r in chunk:
                        r._fail(e)
                finally:
                    self.registry.release(sm, rows=n)

    def _flush_group(self, sm: ServedModel, key: Tuple[bool, bool],
                     reqs: List[_Request], n: int) -> None:
        raw_score, pred_leaf = key
        eng = sm.engine
        t0 = time.perf_counter()
        f = reqs[0].x.shape[1]
        b = bucket_rows(n, eng.min_bucket, eng.chunk_rows)
        if len(reqs) == 1:
            x = reqs[0].x
        else:
            x = self._staging_x.get((b, f))
            if x is None:
                x = self._staging_x[(b, f)] = np.empty((b, f), np.float64)
            off = 0
            for r in reqs:
                x[off: off + r.n] = r.x
                off += r.n
        bins = self._staging_bins.get((b, f))
        if bins is None or n > bins.shape[0]:
            bins = self._staging_bins[(b, f)] = np.empty((b, f), np.int32)
        # in-place pseudo-binning into the reused staging buffer; rows past n
        # are stale from earlier flushes, which is fine — the walk is
        # row-independent and run_binned drops them before any sum
        tracing_on = self._trace and obs.enabled()
        trace: Optional[Dict[str, float]] = {} if tracing_on else None
        try:
            bin_t0 = time.perf_counter()
            eng.router.bin_matrix(np.asarray(x[:n], dtype=np.float64),
                                  out=bins[:n])
            bin_s = time.perf_counter() - bin_t0
            out = eng.run_binned(bins, n, raw_score, pred_leaf, trace=trace)
        except Exception as e:
            self._note_flush_fault(sm, reqs, trace, t0, e)
            raise
        off = 0
        for r in reqs:
            r._finish(out[off: off + r.n], sm.version)
            off += r.n
        done_t = time.perf_counter()
        with self._stats_lock:
            self.stats["flushes"] += 1
            self.stats["flushed_rows"] += n
        if slo.TRACKER.active:
            for r in reqs:
                slo.TRACKER.observe(sm.name, done_t - r.enq_t)
        if obs.enabled():
            dt = done_t - t0
            wait_us = (t0 - min(r.enq_t for r in reqs)) * 1e6
            obs.emit("serve_flush", rows=n, requests=len(reqs), bucket=int(b),
                     model=sm.name, version=sm.version, wait_us=wait_us,
                     duration_s=dt)
            obs.METRICS.counter("serve_flushes", "coalesced flushes",
                                model=sm.name).inc()
            obs.METRICS.counter("serve_coalesced_rows",
                                "rows served through coalesced flushes",
                                model=sm.name).inc(n)
            obs.METRICS.gauge("serve_queue_depth",
                              "staging queue depth after drain").set(
                                  self._q.qsize())
            h = obs.METRICS.histogram("serve_latency_seconds",
                                      "request latency (enqueue -> response)",
                                      model=sm.name, bucket=str(int(b)))
            hr = obs.METRICS.histogram("request_latency_seconds",
                                       "end-to-end request latency "
                                       "(all buckets)", model=sm.name)
            for r in reqs:
                h.observe(done_t - r.enq_t)
                hr.observe(done_t - r.enq_t)
        if tracing_on:
            dd = trace.get("device_dispatch", 0.0)
            rb = trace.get("readback", 0.0)
            tracing.record_span("serve.bin", bin_s)
            tracing.record_span("serve.device_dispatch", dd)
            tracing.record_span("serve.readback", rb)
            for r in reqs:
                tracing.record_span("serve.queue_wait", t0 - r.enq_t)
                tracing.TRACES.maybe_record(
                    {"trace_id": r.trace_id, "model": sm.name,
                     "version": sm.version, "rows": r.n, "bucket": int(b),
                     "queue_wait_s": t0 - r.enq_t, "bin_s": bin_s,
                     "device_dispatch_s": dd, "readback_s": rb,
                     "total_s": done_t - r.enq_t},
                    sample=self._trace_sample)

    def _note_flush_fault(self, sm: ServedModel, reqs: List[_Request],
                          trace: Optional[Dict[str, float]], t0: float,
                          exc: BaseException) -> None:
        """Device fault mid-flush: record the failing requests' span chains
        into the flight recorder BEFORE emitting the device_fault event, so
        the auto-trip dump already contains them."""
        if not faults.is_device_fault(exc):
            return
        err = str(exc)[:200]
        for r in reqs:
            rec = {"trace_id": r.trace_id, "model": sm.name,
                   "version": sm.version, "rows": r.n,
                   "queue_wait_s": t0 - r.enq_t, "error": err}
            if trace:
                rec.update(trace)
            flight.FLIGHT.note_span(rec)
        obs.emit("device_fault", point=faults.classify_point(exc),
                 policy="serve", action="fail_request", error=err)

    def queue_depth(self) -> int:
        """Current staging-queue depth (approximate; lock-free)."""
        return self._q.qsize()

    def coalesce_factor(self) -> float:
        """Average rows per device dispatch on the coalesced path (>1 means
        the scheduler is amortizing dispatches across requests)."""
        with self._stats_lock:
            fl = self.stats["flushes"]
            return self.stats["flushed_rows"] / fl if fl else 0.0

    def snapshot(self) -> Dict:
        with self._stats_lock:
            st = dict(self.stats)
        st["queue_depth"] = self._q.qsize()
        st["coalesce_factor"] = round(
            st["flushed_rows"] / st["flushes"], 3) if st["flushes"] else 0.0
        return st


class PredictServer:
    """Registry + microbatcher behind one object — the ``task=serve`` core.

    >>> srv = PredictServer(params, model=booster)      # publish v1 + warm
    >>> y = srv.predict(x_row)                          # coalesced predict
    >>> srv.publish(new_booster)                        # atomic hot-swap
    >>> srv.close()
    """

    def __init__(self, params=None, model=None, name: str = "default",
                 start: bool = True):
        conf = params if isinstance(params, Config) \
            else params_to_config(params)
        self.conf = conf
        # the card unless the parameters ask for the CPU (device_type)
        from .basic import resolve_device
        self.device = resolve_device(conf)
        self.registry = ModelRegistry(self.device)
        # SLO admission control (local import: fleet depends on this module
        # for MicroBatcher/ModelRegistry, so the dependency must stay lazy)
        from .fleet.admission import AdmissionController
        self.admission = AdmissionController.from_config(conf)
        self.batcher = MicroBatcher(
            self.registry,
            batch_window_us=conf.serve_batch_window_us,
            queue_max=conf.serve_queue_max,
            max_batch_rows=conf.serve_max_batch_rows,
            start=start,
            trace=conf.serve_trace,
            trace_sample=conf.serve_trace_sample,
            flush_interval_us=conf.serve_flush_interval_us,
            admission=self.admission)
        self.online = None   # OnlineTrainer, via attach_online
        self.rollout = None  # RolloutManager, via ensure_rollout
        slo.TRACKER.configure(slo_ms=conf.serve_slo_ms,
                              target=conf.serve_slo_target,
                              window=conf.serve_slo_window)
        self._obs_http = obs_http.maybe_start(conf)
        obs_http.add_status_section("serving", self._statusz)
        obs.add_collector("serving", self._collect_metrics)
        if model is not None:
            self.publish(model, name=name)

    def attach_online(self, trainer) -> None:
        """Attach an :class:`~.online.OnlineTrainer` (or a keyed
        :class:`~.online.OnlineTrainerGroup`) so the ``!learn``/``!label``
        protocol commands feed it and served predictions stream into its
        unlabeled drift comparator; each refit cycle it triggers publishes
        back into this server's registry (zero-downtime swap)."""
        self.online = trainer
        if hasattr(trainer, "statusz"):
            obs_http.add_status_section("online", trainer.statusz)

    def _online_capture(self, rid: str, x, model: str) -> None:
        """Serve-time ingress half of the delayed-label join: file the
        request's features with the online trainer BEFORE predicting, so a
        label arriving after a crash still joins (the capture is
        WAL-durable when the trainer logs)."""
        tr = self.online
        if tr is None or not hasattr(tr, "feed_features"):
            raise LightGBMError(
                "capture_id needs an attached online trainer")
        from .online import OnlineTrainerGroup
        if isinstance(tr, OnlineTrainerGroup):
            tr.feed_features(rid, x, model=model)
        else:
            tr.feed_features(rid, x)

    def _online_observe(self, out, model: str) -> None:
        """Drift tap: stream served scores into the trainer's unlabeled
        drift comparator (no-op unless online_drift_psi_max is set)."""
        tr = self.online
        fn = None if tr is None else getattr(tr, "observe_served", None)
        if fn is None:
            return
        try:
            from .online import OnlineTrainerGroup
            if isinstance(tr, OnlineTrainerGroup):
                fn(out, model=model)
            else:
                fn(out)
        except KeyError:
            pass   # no trainer under this serve-model name: nothing to watch

    def _warmup_sizes(self) -> Tuple[int, ...]:
        """1 + every power-of-two bucket up to serve_max_batch_rows, so the
        first coalesced flush of any size finds its bucket's blocks in the
        caching allocator."""
        sizes = [1]
        b = 2
        while b <= self.conf.serve_max_batch_rows:
            sizes.append(b)
            b <<= 1
        return tuple(sizes)

    def publish(self, model, name: str = "default") -> int:
        """Publish a Booster (or model file path) as the next version of
        ``name``; returns the new version number. The engine is built and
        warmed before the atomic swap, so traffic never waits on an
        upload."""
        from .basic import Booster
        if isinstance(model, (str, bytes)):
            model = Booster(model_file=model)
        sm = self.registry.publish(name, model,
                                   warmup_sizes=self._warmup_sizes())
        return sm.version

    def ensure_rollout(self, name: str = "default"):
        """The server's RolloutManager (canary/shadow deployment), created
        on first use. Once created, :meth:`submit`/:meth:`predict` route
        through it whenever a rollout is active."""
        if self.rollout is None:
            from .fleet.rollout import RolloutManager, ServerBackend
            self.rollout = RolloutManager(ServerBackend(self), self.conf,
                                          name=name)
        return self.rollout

    def predict(self, x, model: str = "default", raw_score: bool = False,
                pred_leaf: bool = False,
                timeout: Optional[float] = None,
                capture_id: Optional[str] = None) -> np.ndarray:
        """Predict through the coalescing scheduler; with ``capture_id``
        the features are first filed with the attached online trainer for a
        delayed-label join (the label arrives later via
        ``feed_label``/``!label``)."""
        if capture_id is not None:
            self._online_capture(capture_id, x, model)
        out = self.submit(x, model=model, raw_score=raw_score,
                          pred_leaf=pred_leaf).result(timeout)
        if self.online is not None and not raw_score and not pred_leaf:
            self._online_observe(out, model)
        return out

    def predict_versioned(self, x, model: str = "default",
                          timeout: Optional[float] = None,
                          capture_id: Optional[str] = None
                          ) -> Tuple[np.ndarray, int]:
        """Predict + the version that actually served it — read off the
        request itself, so the answer is race-free across concurrent
        hot-swaps (and reflects canary routing when a rollout is live)."""
        if capture_id is not None:
            self._online_capture(capture_id, x, model)
        req = self.submit(x, model=model)
        out = req.result(timeout)
        if self.online is not None:
            self._online_observe(out, model)
        return out, req.version

    def submit(self, x, **kw) -> _Request:
        ro = self.rollout
        if ro is not None and ro.active:
            return ro.submit(x, **kw)
        return self.batcher.submit_async(x, **kw)

    def _statusz(self) -> Dict:
        """/statusz section: registry + queue (+ SLO when configured)."""
        out = {"models": self.registry.models(),
               "queue": self.batcher.snapshot()}
        s = slo.TRACKER.snapshot()
        if s:
            out["slo"] = s
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        if self.rollout is not None:
            out["rollout"] = self.rollout.statusz()
        return out

    def _collect_metrics(self, reg) -> None:
        """Scrape-time derived gauges: model freshness + live queue depth."""
        now = time.time()
        for name, info in self.registry.models().items():
            reg.gauge("model_age_seconds",
                      "seconds since the serving version was published",
                      model=name).set(now - info["published_t"])
        reg.gauge("serve_queue_depth",
                  "staging queue depth after drain").set(
                      self.batcher.queue_depth())

    def _latency_summary(self) -> Dict:
        """p50/p95/p99 per model from the request-latency histogram."""
        fam = obs.METRICS.get_family("request_latency_seconds")
        if fam is None:
            return {}
        _, children = fam
        out: Dict[str, Dict] = {}
        for key, hist in children.items():
            model = dict(key).get("model", "default")
            snap = hist.snapshot()
            qs = histogram_quantiles(snap, (0.5, 0.95, 0.99))
            out[model] = {"p50_ms": round(qs[0.5] * 1e3, 3),
                          "p95_ms": round(qs[0.95] * 1e3, 3),
                          "p99_ms": round(qs[0.99] * 1e3, 3),
                          "count": snap["count"]}
        return out

    def stats(self) -> Dict:
        out = {"scheduler": self.batcher.snapshot(),
               "models": self.registry.models()}
        s = slo.TRACKER.snapshot()
        if s:
            out["slo"] = s
        lat = self._latency_summary()
        if lat:
            out["latency"] = lat
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        if self.rollout is not None:
            out["rollout"] = self.rollout.snapshot()
        if self.online is not None and hasattr(self.online, "statusz"):
            # per-model join/drift/WAL state rides along, so !stats and
            # server_stats_json mirror the /statusz online section
            out["online"] = self.online.statusz()
        return out

    def fleet_stats(self) -> Dict:
        """Fleet-shaped stats for a single server (the ``!fleet_stats``
        protocol answer when no ReplicaPool is in front)."""
        out = {"mode": "single", "replicas": 1,
               "scheduler": self.batcher.snapshot()}
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        if self.rollout is not None:
            out["rollout"] = self.rollout.snapshot()
        return out

    def close(self, drain: bool = True) -> None:
        self.rollout = None
        self.batcher.close(drain=drain)
        obs.remove_collector("serving")
        obs_http.remove_status_section("serving")
        if self.online is not None:
            obs_http.remove_status_section("online")
        obs_http.stop(self._obs_http)
        self._obs_http = None


# ---- transports (task=serve): newline-delimited request protocol ----
#
#   <v1>,<v2>,...      feature row  ->  "<version>\t<val>[,<val>...]"
#   <rid>|<v1>,<v2>,.. feature row + delayed-label capture: the features
#                      are filed with the online trainer under request id
#                      <rid> (WAL-durable) BEFORE predicting, so a later
#                      "!label <rid> ..." joins them
#                                   ->  "<version>\t<val>[,<val>...]"
#   !publish <path>    hot-swap     ->  "ok version=<n>"
#   !learn <y>,<v1>,.. labeled row into the attached OnlineTrainer
#                                   ->  "ok pending=<n>[ version=<v>]"
#                      (version only when the row triggered a synchronous
#                      refit; under online_async_refit the cycle runs on
#                      the trainer's worker and the reply never waits)
#   !label <rid> <y>   late-arriving label joins the features captured
#                      under <rid>; unmatched/duplicate labels are counted,
#                      never trained
#                                   ->  "ok pending=<n> joined=<n>[ version=<v>]"
#   !canary <path> [fraction] [shadow|canary]
#                      start a rollout -> "ok version=<n> mode=<m>"
#   !promote           promote the canary now -> "ok version=<n>"
#   !rollback          roll the canary back   -> "ok version=<n>"
#   !fleet_stats       fleet/rollout stats    -> one-line JSON
#   !stats             stats        ->  one-line JSON
#   !quit              shut down the server loop
#
# The same handler serves the stdio loop (serial; deployment smoke tests),
# the threaded TCP loop (each connection is a thread, so concurrent
# connections genuinely coalesce through the shared scheduler), and — duck-
# typed — the fleet facade (fleet/service.py) and fleet worker processes.

def handle_line(server, line: str, model: str = "default") -> Optional[str]:
    """One protocol line -> one response line (None = quit)."""
    line = line.strip()
    if not line:
        return ""
    if line.startswith("!"):
        cmd = line.split(None, 1)
        if cmd[0] == "!quit":
            return None
        if cmd[0] == "!stats":
            return json.dumps(server.stats(), sort_keys=True)
        if cmd[0] == "!publish":
            if len(cmd) < 2:
                return "error: !publish needs a model path"
            try:
                v = server.publish(cmd[1].strip(), name=model)
            except Exception as e:
                return f"error: publish failed: {e}"
            return f"ok version={v}"
        if cmd[0] == "!learn":
            # labeled row for the attached OnlineTrainer (label first, the
            # label_index=0 file convention): "!learn <label>,<v1>,<v2>,..."
            if server.online is None:
                return "error: no online trainer attached"
            if len(cmd) < 2:
                return "error: !learn needs <label>,<v1>,<v2>,..."
            try:
                vals = [float(p)
                        for p in cmd[1].replace(",", " ").split()]
                if len(vals) < 2:
                    raise ValueError("need a label and at least one feature")
                ver = server.online.feed(
                    np.asarray(vals[1:], dtype=np.float64)[None, :],
                    [vals[0]])
            except Exception as e:
                return f"error: learn failed: {e}"
            tail = f" version={ver}" if ver else ""
            return f"ok pending={server.online.pending_rows}{tail}"
        if cmd[0] == "!label":
            # delayed-label join: "!label <request-id> <label> [weight]"
            # joins a late label against the features a "<rid>|<v1>,..."
            # predict line captured earlier
            if server.online is None:
                return "error: no online trainer attached"
            args = cmd[1].split() if len(cmd) > 1 else []
            if len(args) < 2:
                return "error: !label needs <request-id> <label>"
            try:
                w = float(args[2]) if len(args) > 2 else None
                ver = server.online.feed_label(args[0], float(args[1]),
                                               weight=w)
                js = server.online.join_stats()
            except Exception as e:
                return f"error: label failed: {e}"
            tail = f" version={ver}" if ver else ""
            return (f"ok pending={js.get('pending', 0)} "
                    f"joined={js.get('joined', 0)}{tail}")
        if cmd[0] == "!canary":
            # "!canary <path> [fraction] [shadow|canary]" — start a rollout
            args = cmd[1].split() if len(cmd) > 1 else []
            if not args:
                return "error: !canary needs a model path"
            fraction = None
            shadow = None
            for tok in args[1:]:
                if tok in ("shadow", "canary"):
                    shadow = tok == "shadow"
                else:
                    try:
                        fraction = float(tok)
                    except ValueError:
                        return f"error: bad !canary argument {tok!r}"
            try:
                ro = server.ensure_rollout(model)
                v = ro.start(args[0], fraction=fraction, shadow=shadow)
            except Exception as e:
                return f"error: canary failed: {e}"
            return f"ok version={v} mode={ro.state}"
        if cmd[0] == "!promote":
            try:
                v = server.ensure_rollout(model).promote()
            except Exception as e:
                return f"error: promote failed: {e}"
            return f"ok version={v}"
        if cmd[0] == "!rollback":
            try:
                v = server.ensure_rollout(model).rollback()
            except Exception as e:
                return f"error: rollback failed: {e}"
            return f"ok version={v}"
        if cmd[0] == "!fleet_stats":
            return json.dumps(server.fleet_stats(), sort_keys=True)
        return f"error: unknown command {cmd[0]}"
    try:
        # "<rid>|<features>" asks for delayed-label capture at ingress:
        # the features are filed under <rid> before the predict, so the
        # later "!label <rid> <y>" can join them (a crash in between loses
        # nothing — the capture is WAL-durable)
        rid = None
        if "|" in line:
            rid, _, line = line.partition("|")
            rid = rid.strip() or None
        parts = line.replace(",", " ").split()
        if not parts:
            raise ValueError("no features parsed")
        x = np.array([float(p) for p in parts], dtype=np.float64)
        if rid is not None:
            if server.online is None:
                return "error: no online trainer attached for capture"
            server.online.feed_features(rid, x)
        # version comes off the request itself (not a second registry read):
        # race-free under hot-swap, and honest under canary routing
        out, ver = server.predict_versioned(x, model=model)
        vals = ",".join("%.17g" % v for v in np.asarray(out).reshape(-1))
        return f"{ver}\t{vals}"
    except ServeOverload:
        return "error: overloaded"
    except Exception as e:
        return f"error: {e}"


def serve_stdio(server: PredictServer, in_stream, out_stream) -> int:
    """Serial request loop over a pair of text streams (the ``serve_port=0``
    transport; also what the CLI smoke tests drive)."""
    served = 0
    for line in in_stream:
        resp = handle_line(server, line)
        if resp is None:
            break
        out_stream.write(resp + "\n")
        out_stream.flush()
        served += 1
    return served


def serve_tcp(server: PredictServer, host: str, port: int,
              ready: Optional[threading.Event] = None):
    """Threaded TCP loop: one thread per connection, all submitting into the
    shared scheduler — concurrent clients coalesce. Returns the
    ``socketserver`` instance's bound (host, port) after shutdown."""
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            while True:
                raw = self.rfile.readline()
                if not raw:
                    return
                resp = handle_line(server, raw.decode("utf-8",
                                                      errors="replace"))
                if resp is None:
                    threading.Thread(target=srv.shutdown,
                                     daemon=True).start()
                    return
                self.wfile.write((resp + "\n").encode())

    class Srv(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    srv = Srv((host, port), Handler)
    addr = srv.server_address
    log.info(f"serving on {addr[0]}:{addr[1]} "
             f"(window={server.conf.serve_batch_window_us}us, "
             f"queue_max={server.conf.serve_queue_max})")
    if ready is not None:
        ready.addr = addr  # type: ignore[attr-defined]
        ready.set()
    try:
        srv.serve_forever(poll_interval=0.1)
    finally:
        srv.server_close()
    return addr
