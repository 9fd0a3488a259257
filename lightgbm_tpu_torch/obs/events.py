"""Structured telemetry events: a bounded in-memory log of typed records.

Port of ``lightgbm_tpu/obs/events.py``, with its schema table copied whole,
so that every event type has the reference's required and optional fields
(the types the port does not emit yet stay registered; ``obs/__init__.py``
names them). LightGBM has no event telemetry: its only observability
surface is the ``USE_TIMER`` wall-clock table (common.h:1032) and free-form
logging. Here every lifecycle moment (a boosting iteration, a snapshot
write, a resume, a non-finite guard trip, an injected fault, a retry)
becomes a *schema-registered* event: the type must be registered in
:data:`EVENT_SCHEMAS`, required fields must be present, and no
unregistered field may appear. Violations raise immediately: call sites
are all internal, and ``tests/test_torch_telemetry.py`` checks every
``obs.emit`` call of the package statically, so a schema error is a bug,
not an operational condition.

Events are held in a bounded deque (oldest dropped first; the drop count is
itself observable) and serialized as JSON Lines through
``utils.atomic_io.atomic_write_text`` so a crash mid-export never leaves a
truncated file.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils import atomic_io

# type name -> (required fields, optional fields); each field maps to the
# expected python type. int is accepted where float is declared; bool is NOT
# accepted for int/float (it is a distinct wire type in the JSONL output).
_NUM = (int, float)
EVENT_SCHEMAS: Dict[str, Tuple[Dict[str, Any], Dict[str, Any]]] = {
    # one boosting iteration finished (engine.train loop). leaf_count /
    # best_gain come from the lagged async finished-check queue and therefore
    # describe iteration ``lagged_iteration`` (<= iteration), never the
    # current one — reading them synchronously would stall the device pipeline.
    "train_iter": ({"iteration": int, "duration_s": _NUM, "rows_per_s": _NUM},
                   {"leaf_count": int, "best_gain": _NUM,
                    "lagged_iteration": int}),
    # a jitted program was built (host-side tracing/lowering observed via
    # the function's cache size; device code itself is unchanged)
    "compile": ({"what": str, "cache_size": int},
                {"duration_s": _NUM, "key": str}),
    "snapshot_write": ({"iteration": int, "path": str, "duration_s": _NUM},
                       {"kept": int, "num_shards": int}),
    "resume": ({"iteration": int, "path": str},
               {"source": str, "num_shards": int, "snapshot_shards": int}),
    # a non-finite guard fired (gradients/scores/eval values)
    "nonfinite_guard": ({"where": str, "policy": str},
                        {"iteration": int, "action": str}),
    "predict_batch": ({"rows": int, "bucket": int, "duration_s": _NUM},
                      {"chunked": bool, "chunks": int, "engine_calls": int}),
    # PredictEngine uploaded tree tables to device (new engine or model
    # version change invalidated the cached one)
    "engine_upload": ({"n_trees": int, "num_class": int},
                      {"reason": str, "duration_s": _NUM}),
    # one coalesced flush on the serve path (server.py MicroBatcher):
    # `requests` concurrent requests shared one `bucket`-sized dispatch;
    # wait_us is the oldest request's staging wait
    "serve_flush": ({"rows": int, "requests": int, "bucket": int},
                    {"model": str, "version": int, "wait_us": _NUM,
                     "duration_s": _NUM}),
    # a model version was published into the serving registry (engine built
    # + warmed BEFORE the atomic swap, so duration_s is off-hot-path)
    "serve_publish": ({"model": str, "version": int, "n_trees": int},
                      {"duration_s": _NUM}),
    # a hot-swapped-out version fully drained and its device tables were
    # freed; drain_s is retire -> last in-flight flush released
    "serve_retire": ({"model": str, "version": int},
                     {"served_rows": int, "drain_s": _NUM}),
    # bounded staging queue was full: one request shed (ServeOverload)
    "serve_shed": ({"queued": int, "limit": int}, {"model": str}),
    # ---- serving fleet / rollout (lightgbm_tpu/fleet/) ----
    # a canary/shadow rollout started: the candidate version is published
    # under "<model>@canary" and the comparator begins watching
    "canary_start": ({"model": str, "version": int, "mode": str,
                      "fraction": _NUM},
                     {"incumbent_version": int}),
    # the candidate was promoted to the live version (drift-free window
    # elapsed, or manual/!promote); its warmed engine is re-homed, not
    # rebuilt — clean_s is how long the comparator stayed drift-free
    "canary_promote": ({"model": str, "version": int, "reason": str},
                       {"psi": _NUM, "ks": _NUM, "samples": int,
                        "clean_s": _NUM}),
    # the candidate was rolled back (PSI/KS divergence, manual, or
    # superseded by a newer candidate); the incumbent keeps serving and the
    # candidate's engine drains through the registry refcount
    "canary_rollback": ({"model": str, "version": int, "reason": str},
                        {"psi": _NUM, "ks": _NUM, "samples": int}),
    # a fleet replica's health probe flipped (routed around when unhealthy)
    "replica_health": ({"replica": str, "healthy": bool},
                       {"replicas": int, "error": str}),
    # SLO admission control changed a model's state (admit/degrade/shed)
    # off the error-budget burn rate
    "admission_state": ({"model": str, "state": str},
                        {"burn_rate": _NUM, "attainment": _NUM}),
    # one request shed at ingress by admission control (budget exhausted)
    "admission_shed": ({"model": str}, {"burn_rate": _NUM}),
    # one artifact published to every replica in the fleet
    "fleet_publish": ({"model": str, "version": int, "replicas": int},
                      {"duration_s": _NUM}),
    # one chunk made it through the three-stage ingest pipeline
    # (ingest.py): per-stage durations + queue depth observed at commit
    "ingest_chunk": ({"chunk": int, "rows": int},
                     {"encode_s": _NUM, "h2d_s": _NUM, "commit_s": _NUM,
                      "depth": int}),
    # a chunk was committed into its owning row shard's donated accumulator
    # (mesh-native sharded ingest, ingest.py): shard id + payload size
    "mesh_shard_commit": ({"shard": int, "rows": int, "bytes": int},
                          {"chunk": int, "h2d_s": _NUM, "commit_s": _NUM}),
    # host-timed probe of the histogram psum over the data mesh (the in-step
    # psum is fused inside the jitted tree grower where per-op wall time is
    # invisible; the probe runs the same collective/shape at trainer setup)
    "hist_allreduce": ({"shards": int, "bytes": int, "psum_s": _NUM}, {}),
    # background AOT compile lifecycle (prewarm.py): started -> compiled ->
    # adopted, or skipped/miss/error with a reason; duration_s is the
    # compile time (compiled/error), or the join-barrier wait (adopted)
    "aot_prewarm": ({"phase": str}, {"duration_s": _NUM, "reason": str}),
    "fault_injected": ({"point": str}, {"hit": int}),
    "dist_retry": ({"name": str, "attempt": int},
                   {"error": str, "delay_s": _NUM}),
    "consistency_fence": ({"processes": int, "ok": bool},
                          {"mismatched_fields": int}),
    # a device-level fault (real or injected XLA RESOURCE_EXHAUSTED, or a
    # device chaos point) was caught and a recovery action taken per the
    # on_device_fault policy: action is one of halve_chunk / reshard /
    # fallback_single / retry / fatal
    "device_fault": ({"point": str, "policy": str, "action": str},
                     {"error": str, "attempt": int, "chunk_rows": int,
                      "shards_before": int, "shards_after": int}),
    # pre-step-0 mesh validation (parallel/fence.mesh_preflight): device
    # liveness probe + shard-plan/config consistency, locally and (multi-
    # process) across ranks
    "mesh_preflight": ({"shards": int, "ok": bool},
                       {"devices": int, "mismatched_fields": int,
                        "error": str}),
    # fresh rows were appended to a constructed Dataset under its frozen bin
    # boundaries + EFB plan (basic.Dataset.append); resharded marks a
    # shard-grid re-plan + redistribution for the grown row total
    "dataset_append": ({"rows": int, "total_rows": int},
                       {"chunks": int, "duration_s": _NUM, "num_shards": int,
                        "resharded": bool, "evicted": int}),
    # one continuous-training refit cycle completed (online.OnlineTrainer):
    # trigger is "rows" / "drift" / "manual" / "flush"; mode is "refit"
    # (leaf-output refit) or "boost" (continued training); publish_s is the
    # registry publish (engine build + warm) portion of duration_s; lag_s is
    # the feed->publish freshness of the cycle's oldest row; wal_seq is the
    # highest WAL batch sequence the cycle sealed (WAL on); attempt > 1
    # marks a retry after a failed cycle
    "online_refit": ({"trigger": str, "rows": int, "version": int},
                     {"duration_s": _NUM, "mode": str, "iteration": int,
                      "publish_s": _NUM, "lag_s": _NUM, "wal_seq": int,
                      "attempt": int}),
    # a refit cycle FAILED (nonfinite, device fault, exception): the last-
    # good version keeps serving, the flight recorder dumps (TRIP_EVENTS),
    # and the async worker retries with backoff — error_class is
    # "device_fault" or the exception type name
    "online_cycle_failed": ({"trigger": str, "attempt": int,
                             "error_class": str},
                            {"error": str, "rows": int, "backoff_s": _NUM}),
    # ---- write-ahead feed log (wal.py; docs/ONLINE.md exactly-once) ----
    # one feed batch became durable (fsync'd + checksummed) in the WAL
    "wal_append": ({"seq": int, "rows": int}, {"bytes": int}),
    # a cycle commit record sealed batches <= seq into published `version`
    "wal_commit": ({"seq": int, "version": int}, {"model": str}),
    # restart recovery: torn tail truncated, committed batches re-appended
    # to the Dataset (no retraining), unacknowledged batches replayed
    "wal_recover": ({"committed": int, "replayed": int},
                    {"rows": int, "truncated_bytes": int, "model": str,
                     "duration_s": _NUM}),
    # a commit rotated the log: committed batch records outside the
    # online_max_rows window were dropped (their ids carried forward in a
    # tombstone record), bounding disk + recovery time for bounded-window
    # trainers
    "wal_rotate": ({"batches": int, "rows": int}, {"bytes": int}),
    # a WAL append failed (disk full) and the log degraded to buffered-only
    # mode, or space returned and it re-armed (recovered=True); skipped is
    # the running count of appends refused while degraded — flight-recorder
    # trip on both transitions
    "wal_degraded": ({"path": str},
                     {"recovered": bool, "error": str, "skipped": int}),
    # delayed-label join (join.py): pending features whose label never
    # arrived expired into counted drops — reason is "timeout", "overflow"
    # (resident cap with no durable copy to spill to), or "missing"
    # (spilled payload unreadable at join time); never silent
    "join_expired": ({"expired": int, "pending": int},
                     {"model": str, "oldest_age_s": _NUM, "reason": str}),
    # the unlabeled drift detector fired: the served prediction
    # distribution drifted past online_drift_psi_max from the at-last-fit
    # baseline — no labels involved; action is "refit" (a cycle was
    # dispatched) or "alarm" (alarm-only mode, or no pending rows to train
    # on: keep serving last-good) — flight-recorder trip
    "drift_unlabeled": ({"model": str, "psi": _NUM},
                        {"ks": _NUM, "samples": int, "action": str,
                         "threshold": _NUM, "pending_rows": int}),
    # feed->publish freshness crossed online_freshness_slo_s (obs/slo.py
    # FreshnessTracker); emitted on both transitions like slo_breach
    "freshness_breach": ({"model": str, "lag_s": _NUM, "slo_s": _NUM},
                         {"recovered": bool, "rows": int}),
    # the eval-metric drift watchdog fired: the current model's metric on
    # the incoming batch drifted past online_drift_metric_delta from the
    # baseline recorded at the previous (re)fit
    "drift_trigger": ({"metric": str, "baseline": _NUM, "current": _NUM,
                       "delta": _NUM},
                      {"rows": int}),
    # rolling SLO attainment crossed the target (obs/slo.py): emitted on
    # both transitions — recovered=True marks the climb back above target
    "slo_breach": ({"model": str, "attainment": _NUM, "target": _NUM},
                   {"burn_rate": _NUM, "recovered": bool, "window": int}),
    # the flight-recorder ring was dumped to disk (obs/flight.py): reason is
    # a TRIP_EVENTS type, "unhandled_exception", "sigterm", or an explicit
    # caller string; events/spans count the record kinds in the dump
    "flight_dump": ({"reason": str, "events": int},
                    {"spans": int, "path": str, "error": str}),
    # ObsServer HTTP endpoint lifecycle (obs/http_server.py)
    "obs_server": ({"phase": str}, {"port": int, "error": str}),
    # packed g/h histogram lattice was requested (hist_packed=true/auto) but
    # the guard-bit budget doesn't fit the training row count — the booster
    # fell back to the unpacked q8 kernels (bit-identical, just more MXU
    # channels). reason: "guard_budget"; requested: the config knob value
    "hist_pack_fallback": ({"n_rows": int, "reason": str},
                           {"requested": str, "const_hess": bool}),
}


_schema_lock = threading.Lock()


def register_event(name: str, required: Dict[str, Any],
                   optional: Optional[Dict[str, Any]] = None) -> None:
    """Register an event type (extension point for out-of-tree consumers)."""
    with _schema_lock:
        if name in EVENT_SCHEMAS:
            raise ValueError(f"event type {name!r} already registered")
        EVENT_SCHEMAS[name] = (dict(required), dict(optional or {}))


def _validate(etype: str, fields: Dict[str, Any]) -> None:
    schema = EVENT_SCHEMAS.get(etype)
    if schema is None:
        raise ValueError(f"unregistered event type {etype!r} "
                         f"(known: {sorted(EVENT_SCHEMAS)})")
    required, optional = schema
    for name, typ in required.items():
        if name not in fields:
            raise ValueError(f"event {etype!r} missing required field {name!r}")
    for name, value in fields.items():
        typ = required.get(name, optional.get(name))
        if typ is None:
            raise ValueError(f"event {etype!r} has unregistered field {name!r}")
        if typ in (int, _NUM) and isinstance(value, bool):
            raise ValueError(f"event {etype!r} field {name!r}: got bool where "
                             f"{'number' if typ is _NUM else 'int'} expected")
        if not isinstance(value, typ):
            want = "number" if typ is _NUM else typ.__name__
            raise ValueError(f"event {etype!r} field {name!r}: expected {want},"
                             f" got {type(value).__name__} ({value!r})")


class EventLog:
    """Bounded, thread-safe event buffer.

    ``emit`` is the single write path; it validates against the schema
    registry, stamps a wall-clock ``ts``, and appends.  When the buffer is
    full the oldest event is dropped and ``dropped`` increments — a bounded
    log can never grow a long training run out of host memory.
    """

    def __init__(self, capacity: int = 65536) -> None:
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._family: Dict[str, int] = {}
        self.dropped = 0

    def emit(self, etype: str, **fields: Any) -> None:
        _validate(etype, fields)
        rec = {"ts": time.time(), "type": etype}
        rec.update(fields)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                oldest = self._events[0]
                self._family[oldest["type"]] -= 1
                self.dropped += 1
            self._events.append(rec)
            self._family[etype] = self._family.get(etype, 0) + 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def family_counts(self) -> Dict[str, int]:
        """Buffered events per type (post-drop, so sums to ``len(self)``)."""
        with self._lock:
            return {k: v for k, v in self._family.items() if v > 0}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._family.clear()
            self.dropped = 0

    def to_jsonl(self) -> str:
        lines = [json.dumps(rec, sort_keys=True, default=_json_default)
                 for rec in self.snapshot()]
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path: str) -> None:
        atomic_io.atomic_write_text(path, self.to_jsonl())


def _json_default(obj: Any) -> Any:
    # numpy scalars sneak in from host reads of device arrays
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    return str(obj)
