"""Observability: telemetry events, metrics, trace spans, device memory.

Port of ``lightgbm_tpu/obs`` (ROADMAP A20), host code that imports neither
jax nor the reference. Off by default and designed so the disabled fast
path is one attribute read (``obs.enabled()`` / the ``_STATE.enabled``
check at the top of ``emit``): the training loop calls into here on every
iteration, and the reference's <2% overhead budget only holds if "off"
costs nothing (``chip_smoke.py`` path (q) measures it on the card).

Enable with the ``telemetry=1`` config param or the ``LGBMTPU_TELEMETRY=1``
environment variable (env wins, so an operator can switch telemetry on for
one run without touching params). ``metrics_out=<dir>`` names a directory
that :func:`export_all` fills with three crash-safe files::

    events.jsonl    one JSON object per event (schema: obs/events.py)
    metrics.json    nested metric snapshot
    metrics.prom    Prometheus textfile exposition format

``xla_trace_out=<dir>`` (the reference's knob name) captures a
torch.profiler trace of the boosting loop into a Chrome trace file there
(``obs/tracing.py``). Everything else is host-side bookkeeping around the
kernels: enabling telemetry launches no other kernel and changes no model
(tests/test_torch_telemetry.py holds the model text byte for byte).

The port emits the reference's events where its code has the reference's
moments: ``train_iter``, ``resume``, ``snapshot_write``,
``fault_injected``, ``dist_retry``, ``nonfinite_guard``,
``hist_pack_fallback``, ``flight_dump``, ``obs_server``, ``slo_breach``,
``freshness_breach``; the cold start's ``ingest_chunk``, ``aot_prewarm``
and ``device_fault`` (ingest.py, prewarm.py; a serving flush's device
fault too); the serving and fleet events (``engine_upload``,
``predict_batch``, ``serve_publish``, ``serve_retire``, ``serve_flush``,
``serve_shed``, ``admission_state``, ``admission_shed``,
``canary_start``, ``canary_promote``, ``canary_rollback``,
``fleet_publish``, ``replica_health``); the continuous-learning events
(``dataset_append``, ``online_refit``, ``online_cycle_failed``,
``drift_trigger``, ``drift_unlabeled``, ``freshness_breach``,
``join_expired`` and the ``wal_*`` events). Every type of the reference
stays registered with its fields, and these are not emitted: ``compile``
(it counts jit cache growth; the port traces nothing), ``hist_allreduce``
and the ``mesh_*`` events (multi-GPU, A21).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

from .. import log
from . import flight, memory, slo, tracing
from .events import EVENT_SCHEMAS, EventLog, register_event
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import maybe_start_xla_trace, span, stop_xla_trace

EVENTS = EventLog()
METRICS = MetricsRegistry()


def _env_enabled() -> Optional[bool]:
    v = os.environ.get("LGBMTPU_TELEMETRY")
    if v is None or v == "":
        return None
    return v.strip().lower() not in ("0", "false", "no", "off")


class _State:
    def __init__(self) -> None:
        # env-only workflows (LGBMTPU_TELEMETRY=1 + predict without any
        # configure call) start enabled; configure_from_config re-reads the
        # env anyway, so this is just the pre-configure default
        self.enabled = bool(_env_enabled())
        self.metrics_out = ""
        self.lock = threading.Lock()


_STATE = _State()


def enabled() -> bool:
    return _STATE.enabled


# an environment that switches telemetry on times the spans from the start
tracing.refresh_timing()


def configure(enabled: Optional[bool] = None,
              metrics_out: Optional[str] = None) -> None:
    with _STATE.lock:
        if enabled is not None:
            _STATE.enabled = bool(enabled)
        if metrics_out is not None:
            _STATE.metrics_out = str(metrics_out)
    tracing.refresh_timing()


def configure_from_config(conf) -> None:
    """Apply a Config's telemetry knobs (engine.train / CLI entry).
    ``LGBMTPU_TELEMETRY`` overrides the param in either direction."""
    env = _env_enabled()
    on = bool(getattr(conf, "telemetry", False)) if env is None else env
    configure(enabled=on, metrics_out=getattr(conf, "metrics_out", ""))
    slo.TRACKER.configure(slo_ms=getattr(conf, "serve_slo_ms", None),
                          target=getattr(conf, "serve_slo_target", None),
                          window=getattr(conf, "serve_slo_window", None))
    slo.FRESHNESS.configure(
        slo_s=getattr(conf, "online_freshness_slo_s", None))
    flight_dir = (getattr(conf, "flight_dir", "")
                  or getattr(conf, "metrics_out", ""))
    flight.FLIGHT.configure(out_dir=flight_dir,
                            capacity=getattr(conf, "flight_events", None))


def emit(etype: str, **fields: Any) -> None:
    """Record one telemetry event (no-op unless telemetry is enabled).
    Event types and fields must be registered in ``obs.events`` — an
    unregistered type or field raises (see scripts/check_telemetry_schema.py
    for the static check over call sites)."""
    if not _STATE.enabled:
        return
    EVENTS.emit(etype, **fields)
    if flight.FLIGHT.active:
        flight.FLIGHT.note_event(etype, fields)


def reset() -> None:
    """Clear accumulated events, metrics, SLO windows, trace exemplars and
    flight-recorder state (per-run isolation in tests) under one lock, so a
    concurrent configure can't observe a half-reset plane."""
    with _STATE.lock:
        EVENTS.clear()
        METRICS.clear()
        slo.TRACKER.reset()
        slo.FRESHNESS.reset()
        tracing.TRACES.clear()
        flight.FLIGHT.reset()


# ---- derived-gauge collectors ----------------------------------------------
# Run just before a scrape (/metrics) or an export so point-in-time gauges
# (event drops, buffered counts per family, device memory, model age) are
# fresh; nothing here runs on the hot paths.

_collectors_lock = threading.Lock()
_COLLECTORS: Dict[str, Any] = {}


def add_collector(name: str, fn) -> None:
    """Register ``fn(METRICS)`` to run before scrapes/exports (latest wins)."""
    with _collectors_lock:
        _COLLECTORS[name] = fn


def remove_collector(name: str) -> None:
    with _collectors_lock:
        _COLLECTORS.pop(name, None)


def run_collectors() -> None:
    with _collectors_lock:
        fns = list(_COLLECTORS.items())
    for name, fn in fns:
        try:
            fn(METRICS)
        except Exception as e:  # a broken collector must not break a scrape
            log.warning(f"metrics collector {name!r} failed "
                        f"({type(e).__name__}: {e})")


def _events_collector(reg: MetricsRegistry) -> None:
    reg.gauge("events_buffered",
              "telemetry events currently buffered").set(len(EVENTS))
    reg.gauge("events_dropped",
              "telemetry events dropped from the bounded log").set(EVENTS.dropped)
    for etype, n in EVENTS.family_counts().items():
        reg.gauge("events_by_type", "buffered telemetry events by type",
                  type=etype).set(n)


def export_all(out_dir: Optional[str] = None) -> Optional[str]:
    """Write events.jsonl + metrics.json + metrics.prom into ``out_dir``
    (default: the configured ``metrics_out``). Returns the directory written,
    or None when no directory is configured or telemetry is off."""
    out_dir = out_dir if out_dir is not None else _STATE.metrics_out
    if not out_dir or not _STATE.enabled:
        return None
    try:
        run_collectors()
        EVENTS.write_jsonl(os.path.join(out_dir, "events.jsonl"))
        METRICS.write_json(os.path.join(out_dir, "metrics.json"))
        METRICS.write_prometheus(os.path.join(out_dir, "metrics.prom"))
    except OSError as e:
        log.warning(f"telemetry export to {out_dir!r} failed "
                    f"({type(e).__name__}: {e})")
        return None
    return out_dir


# ---- periodic metrics flush -------------------------------------------------

_flush_lock = threading.Lock()
_flush_thread: Optional[threading.Thread] = None
_flush_stop: Optional[threading.Event] = None


def _flush_loop(interval_s: float, stop: "threading.Event") -> None:
    while not stop.wait(interval_s):
        export_all()


def start_periodic_flush(interval_s: float) -> bool:
    """Start the background re-export loop (``metrics_flush_secs`` knob).
    Returns True only to the caller that now owns it — pass that back to
    :func:`stop_periodic_flush` so a nested ``engine.train`` (an online refit
    cycle) can't tear down the outer run's flusher."""
    global _flush_thread, _flush_stop
    if interval_s is None or interval_s <= 0:
        return False
    if not _STATE.enabled or not _STATE.metrics_out:
        return False
    with _flush_lock:
        if _flush_thread is not None and _flush_thread.is_alive():
            return False
        stop = threading.Event()
        th = threading.Thread(target=_flush_loop, args=(float(interval_s), stop),
                              name="lgbm-obs-flush", daemon=True)
        _flush_stop = stop
        _flush_thread = th
        th.start()
    return True


def stop_periodic_flush(owned: bool) -> None:
    """Stop the flusher if ``owned`` (the start_periodic_flush return)."""
    global _flush_thread, _flush_stop
    if not owned:
        return
    with _flush_lock:
        th, stop = _flush_thread, _flush_stop
        _flush_thread = None
        _flush_stop = None
    if stop is not None:
        stop.set()
    if th is not None and th.is_alive():
        th.join(timeout=5.0)


add_collector("events", _events_collector)
add_collector("memory", memory.update_gauges)


__all__ = ["EVENTS", "METRICS", "EVENT_SCHEMAS", "EventLog", "MetricsRegistry",
           "Counter", "Gauge", "Histogram", "register_event",
           "configure", "configure_from_config", "enabled", "emit", "reset",
           "export_all", "span", "maybe_start_xla_trace", "stop_xla_trace",
           "memory", "tracing", "slo", "flight",
           "add_collector", "remove_collector", "run_collectors",
           "start_periodic_flush", "stop_periodic_flush"]
