"""Per-model latency SLOs: rolling attainment windows + error-budget burn.

Port of ``lightgbm_tpu/obs/slo.py`` (host code, copied); the port's serving
and continuous training (``online.py``) feed it. In the
reference the serve path (server.MicroBatcher._flush_group) feeds one
``observe`` per
completed request; the tracker keeps a bounded window of in/out-of-SLO
booleans per model and publishes the derived gauges into ``obs.METRICS`` so
they show up both on the live ``/metrics`` scrape and in ``export_all``:

    slo_attainment{model=}    fraction of windowed requests within the SLO
    slo_burn_rate{model=}     (1 - attainment) / (1 - target); >1 means the
                              error budget is burning faster than allotted
    slo_requests_total{model=} / slo_violations_total{model=}

Inactive (the default, ``serve_slo_ms=0``) the tracker costs one lock-guarded
comparison per request and records nothing.  Attainment transitions across
the target emit a ``slo_breach`` event in both directions (breach/recovery).

The training side has its own SLO: :class:`FreshnessTracker` watches the
continuous-training loop's feed->publish lag (``online_freshness_slo_s``).
Each refit cycle observes the age of its OLDEST buffered row at publish
time; the trainer additionally keeps a live ``refit_pending_lag_seconds``
gauge fresh through an obs collector while rows wait unpublished. Lag
crossing the SLO emits a ``freshness_breach`` event in both directions,
mirroring ``slo_breach``.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional

_DEF_TARGET = 0.99
_DEF_WINDOW = 1024


class SLOTracker:
    """Thread-safe rolling-window SLO attainment tracker (one per process)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slo_s = 0.0
        self._target = _DEF_TARGET
        self._window = _DEF_WINDOW
        self._models: Dict[str, Dict[str, Any]] = {}

    def configure(self, slo_ms: Optional[float] = None,
                  target: Optional[float] = None,
                  window: Optional[int] = None) -> None:
        """Apply the serve_slo_* knobs; a window-size change drops history
        (the old samples would misweight the new window)."""
        with self._lock:
            if slo_ms is not None:
                self._slo_s = float(slo_ms) / 1e3
            if target is not None:
                self._target = float(target)
            if window is not None:
                w = max(1, int(window))
                if w != self._window:
                    self._window = w
                    self._models.clear()

    @property
    def active(self) -> bool:
        with self._lock:
            return self._slo_s > 0.0

    def observe(self, model: str, latency_s: float) -> None:
        """Record one completed request's end-to-end latency."""
        from . import METRICS, emit
        with self._lock:
            if self._slo_s <= 0.0:
                return
            st = self._models.get(model)
            if st is None:
                st = {"window": collections.deque(maxlen=self._window),
                      "requests": 0, "violations": 0, "breached": False}
                self._models[model] = st
            ok = float(latency_s) <= self._slo_s
            st["window"].append(ok)
            st["requests"] += 1
            if not ok:
                st["violations"] += 1
            att = sum(st["window"]) / len(st["window"])
            target = self._target
            burn = (1.0 - att) / max(1e-12, 1.0 - target)
            breached = att < target
            flipped = breached != st["breached"]
            st["breached"] = breached
        METRICS.gauge("slo_attainment",
                      "fraction of windowed requests within the latency SLO",
                      model=model).set(att)
        METRICS.gauge("slo_burn_rate",
                      "error-budget burn rate: (1-attainment)/(1-target)",
                      model=model).set(burn)
        METRICS.counter("slo_requests", "requests observed by the SLO tracker",
                        model=model).inc()
        if not ok:
            METRICS.counter("slo_violations", "requests over the latency SLO",
                            model=model).inc()
        if flipped:
            emit("slo_breach", model=model, attainment=att, target=target,
                 burn_rate=burn, recovered=not breached)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-model SLO state for ``!stats`` / ``/statusz`` ({} when off)."""
        with self._lock:
            if self._slo_s <= 0.0:
                return {}
            out: Dict[str, Dict[str, Any]] = {}
            for model, st in self._models.items():
                win = st["window"]
                att = (sum(win) / len(win)) if win else 1.0
                out[model] = {
                    "slo_ms": self._slo_s * 1e3,
                    "target": self._target,
                    "window": len(win),
                    "attainment": att,
                    "burn_rate": (1.0 - att) / max(1e-12, 1.0 - self._target),
                    "requests": st["requests"],
                    "violations": st["violations"],
                    "breached": st["breached"],
                }
            return out

    def reset(self) -> None:
        """Back to the unconfigured default (per-run isolation in tests)."""
        with self._lock:
            self._models.clear()
            self._slo_s = 0.0
            self._target = _DEF_TARGET
            self._window = _DEF_WINDOW


class FreshnessTracker:
    """Feed->publish freshness SLO for continuous training (one per
    process). Inactive (``online_freshness_slo_s=0``) it records nothing."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slo_s = 0.0
        self._models: Dict[str, Dict[str, Any]] = {}

    def configure(self, slo_s: Optional[float] = None) -> None:
        with self._lock:
            if slo_s is not None:
                self._slo_s = float(slo_s)

    @property
    def active(self) -> bool:
        with self._lock:
            return self._slo_s > 0.0

    def observe_cycle(self, model: str, lag_s: float, rows: int = 0) -> None:
        """Record one published refit cycle's freshness: the age of the
        oldest row the cycle trained, measured feed -> publish."""
        from . import METRICS, emit
        with self._lock:
            slo = self._slo_s
            if slo <= 0.0:
                return
            st = self._models.get(model)
            if st is None:
                st = {"cycles": 0, "breaches": 0, "breached": False,
                      "last_lag_s": 0.0, "max_lag_s": 0.0}
                self._models[model] = st
            st["cycles"] += 1
            st["last_lag_s"] = float(lag_s)
            st["max_lag_s"] = max(st["max_lag_s"], float(lag_s))
            breached = float(lag_s) > slo
            if breached:
                st["breaches"] += 1
            flipped = breached != st["breached"]
            st["breached"] = breached
            max_lag = st["max_lag_s"]
        METRICS.gauge("refit_lag_seconds",
                      "feed->publish lag of the last refit cycle's oldest row",
                      model=model).set(float(lag_s))
        METRICS.gauge("refit_lag_max_seconds",
                      "worst feed->publish refit lag observed",
                      model=model).set(max_lag)
        METRICS.counter("refit_cycles",
                        "refit cycles observed by the freshness tracker",
                        model=model).inc()
        if breached:
            METRICS.counter("freshness_violations",
                            "refit cycles over the freshness SLO",
                            model=model).inc()
        if flipped:
            emit("freshness_breach", model=model, lag_s=float(lag_s),
                 slo_s=slo, recovered=not breached, rows=int(rows))

    def note_pending(self, model: str, lag_s: float) -> None:
        """Refresh the live gauge: age of the oldest row still waiting for a
        publish (0 when nothing pends). Driven by the trainer's collector,
        so it is scrape-time fresh without touching the feed hot path."""
        from . import METRICS
        with self._lock:
            if self._slo_s <= 0.0:
                return
        METRICS.gauge("refit_pending_lag_seconds",
                      "age of the oldest buffered row not yet published",
                      model=model).set(float(lag_s))

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-model freshness state for ``/statusz`` ({} when off)."""
        with self._lock:
            if self._slo_s <= 0.0:
                return {}
            return {m: dict(st, slo_s=self._slo_s)
                    for m, st in self._models.items()}

    def reset(self) -> None:
        with self._lock:
            self._models.clear()
            self._slo_s = 0.0


TRACKER = SLOTracker()
FRESHNESS = FreshnessTracker()
