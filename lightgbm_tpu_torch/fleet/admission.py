"""Admission control: per-model latency SLO budgets on the serve ingress.

Port of ``lightgbm_tpu/fleet/admission.py`` (host code, copied).

The bounded staging queue (server.py) sheds only when the queue is
physically full — by which point every queued request is already paying the
backlog's latency. This controller sheds *earlier and smarter*: it watches
the per-model error-budget **burn rate** from the SLO tracker (obs/slo.py —
burn 1.0 = spending budget exactly as fast as the target allows) and moves
each model through three states:

    admit    burn below ``admission_burn_degrade`` — normal service
    degrade  budget burning: cap coalesced flushes at
             ``serve_degraded_batch_rows`` (a smaller power-of-two bucket =
             a shorter dispatch = lower per-request latency, at some
             throughput cost) and drop the coalescing window
    shed     burn at/above ``admission_burn_shed`` — the budget is gone;
             reject at ingress with ServeOverload so the backlog never
             forms (clients back off; the window drains; state recovers)

``decide`` sits on the submit fast path, so it reads a cached state dict
refreshed from the tracker at most every ``ttl_s`` — the cost per request
is one clock read and one dict lookup. With no SLO configured the
controller admits everything (state "admit", zero overhead).

Shed is self-healing by construction: the tracker's window only refreshes
from COMPLETED requests, so a shed that rejected everything would starve
itself of the very samples that could clear it and latch forever. While a
model is shed, one request in every ``_PROBE_EVERY`` is admitted as a
probe — under genuine overload the probes measure bad latencies and the
shed holds; once load drops they measure good ones and the state walks
back through degrade to admit.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .. import obs
from ..obs import slo

ADMIT = "admit"
DEGRADE = "degrade"
SHED = "shed"

# while shed, admit every Nth request as a probe so the SLO window keeps
# refreshing and the state can recover (see module docstring)
_PROBE_EVERY = 16


class AdmissionController:
    """SLO-budget admission states per model, off the slo.TRACKER burn rate."""

    def __init__(self, burn_degrade: float = 1.5, burn_shed: float = 3.0,
                 batch_cap: int = 8, ttl_s: float = 0.05, tracker=None):
        if not 0.0 < burn_degrade <= burn_shed:
            raise ValueError("need 0 < admission_burn_degrade <= "
                             "admission_burn_shed")
        if batch_cap < 1:
            raise ValueError("serve_degraded_batch_rows must be >= 1")
        self.burn_degrade = float(burn_degrade)
        self.burn_shed = float(burn_shed)
        self._batch_cap = int(batch_cap)
        self.ttl_s = float(ttl_s)
        self.tracker = tracker if tracker is not None else slo.TRACKER
        self._lock = threading.Lock()
        self._state: Dict[str, str] = {}
        self._burn: Dict[str, float] = {}
        self._shed_n: Dict[str, int] = {}
        self._next_refresh = 0.0
        self.stats = {"sheds": 0, "degraded_flushes": 0, "refreshes": 0,
                      "probes": 0}

    @classmethod
    def from_config(cls, conf) -> Optional["AdmissionController"]:
        """Build per the ``serve_admission`` / ``admission_burn_*`` knobs;
        None when admission control is off."""
        if not getattr(conf, "serve_admission", True):
            return None
        return cls(burn_degrade=conf.admission_burn_degrade,
                   burn_shed=conf.admission_burn_shed,
                   batch_cap=conf.serve_degraded_batch_rows)

    # ---- ingress fast path ----

    def decide(self, model: str) -> str:
        """Admission state for ``model`` right now: admit/degrade/shed."""
        if not self.tracker.active:
            return ADMIT
        now = time.monotonic()
        transitions = ()
        with self._lock:
            if now >= self._next_refresh:
                transitions = self._refresh_locked(now)
            state = self._state.get(model, ADMIT)
            if state == SHED:
                n = self._shed_n.get(model, 0) + 1
                self._shed_n[model] = n
                if n % _PROBE_EVERY == 0:
                    self.stats["probes"] += 1
                    state = ADMIT       # recovery probe: let one through
        # telemetry for state flips happens after the lock drops: the obs
        # plane takes its own locks and the ingress path must never hold
        # the admission lock across them
        for tmodel, tstate, burn, attain in transitions:
            obs.emit("admission_state", model=tmodel, state=tstate,
                     burn_rate=burn, attainment=attain)
            if obs.enabled():
                obs.METRICS.gauge(
                    "admission_state",
                    "SLO admission state (0 admit / 1 degrade / 2 shed)",
                    model=tmodel).set({ADMIT: 0, DEGRADE: 1, SHED: 2}[tstate])
        return state

    def batch_cap(self, model: str) -> Optional[int]:
        """Coalesced-flush row cap while ``model`` is degraded, else None."""
        with self._lock:
            if self._state.get(model) != DEGRADE:
                return None
            self.stats["degraded_flushes"] += 1
            return self._batch_cap

    def note_shed(self, model: str) -> float:
        """Record one admission shed; returns the model's burn rate."""
        with self._lock:
            self.stats["sheds"] += 1
            burn = self._burn.get(model, 0.0)
        obs.emit("admission_shed", model=model, burn_rate=burn)
        if obs.enabled():
            obs.METRICS.counter("admission_sheds",
                                "requests shed by SLO admission control",
                                model=model).inc()
        return burn

    # ---- tracker refresh (holding self._lock) ----

    def _refresh_locked(self, now: float):
        """Recompute every model's state from a fresh tracker snapshot;
        returns the (model, state, burn, attainment) transitions for the
        caller to emit once the lock is dropped."""
        self._next_refresh = now + self.ttl_s
        self.stats["refreshes"] += 1
        snap = self.tracker.snapshot()
        transitions = []
        for model, info in snap.items():
            burn = float(info.get("burn_rate", 0.0))
            attain = float(info.get("attainment", 1.0))
            if burn >= self.burn_shed:
                state = SHED
            elif burn >= self.burn_degrade:
                state = DEGRADE
            else:
                state = ADMIT
            self._burn[model] = burn
            prev = self._state.get(model, ADMIT)
            if state != prev:
                self._state[model] = state
                transitions.append((model, state, burn, attain))
        return transitions

    def snapshot(self) -> Dict:
        with self._lock:
            return {"states": dict(self._state), "burn": dict(self._burn),
                    "thresholds": {"degrade": self.burn_degrade,
                                   "shed": self.burn_shed,
                                   "batch_cap": self._batch_cap},
                    "stats": dict(self.stats)}
