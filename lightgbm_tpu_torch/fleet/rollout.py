"""RolloutManager: canary/shadow deployment with auto-promote/rollback.

Port of ``lightgbm_tpu/fleet/rollout.py`` (host code, copied). An online
trainer's publish enters through ``submit_candidate`` when
``canary_fraction > 0``; ``start`` takes a Booster or a model file.

Online-trained models (online.py) used to hot-swap straight into the live
registry — correct but trusting. The rollout manager inserts a judgement
window: a candidate version is published under a *shadow name*
(``<model>@canary``) in the same registry, traffic is split or duplicated,
and the two prediction distributions are compared continuously
(:class:`~.drift.StreamingComparator`, PSI + KS):

- **canary mode** (``canary_fraction`` of requests get the candidate's
  *response*): real exposure, bounded blast radius.
- **shadow mode** (``canary_shadow=1``): every sampled request is served by
  the incumbent AND duplicated to the candidate; the candidate's responses
  are compared, never returned — zero user exposure.

Transitions are automatic: PSI above ``canary_psi_max`` (or KS above
``canary_ks_max`` when set) at/after ``canary_min_samples`` triggers
**rollback**; a drift-free ``canary_window_s`` triggers **promote**. Both
are also available manually (``!promote`` / ``!rollback``; C API). Every
transition emits a schema-registered obs event (which the flight recorder
notes as a breadcrumb automatically) plus an explicit flight span record
carrying the comparator state.

Promotion re-uses the candidate's already-warmed engine: the ServedModel's
engine ownership is handed to the promoted registry entry
(``owns_engine=False`` on the retiring shadow entry), so promote is an
atomic pointer swap — no rebuild, no re-warm, no new upload. Rollback
retires the shadow entry through the registry's normal refcount drain: an
in-flight flush on the candidate finishes and only then are its device
tables freed (tests/test_fleet.py pins this edge).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import log, obs
from ..log import LightGBMError
from ..obs import flight
from .drift import CANDIDATE, INCUMBENT, StreamingComparator

IDLE = "idle"
CANARY = "canary"
SHADOW = "shadow"

# evaluate PSI/KS every N candidate observations (keeps the numpy work off
# the per-request path; the windows are bounded so each eval is tiny)
_EVAL_EVERY = 16


def canary_name(name: str) -> str:
    return f"{name}@canary"


class ServerBackend:
    """RolloutManager backend over one PredictServer (registry + batcher)."""

    def __init__(self, server):
        self.server = server

    def publish_candidate(self, model, cname: str) -> int:
        from ..basic import Booster
        if isinstance(model, (str, bytes)):
            model = Booster(model_file=model)
        sm = self.server.registry.publish(
            cname, model, warmup_sizes=self.server._warmup_sizes())
        return sm.version

    def promote(self, name: str, cname: str) -> int:
        return promote_version(self.server.registry, name, cname)

    def drop(self, cname: str) -> None:
        self.server.registry.unpublish(cname)

    def submit(self, x, **kw):
        return self.server.batcher.submit_async(x, **kw)

    def current_version(self, name: str) -> int:
        try:
            return self.server.registry.current(name).version
        except KeyError:
            return 0


def promote_version(registry, name: str, cname: str) -> int:
    """Make ``cname``'s engine the next version of ``name`` without a
    rebuild: hand engine ownership to the new entry, then retire the shadow
    entry (drains in-flight canary flushes; does NOT free the engine)."""
    sm = registry.current(cname)
    sm.owns_engine = False
    promoted = registry.publish(name, engine=sm.engine)
    registry.unpublish(cname)
    return promoted.version


class RolloutManager:
    """Canary/shadow state machine over a backend (server or fleet pool)."""

    def __init__(self, backend, conf, name: str = "default",
                 clock=time.monotonic):
        self.backend = backend
        self.name = name
        self.cname = canary_name(name)
        self.clock = clock
        self.fraction = float(getattr(conf, "canary_fraction", 0.1) or 0.1)
        self.window_s = float(getattr(conf, "canary_window_s", 30.0))
        self.psi_max = float(getattr(conf, "canary_psi_max", 0.25))
        self.ks_max = float(getattr(conf, "canary_ks_max", 0.0))
        self.min_samples = int(getattr(conf, "canary_min_samples", 200))
        self.shadow_default = bool(getattr(conf, "canary_shadow", False))
        self.cmp_window = int(getattr(conf, "canary_cmp_window", 512))
        # transitions + routing decisions share one reentrant lock: an
        # on_done tap (scheduler thread) may trip rollback while the submit
        # path routes, and rollback touches the registry, which has its own
        # lock — the order here is always rollout -> registry, never back
        self._lock = threading.RLock()
        self.state = IDLE
        self.comparator: Optional[StreamingComparator] = None
        self.candidate_version = 0
        self.incumbent_version = 0
        self._clean_since: Optional[float] = None
        self._route_n = 0
        self._evals = 0
        self.stats = {"started": 0, "promoted": 0, "rolled_back": 0,
                      "routed_candidate": 0, "routed_incumbent": 0,
                      "shadow_dropped": 0}
        self.history: List[Dict] = []

    # ---- lifecycle ----

    @property
    def active(self) -> bool:
        return self.state != IDLE

    @property
    def auto_candidates(self) -> bool:
        """Online publishes become canaries (canary_fraction > 0 config)."""
        return True

    def start(self, candidate, fraction: Optional[float] = None,
              shadow: Optional[bool] = None) -> int:
        """Publish ``candidate`` under the shadow name and start comparing.
        An already-running rollout is superseded: the old candidate rolls
        back first (reason="superseded"), then the new one starts."""
        with self._lock:
            if self.active:
                self._transition_rollback("superseded")
            fraction = self.fraction if fraction is None else float(fraction)
            if not 0.0 < fraction <= 1.0:
                raise ValueError(f"canary fraction must be in (0, 1], "
                                 f"got {fraction}")
            shadow = self.shadow_default if shadow is None else bool(shadow)
            version = self.backend.publish_candidate(candidate, self.cname)
            self.candidate_version = int(version)
            self.incumbent_version = int(
                self.backend.current_version(self.name))
            self.comparator = StreamingComparator(window=self.cmp_window)
            self.state = SHADOW if shadow else CANARY
            self._active_fraction = fraction
            self._clean_since = None
            self._route_n = 0
            self.stats["started"] += 1
        obs.emit("canary_start", model=self.name, version=int(version),
                 mode=self.state, fraction=fraction,
                 incumbent_version=self.incumbent_version)
        log.info(f"canary start: {self.name} v{version} "
                 f"({self.state}, fraction={fraction})")
        return int(version)

    def submit_candidate(self, booster) -> int:
        """Online-trainer publish hook: new candidates enter through the
        canary gate instead of hot-swapping into live traffic."""
        return self.start(booster)

    # ---- request path ----

    def submit(self, x, model: str = "default", raw_score: bool = False,
               pred_leaf: bool = False, on_done=None):
        """Route one request through the rollout: canary mode sends the
        configured fraction to the candidate; shadow mode serves the
        incumbent and duplicates the sampled fraction to the candidate
        (responses discarded). pred_leaf and foreign models bypass."""
        with self._lock:
            state = self.state
            if model != self.name or pred_leaf or state == IDLE:
                target, tap, dup = model, None, False
            else:
                self._route_n += 1
                sampled = self._sampled(self._route_n)
                if state == CANARY and sampled:
                    target, tap, dup = self.cname, CANDIDATE, False
                else:
                    target, tap, dup = model, INCUMBENT, sampled
                self.stats["routed_candidate" if target == self.cname
                           else "routed_incumbent"] += 1
        cb = on_done if tap is None else self._tap_cb(tap, on_done)
        req = self.backend.submit(x, model=target, raw_score=raw_score,
                                  pred_leaf=pred_leaf, on_done=cb)
        if dup and state == SHADOW:
            # shadow duplicate: best effort — an overloaded queue (or a
            # rollback that just unpublished the candidate) drops the
            # shadow, never the user's request
            try:
                self.backend.submit(x, model=self.cname, raw_score=raw_score,
                                    pred_leaf=False,
                                    on_done=self._tap_cb(CANDIDATE, None))
            except (KeyError, LightGBMError):
                with self._lock:
                    self.stats["shadow_dropped"] += 1
        return req

    def _sampled(self, n: int) -> bool:
        """Deterministic fraction sampling: request n is sampled when the
        running expectation crosses an integer (no RNG, test-stable)."""
        f = self._active_fraction
        return int(n * f) != int((n - 1) * f)

    def _tap_cb(self, side: str, chained):
        def _tap(req):
            if chained is not None:
                chained(req)
            if req.exc is None and req.out is not None:
                self.observe(side, req.out)
        return _tap

    # ---- comparison + transitions ----

    def observe(self, side: str, scores) -> None:
        """Feed scores into the comparator; evaluate every _EVAL_EVERY
        candidate batches (the scheduler thread lands here via on_done)."""
        with self._lock:
            cmpr = self.comparator
            if cmpr is None or self.state == IDLE:
                return
            cmpr.observe(side, np.asarray(scores))
            if side != CANDIDATE:
                return
            self._evals += 1
            run_eval = self._evals % _EVAL_EVERY == 0
        if run_eval:
            self.tick()

    def tick(self) -> str:
        """Evaluate the comparator and fire any due transition; returns the
        (possibly new) state. Safe to call from anywhere, any time."""
        with self._lock:
            if self.state == IDLE or self.comparator is None:
                return self.state
            n_ref, n_cand = self.comparator.counts()
            if min(n_ref, n_cand) < self.min_samples:
                return self.state
            psi = self.comparator.psi()
            ks = self.comparator.ks()
            now = self.clock()
            diverged = psi > self.psi_max or \
                (self.ks_max > 0.0 and ks > self.ks_max)
            if diverged:
                self._transition_rollback(
                    f"psi={psi:.4f}" if psi > self.psi_max
                    else f"ks={ks:.4f}", psi=psi, ks=ks)
            elif self._clean_since is None:
                self._clean_since = now
            elif now - self._clean_since >= self.window_s:
                self._transition_promote("drift_free_window", psi=psi, ks=ks)
            return self.state

    def promote(self, reason: str = "manual") -> int:
        """Promote the candidate now; returns the new live version."""
        with self._lock:
            if not self.active:
                raise LightGBMError("no active canary to promote")
            cmpr = self.comparator
            return self._transition_promote(
                reason, psi=cmpr.psi() if cmpr else 0.0,
                ks=cmpr.ks() if cmpr else 0.0)

    def rollback(self, reason: str = "manual") -> int:
        """Roll the candidate back now; returns the incumbent version."""
        with self._lock:
            if not self.active:
                raise LightGBMError("no active canary to roll back")
            self._transition_rollback(reason)
            return self.incumbent_version

    def _transition_promote(self, reason: str, psi: float = 0.0,
                            ks: float = 0.0) -> int:
        """(holding self._lock) candidate -> live via engine handoff."""
        cmpr = self.comparator
        samples = cmpr.counts()[1] if cmpr else 0
        clean_s = (self.clock() - self._clean_since) \
            if self._clean_since is not None else 0.0
        version = int(self.backend.promote(self.name, self.cname))
        self.stats["promoted"] += 1
        self._reset_locked()
        obs.emit("canary_promote", model=self.name, version=version,
                 reason=reason, psi=float(psi), ks=float(ks),
                 samples=int(samples), clean_s=float(clean_s))
        flight.FLIGHT.note_span({"what": "canary_promote", "model": self.name,
                                 "version": version, "reason": reason,
                                 "psi": float(psi), "ks": float(ks)})
        self.history.append({"event": "promote", "version": version,
                             "reason": reason, "psi": round(psi, 6)})
        log.info(f"canary promote: {self.name} v{version} ({reason})")
        return version

    def _transition_rollback(self, reason: str, psi: float = 0.0,
                             ks: float = 0.0) -> None:
        """(holding self._lock) drop the candidate; incumbent keeps serving.
        The shadow entry drains through the registry refcount — an in-flight
        candidate flush completes before its engine is freed."""
        cmpr = self.comparator
        samples = cmpr.counts()[1] if cmpr else 0
        version = self.candidate_version
        self.backend.drop(self.cname)
        self.stats["rolled_back"] += 1
        self._reset_locked()
        obs.emit("canary_rollback", model=self.name, version=int(version),
                 reason=reason, psi=float(psi), ks=float(ks),
                 samples=int(samples))
        flight.FLIGHT.note_span({"what": "canary_rollback",
                                 "model": self.name, "version": int(version),
                                 "reason": reason, "psi": float(psi),
                                 "ks": float(ks)})
        self.history.append({"event": "rollback", "version": int(version),
                             "reason": reason, "psi": round(psi, 6)})
        log.warning(f"canary rollback: {self.name} v{version} ({reason})")

    def _reset_locked(self) -> None:
        self.state = IDLE
        self.comparator = None
        self.candidate_version = 0
        self._clean_since = None
        self._evals = 0

    # ---- introspection ----

    def statusz(self) -> Dict:
        with self._lock:
            out = {"state": self.state, "model": self.name,
                   "candidate_version": self.candidate_version,
                   "incumbent_version": self.incumbent_version,
                   "thresholds": {"psi_max": self.psi_max,
                                  "ks_max": self.ks_max,
                                  "window_s": self.window_s,
                                  "min_samples": self.min_samples},
                   "stats": dict(self.stats),
                   "history": list(self.history[-8:])}
            cmpr = self.comparator
        if cmpr is not None:
            out["comparator"] = cmpr.snapshot()
        return out

    snapshot = statusz
