"""Crash flight recorder: a bounded ring of recent events + serve spans.

Port of ``lightgbm_tpu/obs/flight.py`` (host code, copied). Every
postmortem should start with the tail of telemetry instead of nothing.
``obs.emit`` mirrors each event into the ring; the serve path additionally
notes per-request span chains.  The ring is dumped (crash-safely, through
``utils.atomic_io``) when something goes wrong:

    device_fault / nonfinite_guard events   automatic trip (debounced)
    unhandled exception / SIGTERM           via :func:`install_crash_hooks`
    explicit ``FLIGHT.dump(reason)``        operator/tooling request

Disabled by default: without a dump directory (``flight_dir`` falling back
to ``metrics_out``) or with ``flight_events=0`` nothing is recorded and
``dump`` returns None.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, Optional

from ..utils import atomic_io
from .events import _json_default

# event types whose mere occurrence dumps the ring: device faults, the
# nonfinite guard, a failed continuous-training refit cycle, a feed WAL
# degraded by a full disk, and the unlabeled drift detector firing (the
# trainer keeps serving last-good — the dump is the postmortem trail)
TRIP_EVENTS = ("device_fault", "nonfinite_guard", "online_cycle_failed",
               "wal_degraded", "drift_unlabeled")
_DEF_CAPACITY = 512
_TRIP_DEBOUNCE_S = 1.0


class FlightRecorder:
    """Thread-safe bounded ring of telemetry records (one per process)."""

    def __init__(self, capacity: int = _DEF_CAPACITY) -> None:
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._dir = ""
        self._seq = 0
        self._last_trip = 0.0
        # lock-free fast-path flag read by obs.emit on every event; only
        # configure/reset (rare) write it, and a stale read is benign
        self.active = False

    def configure(self, out_dir: Optional[str] = None,
                  capacity: Optional[int] = None) -> None:
        with self._lock:
            if out_dir is not None:
                self._dir = str(out_dir)
            if capacity is not None and int(capacity) != self._ring.maxlen:
                self._ring = collections.deque(self._ring,
                                               maxlen=max(0, int(capacity)))
            self.active = bool(self._dir) and (self._ring.maxlen or 0) > 0
        if self.active:
            install_crash_hooks()

    def enabled(self) -> bool:
        with self._lock:
            return bool(self._dir) and (self._ring.maxlen or 0) > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def note_event(self, etype: str, fields: Dict[str, Any]) -> None:
        """Mirror one (already schema-validated) event into the ring."""
        with self._lock:
            if (self._ring.maxlen or 0) <= 0:
                return
            rec = {"kind": "event", "ts": time.time(), "type": etype}
            rec.update(fields)
            self._ring.append(rec)
        if etype in TRIP_EVENTS:
            now = time.time()
            with self._lock:
                if now - self._last_trip < _TRIP_DEBOUNCE_S:
                    return
                self._last_trip = now
            err = fields.get("error")
            self.dump(reason=etype, error=str(err) if err is not None else None)

    def note_span(self, span: Dict[str, Any]) -> None:
        """Record one request's span breakdown (serve path)."""
        with self._lock:
            if (self._ring.maxlen or 0) <= 0:
                return
            rec = {"kind": "span", "ts": time.time()}
            rec.update(span)
            self._ring.append(rec)

    def dump(self, reason: str, error: Optional[str] = None) -> Optional[str]:
        """Atomically write the ring as ``flight_<seq>_<reason>.json`` into
        the configured directory; returns the path, or None when disabled."""
        now = time.time()
        with self._lock:
            if not self._dir or (self._ring.maxlen or 0) <= 0:
                return None
            records = list(self._ring)
            self._seq += 1
            seq = self._seq
            out_dir = self._dir
        n_events = sum(1 for r in records if r.get("kind") == "event")
        n_spans = sum(1 for r in records if r.get("kind") == "span")
        path = os.path.join(out_dir, f"flight_{seq:04d}_{reason}.json")
        doc = {"reason": reason, "ts": now, "error": error,
               "events": n_events, "spans": n_spans, "records": records}
        try:
            atomic_io.atomic_write_text(
                path, json.dumps(doc, sort_keys=True,
                                 default=_json_default) + "\n")
        except OSError:
            return None
        from . import emit
        if error is None:
            emit("flight_dump", reason=reason, events=n_events,
                 spans=n_spans, path=path)
        else:
            emit("flight_dump", reason=reason, events=n_events,
                 spans=n_spans, path=path, error=error)
        return path

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def reset(self) -> None:
        """Back to the unconfigured default (per-run isolation in tests)."""
        with self._lock:
            self._ring.clear()
            self._dir = ""
            self._seq = 0
            self._last_trip = 0.0
            self.active = False


_hooks_lock = threading.Lock()
_hooks_installed = False


def install_crash_hooks() -> None:
    """Chain a ``sys.excepthook`` and a SIGTERM handler that dump the ring
    before the previous handler runs.  Installed at most once per process;
    the SIGTERM half is skipped off the main thread (signal module rules)."""
    global _hooks_installed
    with _hooks_lock:
        if _hooks_installed:
            return
        _hooks_installed = True
    prev_hook = sys.excepthook

    def _excepthook(tp, val, tb):
        try:
            FLIGHT.dump("unhandled_exception", error=f"{tp.__name__}: {val}")
        except Exception:
            pass
        prev_hook(tp, val, tb)

    sys.excepthook = _excepthook
    try:
        prev_sig = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            try:
                FLIGHT.dump("sigterm")
            except Exception:
                pass
            if callable(prev_sig):
                prev_sig(signum, frame)
            else:
                sys.exit(143)

        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread: excepthook alone still covers crashes


FLIGHT = FlightRecorder()
