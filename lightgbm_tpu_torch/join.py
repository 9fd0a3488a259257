"""Delayed-label join buffer: features now, labels later, training only on
the joined rows.

Port of ``lightgbm_tpu/join.py`` (host code; numpy only).

A production feed never hands the trainer ``(X, y)`` pairs: features are
known at serve time, the label (click, conversion, chargeback) arrives
minutes later — or never. :class:`JoinBuffer` is the stateful middle:

- :meth:`capture` files the served feature row-set under its request id and
  makes it durable as a WAL FEAT record *before* the server replies, so a
  crash between capture and label arrival loses nothing;
- :meth:`label` joins an arriving label against the pending entry and feeds
  the completed ``(X, y)`` row through the trainer's normal ``feed()`` path
  — the WAL batch record carries the rid, sealing the join atomically with
  the batch append, so recovery never double-trains a joined row and a
  producer re-sending the same label after a crash deduplicates on the
  derived ``join:<rid>`` batch id;
- :meth:`sweep` expires orphans whose label never arrived within
  ``timeout_s`` into counted, ``join_expired``-emitting drops (never
  silent) with a WAL EXPIRE tombstone so they stay dead across restarts;
- :meth:`rebuild` reconstructs the pending set from the WAL's stub rows on
  restart — payloads stay on disk and are read back lazily at join time,
  so recovery memory is bounded by the stub count, not the byte volume.

Memory for pending payloads is bounded by ``max_pending``: past it, the
oldest resident entries spill their in-memory arrays (FIFO) and keep only
the WAL offset stub — :meth:`label` reads the bytes back from the log.
Without a WAL to spill into (or while the log is degraded on a full disk),
overflow drops the oldest entries outright, counted and event-emitting.

Locking: ``_lock`` guards every counter and the pending map, and is NEVER
held across the trainer feed, a WAL append, or an obs emit — a synchronous
refit cycle inside ``feed()`` must not block concurrent captures.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import obs
from .utils import faults
from .wal import FeedLog, WalUnavailable


class _Pending:
    """One captured-not-yet-labeled row-set. ``X is None`` means the
    payload was spilled to (or only ever lived in) the WAL."""

    __slots__ = ("X", "rows", "cols", "ts", "durable")

    def __init__(self, X: Optional[np.ndarray], rows: int, cols: int,
                 ts: float, durable: bool):
        self.X = X
        self.rows = rows
        self.cols = cols
        self.ts = ts
        self.durable = durable


class JoinBuffer:
    """Request-id keyed feature buffer for one trainer (see module doc)."""

    # opportunistic sweep cadence: capture/label piggyback an expiry pass
    # at most this often (the trainer group's sweep loop covers idle gaps)
    SWEEP_EVERY_S = 1.0

    def __init__(self, feed_fn: Callable[..., Optional[int]],
                 wal: Optional[FeedLog] = None, timeout_s: float = 300.0,
                 max_pending: int = 100000, name: str = "default"):
        self._feed = feed_fn          # feed_fn(rid, X, y, w) -> version
        self.wal = wal
        self.timeout_s = float(timeout_s or 0.0)
        self.max_pending = int(max_pending or 0)
        self.name = str(name)
        self._lock = threading.Lock()
        self._pending: Dict[str, _Pending] = {}   # insertion-ordered FIFO
        self._order: deque = deque()   # spill/drop scan order (lazy-stale)
        self._resident = 0             # entries whose payload is in memory
        self._last_sweep = 0.0
        self.captured = 0
        self.joined = 0
        self.expired = 0
        self.unmatched = 0
        self.duplicates = 0
        self.spilled = 0
        self.recovered = 0

    @staticmethod
    def batch_id_for(rid: str) -> str:
        """The WAL batch id a joined rid trains under — stable across
        restarts, so a re-sent label deduplicates like any batch."""
        return f"join:{rid}"

    # ---- capture (serve-time ingress) ----
    def capture(self, rid: str, X: Any, ts: Optional[float] = None) -> int:
        """File served features under ``rid``; returns the pending count.
        Duplicate captures (same rid pending, or already joined) are
        counted and ignored — the first capture wins."""
        rid = str(rid)
        Xc = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        if Xc.ndim == 1:
            Xc = Xc.reshape(1, -1)
        now = float(time.time() if ts is None else ts)
        if self.wal is not None and self.wal.seen(self.batch_id_for(rid)):
            with self._lock:
                self.duplicates += 1
                return len(self._pending)
        with self._lock:
            if rid in self._pending:
                self.duplicates += 1
                return len(self._pending)
            self._pending[rid] = _Pending(Xc, int(Xc.shape[0]),
                                          int(Xc.shape[1]), now,
                                          durable=False)
            self._order.append(rid)
            self._resident += 1
            self.captured += 1
        if self.wal is not None:
            try:
                self.wal.append_feature(rid, Xc, ts=now)
                with self._lock:
                    ent = self._pending.get(rid)
                    if ent is not None:
                        ent.durable = True
            except ValueError:
                # already durable under this rid (re-capture across a
                # restart raced the rebuild): keep one entry, count it
                with self._lock:
                    ent = self._pending.get(rid)
                    if ent is not None:
                        ent.durable = True
            except WalUnavailable:
                pass   # degraded log: entry stays memory-only, can't spill
        self._shed_overflow()
        self.maybe_sweep(now)
        with self._lock:
            return len(self._pending)

    def _shed_overflow(self) -> None:
        """Bound resident payload memory at ``max_pending`` entries: spill
        the oldest durable payloads to their WAL records (FIFO), or — with
        no durable copy to fall back on — drop the oldest outright."""
        if self.max_pending <= 0:
            return
        dropped: List[str] = []
        pending_after = 0
        with self._lock:
            while self._resident > self.max_pending and self._order:
                rid = self._order.popleft()
                ent = self._pending.get(rid)
                if ent is None or ent.X is None:
                    continue   # already joined/expired/spilled: stale slot
                if ent.durable:
                    ent.X = None
                    self._resident -= 1
                    self.spilled += 1
                else:
                    del self._pending[rid]
                    self._resident -= 1
                    self.expired += 1
                    dropped.append(rid)
            pending_after = len(self._pending)
        if dropped:
            if self.wal is not None:
                self.wal.append_expire(dropped)
            obs.emit("join_expired", expired=len(dropped),
                     pending=int(pending_after), model=self.name,
                     reason="overflow")

    # ---- label arrival ----
    def label(self, rid: str, y: Any,
              weight: Optional[Any] = None) -> Optional[int]:
        """Join an arriving label against the pending entry and feed the
        completed rows to the trainer. Returns the trainer feed() result
        (published version when the join triggered a sync refit), or
        ``None`` for an unmatched/duplicate/expired label — each counted,
        never silent."""
        rid = str(rid)
        with self._lock:
            ent = self._pending.pop(rid, None)
            if ent is not None and ent.X is not None:
                self._resident -= 1
        if ent is None:
            # distinguish "this label already trained" (a producer re-send
            # after a crash — idempotent) from "never saw the features"
            if self.wal is not None and \
                    self.wal.seen(self.batch_id_for(rid)):
                with self._lock:
                    self.duplicates += 1
            else:
                with self._lock:
                    self.unmatched += 1
            return None
        # the label-arrival crash window: the label is in hand, the join
        # not yet durable — recovery resurrects the pending feature and the
        # producer re-sends the label
        faults.fault_point("join_label")
        X = ent.X
        if X is None:
            X = None if self.wal is None else self.wal.read_feature(rid)
            if X is None:
                # spilled payload unreadable (rotated away / torn): the
                # orphan expires now instead of joining — counted + emitted
                with self._lock:
                    self.expired += 1
                    pending = len(self._pending)
                obs.emit("join_expired", expired=1, pending=int(pending),
                         model=self.name, reason="missing")
                return None
        yv = np.asarray(y, dtype=np.float64).reshape(-1)
        if yv.shape[0] == 1 and ent.rows > 1:
            yv = np.full(ent.rows, float(yv[0]))
        wv = None if weight is None else \
            np.asarray(weight, dtype=np.float64).reshape(-1)
        try:
            out = self._feed(rid, X, yv, wv)
        except BaseException:
            # the feed may have sealed the join durably before failing (a
            # sync cycle error after the WAL batch append): only a join
            # that is NOT yet durable goes back to pending for a retry
            if self.wal is None or \
                    not self.wal.seen(self.batch_id_for(rid)):
                with self._lock:
                    if rid not in self._pending:
                        ent.X = X
                        self._pending[rid] = ent
                        self._order.append(rid)
                        self._resident += 1
            raise
        # the join-commit crash window: the batch is durable (the WAL seals
        # the join) but the producer has not seen the ack yet — its re-sent
        # label must deduplicate, not double-train
        faults.fault_point("join_commit")
        with self._lock:
            self.joined += 1
        self.maybe_sweep()
        return out

    # ---- expiry ----
    def sweep(self, now: Optional[float] = None) -> int:
        """Expire pending entries older than ``timeout_s`` into counted,
        event-emitting drops with a WAL tombstone. Returns the count."""
        if self.timeout_s <= 0:
            return 0
        now = float(time.time() if now is None else now)
        cutoff = now - self.timeout_s
        expired: List[str] = []
        oldest_age = 0.0
        with self._lock:
            self._last_sweep = now
            for rid, ent in self._pending.items():
                if ent.ts <= cutoff:
                    expired.append(rid)
                    oldest_age = max(oldest_age, now - ent.ts)
            for rid in expired:
                ent = self._pending.pop(rid)
                if ent.X is not None:
                    self._resident -= 1
            self.expired += len(expired)
            pending = len(self._pending)
        if not expired:
            return 0
        if self.wal is not None:
            self.wal.append_expire(expired)
        obs.emit("join_expired", expired=len(expired), pending=int(pending),
                 model=self.name, oldest_age_s=float(round(oldest_age, 3)),
                 reason="timeout")
        return len(expired)

    def maybe_sweep(self, now: Optional[float] = None) -> int:
        """Throttled sweep hook for the hot capture/label paths."""
        if self.timeout_s <= 0:
            return 0
        now = float(time.time() if now is None else now)
        gap = min(self.SWEEP_EVERY_S, self.timeout_s / 4.0)
        with self._lock:
            if now - self._last_sweep < gap:
                return 0
        return self.sweep(now)

    # ---- recovery ----
    def rebuild(self) -> int:
        """Rebuild the pending set from the WAL's stub rows (restart path).
        Every rebuilt entry is payload-spilled by construction; the
        cumulative expired count carries over from the log."""
        if self.wal is None:
            return 0
        stubs = self.wal.pending_features()
        n = 0
        with self._lock:
            for s in stubs:
                rid = str(s["rid"])
                if rid in self._pending:
                    continue
                self._pending[rid] = _Pending(None, int(s["rows"]),
                                              int(s["cols"]), float(s["ts"]),
                                              durable=True)
                self._order.append(rid)
                n += 1
            self.recovered = n
            self.captured += n
            self.expired = int(self.wal.expired_total)
        return n

    # ---- introspection ----
    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> Dict[str, Any]:
        now = time.time()
        with self._lock:
            oldest = min((e.ts for e in self._pending.values()),
                         default=None)
            return {"pending": len(self._pending),
                    "resident": int(self._resident),
                    "captured": int(self.captured),
                    "joined": int(self.joined),
                    "expired": int(self.expired),
                    "unmatched": int(self.unmatched),
                    "duplicates": int(self.duplicates),
                    "spilled": int(self.spilled),
                    "recovered": int(self.recovered),
                    "oldest_pending_age_s":
                        None if oldest is None else round(now - oldest, 3),
                    "timeout_s": float(self.timeout_s),
                    "max_pending": int(self.max_pending)}
