"""Write-ahead feed log: exactly-once durability for continuous training.

Port of ``lightgbm_tpu/wal.py`` (numpy and the standard library only). The
on-disk format is the reference's byte for byte (the frame, the JSON
headers with sorted keys, the f64 payloads, the CRC32), so a log either
package wrote is scanned and recovered by the other. Besides the
reference's counters, :meth:`FeedLog.stats` reports the bytes appended and
the seconds spent in ``fsync``.

The online trainer's crash contract (docs/ONLINE.md) is that a ``kill -9``
at ANY point between ``feed()`` and the publish of the refit model loses
nothing and double-trains nothing. This module is the durable half of that
contract; ``online.OnlineTrainer`` is the replay half. Protocol:

1. every ``feed()`` batch is appended here — checksummed, monotonically
   sequence-numbered, fsync'd — BEFORE it enters the in-memory buffer, so
   an accepted batch survives the process;
2. a refit cycle that published version V writes one COMMIT record naming
   the highest batch sequence it trained (``seq_through``) and the model
   artifact saved next to the log — only AFTER the publish succeeded;
3. on restart :meth:`FeedLog.committed` rebuilds the Dataset (those rows
   are already baked into the committed model artifact — append, never
   retrain) and :meth:`FeedLog.pending` replays the unacknowledged batches
   through the normal trigger machinery. Replay order is sequence order,
   and refit is deterministic, so the recovered model is byte-identical to
   the uninterrupted run's.

Torn tails are expected, not errors: a crash mid-append leaves a partial
record at the end of the file. The recovery scan validates each record's
frame + CRC32 and truncates the file at the first bad byte — the batch that
was being appended was never acknowledged to the producer, so dropping it
is correct (the producer re-sends it, and batch-id dedup below makes that
re-send idempotent).

Producers that can re-send after a crash (the ``online_feed`` file tailer
re-reads from the start; a Kafka-style consumer re-delivers its partition)
pass a stable ``batch_id`` with each batch: ids live in the record headers,
:meth:`FeedLog.seen` answers membership, and ``feed()`` drops duplicates
before logging — the id, not the producer's delivery count, decides whether
a batch trains.

The log itself is an append-only file, NOT an atomic-replace artifact: its
crash-safety comes from the framing + truncate-on-recovery protocol above,
which is why the ``open(path, "ab")`` handles below do not route through
``utils/atomic_io`` (whole-file replace would defeat the point of a log). Model artifacts referenced by
commit records DO go through the atomic writer (``Booster.save_model``).

Two more record kinds serve the delayed-label join (``join.JoinBuffer``):
a FEAT record makes a served feature row-set durable under its pending
request id *before* any label exists, and the batch record that later joins
it carries the rid in its header — scanning a batch with a rid seals that
join, so recovery never resurrects an already-trained pending feature. An
EXPIRE record tombstones rids whose label never arrived within the join
timeout (the cumulative count survives rotation inside the ids record).
Pending FEAT frames are preserved verbatim across rotation — a crash
between capture and label arrival loses nothing, no matter how many
commits happen in between.

Appends can also fail for a reason that is NOT a crash: a full disk. With
``full_mode="degrade"`` (the ``online_wal_full`` knob) a failed
write/fsync raises :class:`WalUnavailable` instead of taking down the feed
thread — the handle is truncated back to the last fully-fsync'd frame edge
(truncation needs no free space), the trainer continues buffered-only, and
the very next append re-probes the disk and re-arms automatically when
space returns. Both transitions emit a ``wal_degraded`` flight-recorder
trip. ``full_mode="fatal"`` preserves the old raise-through behavior.

A long-running trainer must not accumulate state without bound, so a
commit also *releases* and (window mode) *rotates*:

- **release**: committed batches drop their in-memory payload arrays —
  the on-disk log is the source of truth at recovery, and every live
  reader (``seen``, ``batch_seqs``, ``stats``) only needs the
  seq/rows/id stubs. Resident payloads are bounded by the pending set.
- **rotate** (``keep_rows > 0``, i.e. the trainer runs a bounded
  ``online_max_rows`` window): once the committed prefix OUTSIDE the
  newest ``keep_rows`` committed rows itself exceeds a window, the log is
  rewritten — dropped batch records are replaced by one ids record that
  carries their batch ids forward (a producer re-send of a rotated batch
  still deduplicates), retained batch frames are copied verbatim, and
  only the latest commit record survives. The rewrite goes through
  ``utils/atomic_io`` (tmp + fsync + rename), so a crash mid-rotation
  leaves either the old log or the new one, never a torn mix. Disk and
  recovery-replay time stay O(window + pending). With ``keep_rows == 0``
  (unbounded dataset) the log is never rotated: recovery needs every
  committed row to rebuild the dataset.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from . import log, obs
from .utils import atomic_io, faults

LOG_NAME = "feed.wal"

# record frame: magic | kind | seq | header-len | payload-len | crc32 of
# (header + payload). Fixed-width little-endian so the recovery scan can
# resynchronize-by-truncation on any torn byte.
_MAGIC = b"LGWL"
_FRAME = struct.Struct("<4sBQII")
_KIND_BATCH = 1
_KIND_COMMIT = 2
# rotation tombstone: the ids (and counts) of batch records dropped by log
# rotation, carried forward so producer re-sends of rotated batches still
# deduplicate after a restart
_KIND_IDS = 3
# delayed-label join: a served feature row-set made durable under its
# pending request id before any label exists (payload = X bytes only)
_KIND_FEAT = 4
# join-timeout tombstone: rids whose label never arrived — recovery must
# not resurrect them as pending
_KIND_EXPIRE = 5


class WalUnavailable(RuntimeError):
    """An append failed (disk full) and the log degraded to buffered-only
    mode (``full_mode="degrade"``). The batch/feature was NOT made durable;
    the caller decides whether to keep it in memory anyway."""


def _encode_record(kind: int, seq: int, header: Dict[str, Any],
                   payload: bytes = b"") -> bytes:
    hb = json.dumps(header, sort_keys=True).encode("utf-8")
    body = hb + payload
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return _FRAME.pack(_MAGIC, kind, seq, len(hb), len(payload)) + \
        struct.pack("<I", crc) + body


def _scan_frames(blob: bytes):
    """Yield ``(off, end, kind, seq, header, payload)`` for every valid
    frame in ``blob``, stopping at the first torn/invalid byte (the
    truncate-on-recovery resynchronization point)."""
    off = 0
    n = len(blob)
    while off + _FRAME.size <= n:
        magic, kind, seq, hlen, plen = _FRAME.unpack_from(blob, off)
        end = off + _FRAME.size + 4 + hlen + plen
        if magic != _MAGIC or end > n:
            return
        (crc,) = struct.unpack_from("<I", blob, off + _FRAME.size)
        body = blob[off + _FRAME.size + 4:end]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            return
        try:
            header = json.loads(body[:hlen].decode("utf-8"))
        except ValueError:
            return
        yield off, end, kind, seq, header, body[hlen:]
        off = end


class WalBatch:
    """One durable feed batch, decoded back to host arrays.

    After its commit the payload arrays are released (:meth:`drop_payload`)
    and only the ``seq``/``rows``/``batch_id`` stub stays resident — the
    on-disk record keeps the bytes for recovery."""

    __slots__ = ("seq", "X", "y", "w", "batch_id", "rows")

    def __init__(self, seq: int, X: np.ndarray, y: np.ndarray,
                 w: Optional[np.ndarray], batch_id: Optional[str]):
        self.seq = seq
        self.X = X
        self.y = y
        self.w = w
        self.batch_id = batch_id
        self.rows = int(y.shape[0])

    def drop_payload(self) -> None:
        self.X = None
        self.y = None
        self.w = None

    @property
    def has_payload(self) -> bool:
        return self.y is not None


class FeedLog:
    """The write-ahead feed log for one OnlineTrainer (single writer).

    Opening scans the whole log: torn tail truncated, batches and the last
    commit recovered, next sequence number derived. All appends are fsync'd
    before returning — an ``append_batch`` that returned has survived the
    process by definition.

    ``keep_rows`` is the trainer's ``online_max_rows`` window: with it set,
    commits rotate the log so disk never holds much more than the newest
    ``keep_rows`` committed rows plus the pending batches (see the module
    docstring); 0 keeps every committed record (an unbounded dataset needs
    them all to rebuild).
    """

    def __init__(self, wal_dir: str, keep_rows: int = 0,
                 full_mode: str = "degrade"):
        self.dir = str(wal_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, LOG_NAME)
        self._lock = threading.Lock()
        self._keep_rows = int(keep_rows or 0)
        self._full_mode = str(full_mode or "degrade")
        self._batches: List[WalBatch] = []
        self._ids: set = set()
        self._rotated_ids: set = set()
        # pending-feature stubs (delayed-label join): rid -> off/rows/cols/ts
        # — payloads stay on disk, read back lazily by read_feature()
        self._feats: Dict[str, Dict[str, Any]] = {}
        self._last_commit: Optional[Dict[str, Any]] = None
        self._last_seq = 0
        self._committed_seq = 0
        self.truncated_bytes = 0
        self.appends = 0
        self.commits = 0
        self.rotations = 0
        self.rotated_batches = 0
        self.rotated_rows = 0
        self.feature_appends = 0
        self.expired_total = 0
        # disk-full degrade state (full_mode="degrade"): _good_size is the
        # byte offset of the last fully-fsync'd frame edge — the truncation
        # point that makes re-arm safe after a partial write
        self._degraded = False
        self._degrade_error = ""
        self._trip: Optional[Dict[str, Any]] = None
        self._closed = False
        self._good_size = 0
        self.degrade_count = 0
        self.skipped_appends = 0
        # bytes appended and seconds in fsync by this process
        self.bytes_appended = 0
        self.fsync_s = 0.0
        self._scan()
        # append-only log handle: crash-safety comes from the record framing
        # + truncate-on-recovery scan above, not from atomic replace — this
        # is the one durable write that MUST be an in-place append
        self._fh = open(self.path, "ab")  # tpu-lint: disable=non-atomic-artifact-write

    # ---- recovery scan ----
    def _scan(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as fh:
            blob = fh.read()
        good = 0
        n = len(blob)
        for off, end, kind, seq, header, payload in _scan_frames(blob):
            if kind == _KIND_BATCH:
                rid = header.get("rid")
                if rid is not None:
                    # a batch carrying a rid IS the join-commit marker:
                    # that pending feature is sealed, never resurrected
                    self._feats.pop(str(rid), None)
                self._ingest_batch(seq, header, payload)
            elif kind == _KIND_COMMIT:
                self._committed_seq = max(self._committed_seq, int(seq))
                self._last_commit = header
                self.commits += 1
            elif kind == _KIND_IDS:
                ids = [str(i) for i in header.get("ids", [])]
                self._rotated_ids.update(ids)
                self._ids.update(ids)
                # totals, not deltas: each rotation rewrites the one record
                self.rotated_batches = int(header.get("batches", 0))
                self.rotated_rows = int(header.get("rows", 0))
                self.expired_total = int(header.get("expired", 0))
            elif kind == _KIND_FEAT:
                self._feats[str(header["rid"])] = {
                    "off": int(off), "rows": int(header["rows"]),
                    "cols": int(header["cols"]),
                    "ts": float(header.get("ts", 0.0))}
                self.feature_appends += 1
            elif kind == _KIND_EXPIRE:
                for rid in header.get("rids", []):
                    self._feats.pop(str(rid), None)
                self.expired_total += int(header.get("n", 0))
            self._last_seq = max(self._last_seq, int(seq))
            good = end
        self._good_size = good
        if good < n:
            # torn tail from a crash mid-append: the partial record was
            # never acknowledged, so truncating it IS the recovery
            self.truncated_bytes = n - good
            with open(self.path, "r+b") as fh:
                fh.truncate(good)
            log.warning(f"feed WAL {self.path}: truncated {n - good} torn "
                        f"tail bytes (crash mid-append)")

    def _ingest_batch(self, seq: int, header: Dict[str, Any],
                      payload: bytes) -> None:
        rows = int(header["rows"])
        cols = int(header["cols"])
        xb = rows * cols * 8
        X = np.frombuffer(payload[:xb], dtype=np.float64).reshape(rows, cols)
        y = np.frombuffer(payload[xb:xb + rows * 8], dtype=np.float64)
        w = None
        if header.get("w"):
            w = np.frombuffer(payload[xb + rows * 8:xb + rows * 16],
                              dtype=np.float64)
        bid = header.get("id")
        # dedup by batch id: a duplicate record (producer re-send that raced
        # a crash) must never train twice — first occurrence wins
        if bid is not None and bid in self._ids:
            return
        if bid is not None:
            self._ids.add(bid)
        self._batches.append(WalBatch(int(seq), X.copy(), y.copy(),
                                      None if w is None else w.copy(), bid))
        self.appends += 1

    # ---- write path ----
    def _reset_handle_locked(self) -> bool:
        """Drop any poisoned buffered bytes from a failed append and line
        the handle back up on the last fully-fsync'd frame edge. Truncation
        needs no free space, so this works on a full disk."""
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        try:
            # the recovery truncate of the same append-only log: it cuts a
            # torn tail back to the last whole record
            fh = open(self.path, "ab")  # tpu-lint: disable=non-atomic-artifact-write
            fh.truncate(self._good_size)
        except OSError:
            return False
        self._fh = fh
        return True

    def _append_record(self, kind: int, seq: int, header: Dict[str, Any],
                       payload: bytes = b"") -> int:
        if self._closed:
            raise ValueError(f"append to closed feed WAL {self.path}")
        rec = _encode_record(kind, seq, header, payload)
        if self._degraded or self._fh is None:
            # re-arm probe: reset to the good frame edge, then the write
            # below IS the probe — success clears the degrade flag
            if not self._reset_handle_locked():
                self.skipped_appends += 1
                raise WalUnavailable(
                    f"feed WAL degraded ({self._degrade_error}): {self.path}")
        try:
            self._fh.write(rec)
            self._fh.flush()
            t0 = time.perf_counter()
            os.fsync(self._fh.fileno())
            self.fsync_s += time.perf_counter() - t0
        except OSError as e:
            self.skipped_appends += 1
            if self._full_mode != "degrade":
                raise
            self._degrade_error = f"{type(e).__name__}: {e}"
            if not self._degraded:
                self._degraded = True
                self.degrade_count += 1
                self._trip = {"recovered": False,
                              "error": self._degrade_error}
            # the failed write may have left partial bytes (on disk or in
            # the stale buffer): reset now so nothing torn can flush later
            self._reset_handle_locked()
            raise WalUnavailable(
                f"feed WAL append failed ({self._degrade_error}); "
                f"degraded to buffered-only: {self.path}") from e
        if self._degraded:
            self._degraded = False
            self._trip = {"recovered": True, "error": self._degrade_error}
        self._good_size += len(rec)
        self.bytes_appended += len(rec)
        return len(rec)

    def _pop_trip(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            trip, self._trip = self._trip, None
            return trip

    def _emit_degrade_transition(self) -> None:
        """Emit the wal_degraded trip recorded by a degrade/re-arm state
        change — called by public append paths AFTER releasing the lock
        (the flight recorder dump must never run under the WAL lock)."""
        trip = self._pop_trip()
        if trip is None:
            return
        obs.emit("wal_degraded", path=self.path,
                 recovered=bool(trip["recovered"]),
                 error=str(trip["error"]),
                 skipped=int(self.skipped_appends))

    def append_batch(self, X: np.ndarray, y: np.ndarray,
                     w: Optional[np.ndarray] = None,
                     batch_id: Optional[str] = None,
                     join_rid: Optional[str] = None) -> int:
        """Make one feed batch durable; returns its sequence number.
        Raises on a duplicate ``batch_id`` — callers check :meth:`seen`
        first (feed() drops duplicates silently). ``join_rid`` marks this
        batch as the join-commit of that pending feature rid: the rid rides
        in the record header and the pending stub is sealed atomically with
        the append."""
        Xc = np.ascontiguousarray(X, dtype=np.float64)
        yc = np.ascontiguousarray(y, dtype=np.float64).reshape(-1)
        wc = None if w is None else \
            np.ascontiguousarray(w, dtype=np.float64).reshape(-1)
        header = {"rows": int(Xc.shape[0]), "cols": int(Xc.shape[1]),
                  "w": wc is not None}
        if batch_id is not None:
            header["id"] = str(batch_id)
        if join_rid is not None:
            header["rid"] = str(join_rid)
        payload = Xc.tobytes() + yc.tobytes() + \
            (wc.tobytes() if wc is not None else b"")
        try:
            with self._lock:
                if batch_id is not None and batch_id in self._ids:
                    raise ValueError(f"duplicate WAL batch id {batch_id!r}")
                seq = self._last_seq + 1
                nbytes = self._append_record(_KIND_BATCH, seq, header,
                                             payload)
                self._last_seq = seq
                if batch_id is not None:
                    self._ids.add(str(batch_id))
                if join_rid is not None:
                    self._feats.pop(str(join_rid), None)
                self._batches.append(WalBatch(seq, Xc, yc, wc,
                                              None if batch_id is None
                                              else str(batch_id)))
                self.appends += 1
        finally:
            self._emit_degrade_transition()
        obs.emit("wal_append", seq=int(seq), rows=int(header["rows"]),
                 bytes=int(nbytes))
        # the post-WAL-append crash window: the batch is durable but not yet
        # buffered — the kill-and-replay drill's first injection point
        faults.fault_point("wal_append")
        return seq

    def append_feature(self, rid: str, X: np.ndarray,
                       ts: Optional[float] = None) -> int:
        """Make one served feature row-set durable under pending request id
        ``rid`` (the delayed-label join's capture half); returns its seq.
        Raises ``ValueError`` on a rid that is already pending."""
        rid = str(rid)
        Xc = np.ascontiguousarray(X, dtype=np.float64)
        if Xc.ndim == 1:
            Xc = Xc.reshape(1, -1)
        header = {"rid": rid, "rows": int(Xc.shape[0]),
                  "cols": int(Xc.shape[1]),
                  "ts": float(time.time() if ts is None else ts)}
        try:
            with self._lock:
                if rid in self._feats:
                    raise ValueError(f"duplicate pending feature {rid!r}")
                off = self._good_size
                seq = self._last_seq + 1
                self._append_record(_KIND_FEAT, seq, header, Xc.tobytes())
                self._last_seq = seq
                self._feats[rid] = {"off": int(off),
                                    "rows": int(header["rows"]),
                                    "cols": int(header["cols"]),
                                    "ts": float(header["ts"])}
                self.feature_appends += 1
        finally:
            self._emit_degrade_transition()
        # post-capture crash window: the pending feature is durable but the
        # in-memory join entry may not be — recovery rebuilds it from here
        faults.fault_point("join_capture")
        return seq

    def read_feature(self, rid: str) -> Optional[np.ndarray]:
        """Re-read a pending feature payload from disk (spilled entries
        keep only an offset stub resident). Returns ``None`` when the rid
        is not pending or the record fails validation."""
        with self._lock:
            meta = self._feats.get(str(rid))
            if meta is None:
                return None
            try:
                with open(self.path, "rb") as fh:
                    fh.seek(int(meta["off"]))
                    head = fh.read(_FRAME.size + 4)
                    if len(head) < _FRAME.size + 4:
                        return None
                    magic, kind, _seq, hlen, plen = _FRAME.unpack_from(head)
                    if magic != _MAGIC or kind != _KIND_FEAT:
                        return None
                    (crc,) = struct.unpack_from("<I", head, _FRAME.size)
                    body = fh.read(hlen + plen)
            except OSError:
                return None
            if len(body) != hlen + plen or \
                    zlib.crc32(body) & 0xFFFFFFFF != crc:
                return None
            return np.frombuffer(body[hlen:], dtype=np.float64).reshape(
                int(meta["rows"]), int(meta["cols"])).copy()

    def append_expire(self, rids: List[str]) -> None:
        """Tombstone pending rids whose join timed out: recovery must not
        resurrect them. Degraded-log expiry still drops the resident stubs
        — worst case recovery resurrects the rids and they re-expire by
        timestamp, which is counted, never silent."""
        rids = [str(r) for r in rids]
        if not rids:
            return
        try:
            with self._lock:
                seq = self._last_seq + 1
                try:
                    self._append_record(_KIND_EXPIRE, seq,
                                        {"rids": rids, "n": len(rids)})
                    self._last_seq = seq
                except WalUnavailable:
                    pass
                for rid in rids:
                    self._feats.pop(rid, None)
                self.expired_total += len(rids)
        finally:
            self._emit_degrade_transition()

    def pending_features(self) -> List[Dict[str, Any]]:
        """Stub rows (rid/ts/rows/cols — no payloads) of every pending
        feature in log order: the join buffer rebuilds from these on
        restart and reads payloads back lazily at join time, so recovery
        memory stays bounded no matter how deep the pending set is."""
        with self._lock:
            return [{"rid": rid, "ts": float(m["ts"]),
                     "rows": int(m["rows"]), "cols": int(m["cols"])}
                    for rid, m in self._feats.items()]

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def commit(self, seq_through: int, version: int,
               model: Optional[str] = None, baseline: Optional[float] = None,
               cycle: int = 0) -> None:
        """Seal batches ``<= seq_through`` into published ``version``. Only
        called AFTER the publish succeeded — a crash before this record is
        written replays (retrains) those batches, which is deterministic and
        therefore converges to the same bytes."""
        header: Dict[str, Any] = {"seq": int(seq_through),
                                  "version": int(version),
                                  "cycle": int(cycle)}
        if model is not None:
            header["model"] = str(model)
        if baseline is not None:
            header["baseline"] = float(baseline)
        rotated = None
        durable = True
        try:
            with self._lock:
                try:
                    self._append_record(_KIND_COMMIT, int(seq_through),
                                        header)
                except WalUnavailable:
                    # disk full mid-commit: the publish already happened, so
                    # advance the in-memory frontier anyway — recovery just
                    # retrains the unsealed tail, which is deterministic —
                    # and retry the durable seal at the next commit
                    durable = False
                self._committed_seq = max(self._committed_seq,
                                          int(seq_through))
                self._last_commit = header
                self._last_seq = max(self._last_seq, int(seq_through))
                self._release_committed_locked()
                if durable:
                    self.commits += 1
                    try:
                        rotated = self._maybe_rotate_locked()
                    except OSError as e:
                        if self._full_mode != "degrade":
                            raise
                        # rotation rewrites the whole file — skip it while
                        # the disk is tight, and make sure the handle is
                        # usable again (rotation closes it before writing)
                        self._reset_handle_locked()
                        log.warning(f"feed WAL rotation skipped: {e}")
                    if model is not None:
                        self._gc_artifacts_locked(str(model))
        finally:
            self._emit_degrade_transition()
        if durable:
            obs.emit("wal_commit", seq=int(seq_through),
                     version=int(version),
                     model=str(model) if model is not None else "")
        if rotated is not None:
            obs.emit("wal_rotate", batches=int(rotated["batches"]),
                     rows=int(rotated["rows"]), bytes=int(rotated["bytes"]))

    # ---- retention: payload release + log rotation ----
    def _gc_artifacts_locked(self, keep: str) -> None:
        """Unlink model artifacts superseded by the commit naming ``keep``:
        recovery only ever loads the LATEST commit's artifact, so older
        ``model_*.txt`` files are dead weight on disk. Crash-safe — a
        half-finished sweep just leaves unused files for the next commit."""
        for fn in os.listdir(self.dir):
            if fn.startswith("model_") and fn.endswith(".txt") \
                    and fn != keep:
                try:
                    os.unlink(os.path.join(self.dir, fn))
                except OSError:
                    pass

    def release_committed(self) -> None:
        """Drop the in-memory payload arrays of committed batches (their
        seq/rows/id stubs stay for bookkeeping). Recovery re-reads payloads
        from disk; resident memory is bounded by the pending set. Called by
        every :meth:`commit`, and by the trainer once recovery has finished
        re-appending the scan-loaded committed rows."""
        with self._lock:
            self._release_committed_locked()

    def _release_committed_locked(self) -> None:
        for b in self._batches:
            if b.seq <= self._committed_seq and b.has_payload:
                b.drop_payload()

    def _maybe_rotate_locked(self) -> Optional[Dict[str, int]]:
        if self._keep_rows <= 0:
            return None   # unbounded dataset: every committed row rebuilds
        # committed batches outside the newest keep_rows committed rows are
        # droppable — recovery only re-appends the sliding window
        kept = 0
        drop_seqs = set()
        drop_rows = 0
        for b in reversed(self._batches):
            if b.seq > self._committed_seq:
                continue
            if kept >= self._keep_rows:
                drop_seqs.add(b.seq)
                drop_rows += b.rows
            else:
                kept += b.rows
        if drop_rows < self._keep_rows:
            return None   # hysteresis: rewrite once a full window pends
        return self._rotate_locked(drop_seqs)

    def _rotate_locked(self, drop_seqs: set) -> Dict[str, int]:
        dropped = [b for b in self._batches if b.seq in drop_seqs]
        self._rotated_ids.update(b.batch_id for b in dropped
                                 if b.batch_id is not None)
        self.rotated_batches += len(dropped)
        self.rotated_rows += sum(b.rows for b in dropped)
        with open(self.path, "rb") as fh:
            blob = fh.read()
        ids_rec = _encode_record(
            _KIND_IDS, int(self._committed_seq),
            {"ids": sorted(self._rotated_ids),
             "batches": int(self.rotated_batches),
             "rows": int(self.rotated_rows),
             "expired": int(self.expired_total)})
        frames: List[bytes] = [ids_rec]
        commit_frame = b""
        # pending FEAT frames survive rotation verbatim (a join may still
        # arrive), but their byte offsets shift — rebuild the stub map as
        # the new blob is laid out; expire tombstones and join-sealed FEATs
        # fold into the ids record totals above
        new_feats: Dict[str, Dict[str, Any]] = {}
        new_off = len(ids_rec)
        for off, end, kind, seq, header, _payload in _scan_frames(blob):
            if kind == _KIND_COMMIT:
                commit_frame = blob[off:end]   # only the latest survives
            elif kind == _KIND_BATCH and seq not in drop_seqs:
                frames.append(blob[off:end])
                new_off += end - off
            elif kind == _KIND_FEAT:
                rid = str(header.get("rid"))
                meta = self._feats.get(rid)
                if meta is not None:
                    frames.append(blob[off:end])
                    new_feats[rid] = dict(meta, off=int(new_off))
                    new_off += end - off
            # old ids/expire records fold into the rewritten ids one
        new_blob = b"".join(frames + [commit_frame])
        # the one whole-file rewrite the log ever does: atomic replace, so
        # a crash mid-rotation leaves the old log or the new one intact
        self._fh.close()
        atomic_io.atomic_write_bytes(self.path, new_blob)
        # append-only log handle, same contract as __init__
        self._fh = open(self.path, "ab")  # tpu-lint: disable=non-atomic-artifact-write
        self._batches = [b for b in self._batches if b.seq not in drop_seqs]
        self._feats = new_feats
        self._good_size = len(new_blob)
        self.rotations += 1
        return {"batches": len(dropped),
                "rows": sum(b.rows for b in dropped),
                "bytes": len(blob) - len(new_blob)}

    # ---- recovery surface (read by OnlineTrainer.__init__) ----
    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._last_seq

    @property
    def committed_seq(self) -> int:
        with self._lock:
            return self._committed_seq

    @property
    def last_commit(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return None if self._last_commit is None else dict(self._last_commit)

    def seen(self, batch_id: str) -> bool:
        with self._lock:
            return str(batch_id) in self._ids

    def committed(self) -> List[WalBatch]:
        """Batches already trained into the committed model artifact, in
        sequence order: re-append their rows, never retrain them. Payloads
        are present right after a scan (the recovery window) and released
        once a commit — or the trainer's post-recovery
        :meth:`release_committed` — seals them."""
        with self._lock:
            return [b for b in self._batches if b.seq <= self._committed_seq]

    def pending(self) -> List[WalBatch]:
        """Unacknowledged batches, in sequence order: replay these through
        the trigger machinery on restart."""
        with self._lock:
            return [b for b in self._batches if b.seq > self._committed_seq]

    def batch_seqs(self) -> List[int]:
        """Every batch sequence number in the log (chaos-drill bookkeeping:
        zero lost / zero double-trained is asserted from these)."""
        with self._lock:
            return [b.seq for b in self._batches]

    def model_artifact(self, seq: int) -> str:
        """Canonical path of the model artifact sealed by the commit record
        at ``seq`` (written atomically by the trainer before the commit)."""
        return os.path.join(self.dir, f"model_{int(seq):08d}.txt")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            try:
                size = os.path.getsize(self.path)
            except OSError:
                size = 0
            return {"path": self.path, "bytes": int(size),
                    "batches": len(self._batches),
                    "appends": int(self.appends),
                    "commits": int(self.commits),
                    "last_seq": int(self._last_seq),
                    "committed_seq": int(self._committed_seq),
                    "truncated_bytes": int(self.truncated_bytes),
                    "resident_batches": sum(
                        1 for b in self._batches if b.has_payload),
                    "rotations": int(self.rotations),
                    "rotated_batches": int(self.rotated_batches),
                    "rotated_rows": int(self.rotated_rows),
                    "pending_features": len(self._feats),
                    "feature_appends": int(self.feature_appends),
                    "expired_features": int(self.expired_total),
                    "degraded": bool(self._degraded),
                    "degrade_count": int(self.degrade_count),
                    "skipped_appends": int(self.skipped_appends),
                    "bytes_appended": int(self.bytes_appended),
                    "fsync_s": float(self.fsync_s)}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed
