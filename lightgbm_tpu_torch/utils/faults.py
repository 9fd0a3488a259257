"""Fault-injection harness.

Port of ``lightgbm_tpu/utils/faults.py``. Named fault points sit in the
hot paths and are inert unless armed. Arming happens through the
``LGBMTPU_FAULTS`` environment variable or the ``faults`` parameter, with
the spec syntax::

    LGBMTPU_FAULTS="snapshot_write:2,tree_update@5"

``name:k`` fails the first k hits of the point and then succeeds; a count
of -1 (or ``*``) fails forever; ``name@k`` skips the first k hits and then
fails forever ("crash at the (k+1)-th boosting iteration"). An unknown name
is refused when the spec is armed, with the list of known points, so that a
misspelt spec never passes a test without injecting anything.

The registry keeps every point the reference knows, so a spec written for
it parses here. The points this package reaches:

========================  ===================================================
point                     fires in
========================  ===================================================
``snapshot_write``        utils/atomic_io.py, between the temporary file's
                          write and the atomic rename; snapshot.py retries
                          through it
``tree_update``           engine.train, at the top of each boosting
                          iteration (the kill-and-resume crash)
``device_put_oom``        ingest.py, at each chunk's host-to-device copy,
                          and serving.py, at the upload of a batch's
                          pseudo-bins; raises the real
                          ``torch.cuda.OutOfMemoryError`` type
``prewarm_compile``       prewarm.py, at the start of the background
                          library load and kernel warm-up
``wal_append``            wal.py, once a feed batch is durable and before
                          the trainer buffers it
``dataset_append``        basic.Dataset.append, once the rows are binned on
                          the device and before anything changes in place
``online_train``          online.py, a refit cycle after its append and
                          before its training
``online_publish``        online.py, a refit cycle after its training and
                          before its publish and WAL commit
``join_capture``          wal.py, once a captured feature row-set is durable
``join_label``            join.py, a label in hand and its join not yet
                          durable
``join_commit``           join.py, the joined batch durable and its ack not
                          yet returned
``shard_commit``          ingest.py, at each chunk's commit into its row
                          shard's block under a mesh plan
``hist_allreduce``        models/gbdt.py, at each iteration of the
                          data-parallel learner, before its shard sums;
                          retried from the iteration's saved state
========================  ===================================================

The others fire in modules that are not ported yet, and arming one raises
``NotImplementedError`` naming its ROADMAP.md item (``UNPORTED_POINTS``):
the distributed bootstrap and the cross-process mapper exchange belong to
the process-spanning mesh (A21b).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from .. import log

ENV_VAR = "LGBMTPU_FAULTS"

KNOWN_POINTS = ("snapshot_write", "mapper_allgather", "dist_init",
                "tree_update", "shard_commit", "hist_allreduce",
                "device_put_oom", "prewarm_compile",
                "wal_append", "dataset_append", "online_train",
                "online_publish",
                "join_capture", "join_label", "join_commit")

# the points that simulate device failures (reference: faults.py:107-113)
DEVICE_FAULT_POINTS = ("shard_commit", "hist_allreduce", "device_put_oom",
                       "prewarm_compile")
_OOM_POINTS = ("device_put_oom",)

# point -> the ROADMAP.md item whose module holds its site
UNPORTED_POINTS = {p: "A21b" for p in ("mapper_allgather", "dist_init")}

_lock = threading.Lock()
# name -> [skip_remaining, fail_remaining]; fail_remaining < 0 = forever
_armed: Dict[str, list] = {}
_hits: Dict[str, int] = {}
_env_loaded = False


class FaultInjected(RuntimeError):
    """Raised by an armed fault point (a simulated crash or transport
    error)."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at '{point}' (hit #{hit})")
        self.point = point
        self.hit = hit


def _oom_error(point: str, hit: int) -> BaseException:
    """A simulated device OOM of the real type, ``torch.cuda.OutOfMemoryError``
    (the reference raises XLA's RESOURCE_EXHAUSTED error type), so the
    recovery paths take the branch a real OOM takes."""
    import torch
    return torch.cuda.OutOfMemoryError(
        f"CUDA out of memory: injected device OOM at '{point}' (hit #{hit})")


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for a device allocation failure: torch's
    ``OutOfMemoryError`` (the reference matches XLA's RESOURCE_EXHAUSTED
    status)."""
    import torch
    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    return oom is not None and isinstance(exc, oom)


def is_device_fault(exc: BaseException) -> bool:
    """A device-level fault: an out-of-memory error, or a
    ``FaultInjected`` from one of the device points."""
    if isinstance(exc, FaultInjected):
        return exc.point in DEVICE_FAULT_POINTS
    return is_resource_exhausted(exc)


def classify_point(exc: BaseException, default: str = "device") -> str:
    """The fault point's name for telemetry: a ``FaultInjected``'s point, a
    registry name in a simulated OOM's message, else ``default`` (a real
    fault carries no point)."""
    if isinstance(exc, FaultInjected):
        return exc.point
    msg = str(exc)
    for p in DEVICE_FAULT_POINTS:
        if p in msg:
            return p
    return default


def _parse_spec(spec: str) -> Dict[str, list]:
    out: Dict[str, list] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        skip = 0
        name = part
        count = "1"
        if ":" in part:
            name, count = part.split(":", 1)
        if "@" in name:
            name, skip_s = name.split("@", 1)
            skip = int(skip_s)
            if ":" not in part:
                count = "-1"
        name = name.strip()
        n = -1 if count.strip() in ("-1", "*", "inf") else int(count)
        if name not in KNOWN_POINTS:
            raise ValueError(
                f"unknown fault point '{name}' in spec {spec!r}; known "
                f"points: {', '.join(KNOWN_POINTS)} (see the registry in "
                "lightgbm_tpu_torch/utils/faults.py)")
        if name in UNPORTED_POINTS:
            raise NotImplementedError(
                f"fault point '{name}' fires in a module that is not "
                f"ported yet (ROADMAP.md queue A, {UNPORTED_POINTS[name]})")
        out[name] = [skip, n]
    return out


def configure(spec: Optional[str]) -> None:
    """Arm fault points from a spec (empty or None disarms them all).
    Raises ValueError on an unknown point, NotImplementedError on one that
    this package does not reach yet."""
    global _env_loaded
    armed = _parse_spec(spec) if spec else {}
    with _lock:
        _armed.clear()
        _hits.clear()
        _env_loaded = True   # an explicit configure overrides the env var
        _armed.update(armed)


def reset() -> None:
    """Disarm every fault point and forget the hit counts."""
    global _env_loaded
    with _lock:
        _armed.clear()
        _hits.clear()
        _env_loaded = False


def _ensure_env_loaded() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(ENV_VAR, "")
    if spec:
        _armed.update(_parse_spec(spec))
        log.info(f"fault injection armed from {ENV_VAR}: {spec}")


def fault_point(name: str) -> None:
    """Hot-path hook: nothing unless ``name`` is armed; else raise
    ``FaultInjected`` (for the simulated-OOM points the real
    ``torch.cuda.OutOfMemoryError`` type) while the armed count lasts."""
    with _lock:
        _ensure_env_loaded()
        state = _armed.get(name)
        _hits[name] = _hits.get(name, 0) + 1
        if state is None:
            return
        if state[0] > 0:        # still skipping
            state[0] -= 1
            return
        if state[1] == 0:       # exhausted: succeed from now on
            return
        if state[1] > 0:
            state[1] -= 1
        hit = _hits[name]
    from .. import obs   # lazy: obs -> atomic_io -> this module
    obs.emit("fault_injected", point=name, hit=hit)
    if name in _OOM_POINTS:
        raise _oom_error(name, hit)
    raise FaultInjected(name, hit)


def hits(name: str) -> int:
    """How many times a fault point was reached (armed or not)."""
    with _lock:
        return _hits.get(name, 0)


def is_armed(name: str) -> bool:
    with _lock:
        _ensure_env_loaded()
        s = _armed.get(name)
        return bool(s and (s[0] > 0 or s[1] != 0))
