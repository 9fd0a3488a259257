"""Trace spans: one name, three sinks.

Port of ``lightgbm_tpu/obs/tracing.py``. A :func:`span` scope feeds the
same name to (1) the ``TIMER`` wall-clock registry (whose scopes open
``torch.profiler.record_function`` ranges, so the name lines up in a
torch.profiler trace) and (2), when telemetry is enabled, a log2 latency
histogram ``span_seconds{span=<name>}`` in the metrics registry.

Request tracing (the serve path, ROADMAP A18): :func:`mint_trace_id`
stamps a process-unique id on each request; :func:`record_span` observes an
externally timed duration into the same ``span_seconds`` family, and
:data:`TRACES` keeps 1-in-N complete traces as exemplars, all host-side
clock reads.

:func:`maybe_start_xla_trace` / :func:`stop_xla_trace` drive an on-demand
profiler capture gated by the ``xla_trace_out`` knob (the reference's name,
kept with its parameter table): a ``torch.profiler.profile`` of the CPU
and, when CUDA is present, the CUDA activity, written on stop as one Chrome
trace (``trace_<time>_<pid>.json``, open it in chrome://tracing or
Perfetto) into that directory. A device trace is far too heavy to leave
on, so it only runs when an operator names an output directory. A capture
that cannot start warns, as the reference's does.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .. import log
from ..utils.timer import TIMER

# the running capture (its directory and profiler) is check-then-acted on
# from whichever thread calls maybe_start/stop; the lock makes the "already
# capturing?" test and the rebind one atomic step
_trace_lock = threading.Lock()
_trace: Optional[tuple] = None
# the last capture written: {"path", "bytes", "seconds"} (the export's)
LAST_TRACE: Dict[str, Any] = {}


@contextlib.contextmanager
def span(name: str, block_on=None):
    """Timed scope: TIMER accumulation + record_function range + latency
    histogram (histogram only when telemetry is on; the disabled path adds
    only a clock read over a bare ``TIMER.scope``)."""
    from . import enabled, METRICS
    t0 = time.perf_counter()
    with TIMER.scope(name, block_on=block_on):
        yield
    if enabled():
        METRICS.histogram("span_seconds", "span wall time by name",
                          span=name).observe(time.perf_counter() - t0)


def record_span(name: str, seconds: float) -> None:
    """Observe an externally-timed duration into ``span_seconds{span=name}``."""
    from . import METRICS, enabled
    if enabled():
        METRICS.histogram("span_seconds", "span wall time by name",
                          span=name).observe(seconds)


class TraceBuffer:
    """Bounded ring of sampled request-trace exemplars (thread-safe)."""

    def __init__(self, capacity: int = 256) -> None:
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._sampled = 0

    def mint_trace_id(self) -> str:
        return f"req-{next(self._ids):08x}"  # itertools.count is atomic

    def maybe_record(self, trace: Dict[str, Any], sample: int = 1) -> bool:
        """Keep this trace as an exemplar with 1-in-``sample`` probability
        (deterministic round-robin, so sample=1 keeps everything)."""
        with self._lock:
            self._sampled += 1
            if sample > 1 and (self._sampled % sample) != 1:
                return False
            self._ring.append(dict(trace))
            return True

    def record(self, trace: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(dict(trace))

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._sampled = 0


TRACES = TraceBuffer()


def mint_trace_id() -> str:
    return TRACES.mint_trace_id()


def maybe_start_xla_trace(out_dir: str) -> bool:
    """Start a torch.profiler capture for ``out_dir`` (no-op on an empty
    dir or while a capture runs). Returns whether a capture started."""
    global _trace
    with _trace_lock:
        if not out_dir or _trace is not None:
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:  # profiler backends vary; never break training
            log.warning(f"could not start the profiler trace into "
                        f"{out_dir!r} ({type(e).__name__}: {e})")
            return False
        _trace = (out_dir, prof)
    log.info(f"profiler trace started (xla_trace_out={out_dir})")
    return True


def stop_xla_trace() -> Optional[str]:
    """Stop the running capture (if any) and write its Chrome trace;
    returns its output dir (the file's path, size and write seconds are in
    ``LAST_TRACE``)."""
    global _trace
    with _trace_lock:
        if _trace is None:
            return None
        (out, prof), _trace = _trace, None
    try:
        prof.stop()
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_"
                                 f"{os.getpid()}.json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        done = dict(path=path, bytes=os.path.getsize(path),
                    seconds=time.perf_counter() - t0)
        with _trace_lock:
            LAST_TRACE.clear()
            LAST_TRACE.update(done)
    except Exception as e:  # pragma: no cover - symmetric guard
        log.warning(f"could not write the profiler trace "
                    f"({type(e).__name__}: {e})")
        return None
    log.info(f"profiler trace written to {path}")
    return out
