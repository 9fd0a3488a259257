"""Trace spans: one name, three sinks.

Port of ``lightgbm_tpu/obs/tracing.py``. :func:`span` is the program's one
span API. Each span feeds its name to whichever sinks are on:

- while a torch profiler records (torch's own flag), a
  ``torch.profiler.record_function`` range of the name, on the profiler's
  clock beside the device's kernels, copies and memsets, its parent the
  range that contains it on the same thread;
- with telemetry on (``telemetry=1``) or the timing table asked for
  (``verbosity >= 2``, :func:`set_timing_table`), its wall time into the
  ``TIMER`` registry and, with telemetry on, into the log2 latency
  histogram ``span_seconds{span=<name>}`` of the metrics registry.

With none of them on, a span reads one flag and the profiler's and
returns a shared no-op scope: no clock read, no lock, no range. A
``timed`` span (the engine's ``boosting`` and ``eval``, the Dataset's
``dataset_construct``) adds its wall time to ``TIMER`` whatever the
settings, since ``TIMER.last_run`` and the ``phase_seconds`` gauges read
it.

The boosting iteration's spans (fixed names; nesting by containment):
``iter.sample``, ``iter.gradients``, ``grow.tree`` holding ``grow.front``,
``grow.pass`` (``pass.search``, ``pass.apply``, ``pass.hist``, or
``pass.replay`` where the pass replays as a CUDA graph) and
``grow.leaf_renew``, then ``iter.score_update``; every call that blocks
the host on the card sits in a ``sync.<site>`` span of its own, so the
number of ``sync.*`` spans is the number of host syncs.

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

from torch._C._autograd import _profiler_enabled as _recording
from torch.profiler import record_function

from .. import log
from ..utils.timer import TIMER, sync_on

# the running capture (its directory and profiler) is check-then-acted on
# from whichever thread calls maybe_start/stop; the lock makes the "already
# capturing?" test and the rebind one atomic step
_trace_lock = threading.Lock()
_trace: Optional[tuple] = None
# the last capture written: {"path", "bytes", "seconds"} (the export's)
LAST_TRACE: Dict[str, Any] = {}


# spans time themselves while telemetry is on or the timing table is asked
# for: one module flag, which refresh_timing rewrites under the lock and a
# span reads without it (a stale read times one span more or less)
_timing_lock = threading.Lock()
_timing = False
_table = False
_NOOP = contextlib.nullcontext()


def refresh_timing() -> None:
    """Re-read whether spans time themselves (``obs.configure`` and
    :func:`set_timing_table` call it)."""
    global _timing
    from . import enabled
    with _timing_lock:
        _timing = _table or enabled()


def set_timing_table(on: bool) -> bool:
    """Ask for (or stop asking for) the timing table, which times every
    span into ``TIMER`` (``engine.train`` at ``verbosity >= 2``); returns
    the previous setting."""
    global _table
    with _timing_lock:
        was, _table = _table, bool(on)
    refresh_timing()
    return was


class _Span:
    """A span that records, times, or both (``span`` decides which)."""
    __slots__ = ("name", "rec", "timed", "block_on", "rf", "t0")

    def __init__(self, name: str, rec: bool, timed: bool, block_on):
        self.name, self.rec, self.timed = name, rec, timed
        self.block_on = block_on
        self.rf = None

    def __enter__(self):
        if self.rec:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        if self.timed:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if self.timed and self.block_on is not None and exc[0] is None:
                b = self.block_on
                sync_on(b() if callable(b) else b)
        finally:
            if self.rf is not None:
                self.rf.__exit__(*exc)
        if self.timed:
            dt = time.perf_counter() - self.t0
            TIMER.add(self.name, dt)
            from . import METRICS, enabled
            if enabled():
                METRICS.histogram("span_seconds", "span wall time by name",
                                  span=self.name).observe(dt)
        return False


def span(name: str, block_on=None, timed: bool = False):
    """The scope of one named span (see the module's docstring).
    ``block_on`` (tensors, or a callable returning them): a timed span
    synchronizes their CUDA devices before its clock stops, so that it
    covers the device's work, not just its launch. ``timed``: add the wall
    time to ``TIMER`` whatever the settings."""
    rec = _recording()
    timed = (timed and TIMER.enabled) or _timing
    if not (rec or timed):
        return _NOOP
    return _Span(name, rec, timed, block_on)


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
