"""Named-scope timing registry.

Port of ``lightgbm_tpu/utils/timer.py``, the analog of LightGBM's
``Timer``/``FunctionTimer`` registry (src/utils/common.h:1032-1093, enabled
with USE_TIMER): named accumulating wall-clock times, printed as a sorted
table. It is the accumulator of the program's one span API,
``obs.tracing.span``, which also opens the ``torch.profiler``
range of the same name while a profiler records; ``TIMER.scope`` and
``timed`` are that span, always timed (the span can block on device
results, ``block_on``: a tensor, or a callable returning tensors, whose
CUDA devices are synchronized before the clock stops, so that work the
card still runs is not attributed to the next span).

The registry is thread-safe and namespaced per training run:
``engine.train`` calls :meth:`TimerRegistry.begin_run` so accumulations
don't bleed across successive ``train()`` calls in one process; the
previous run's table stays readable via ``last_run``.

Usage::

    from lightgbm_tpu_torch.obs.tracing import span
    from lightgbm_tpu_torch.utils.timer import TIMER, timed

    with span("pass.hist"):       # timed with telemetry or the table on
        ...
    with TIMER.scope("hist"):     # always timed
        ...
    @timed("construct_bins")
    def f(...): ...

    TIMER.summary_string()  # the table; logged at the end of training
"""
from __future__ import annotations

import functools
import statistics
import threading
import time
from typing import Dict, Tuple


class TimerRegistry:
    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}
        self._cnt: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.last_run: Dict[str, Tuple[float, int]] = {}
        self.enabled = True

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()
            self._cnt.clear()

    def begin_run(self) -> None:
        """Start a fresh accumulation namespace (one per train() call):
        archives the current table into ``last_run`` and clears."""
        with self._lock:
            self.last_run = {k: (self._acc[k], self._cnt.get(k, 0))
                             for k in self._acc}
            self._acc.clear()
            self._cnt.clear()

    def scope(self, name: str, block_on=None):
        """``obs.tracing.span(name, block_on, timed=True)``: wall time
        accumulated under ``name`` whatever the telemetry settings."""
        from ..obs.tracing import span
        return span(name, block_on=block_on, timed=True)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + seconds
            self._cnt[name] = self._cnt.get(name, 0) + 1

    def get(self, name: str) -> float:
        with self._lock:
            return self._acc.get(name, 0.0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{name: {"seconds", "count"}}; engine.train folds it into the
        ``phase_seconds`` gauges."""
        with self._lock:
            return {k: {"seconds": self._acc[k], "count": self._cnt.get(k, 0)}
                    for k in self._acc}

    def summary_string(self) -> str:
        """Sorted table (LightGBM prints the same at program exit,
        common.h:1056 Timer::~Timer)."""
        with self._lock:
            acc = dict(self._acc)
            cnt = dict(self._cnt)
        if not acc:
            return "No timing scopes recorded"
        lines = ["LightGBM-TPU timing summary:"]
        width = max(len(k) for k in acc)
        for name, sec in sorted(acc.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<{width}s} {sec:10.3f} s  "
                         f"(x{cnt[name]})")
        return "\n".join(lines)


TIMER = TimerRegistry()


def _tensors(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "device") and hasattr(x, "is_cuda"):
        yield x


def sync_on(x) -> None:
    """Wait for the work behind ``x`` (a tensor or a nesting of lists,
    tuples and dicts of them): ``torch.cuda.synchronize`` on each CUDA
    device among them; CPU tensors are computed already."""
    import torch
    seen = set()
    for t in _tensors(x):
        if t.is_cuda and t.device not in seen:
            seen.add(t.device)
            torch.cuda.synchronize(t.device)


def timed(name: str, block: bool = False):
    """Decorator form (LightGBM's FunctionTimer, common.h:1076); with
    ``block`` the scope waits for the returned tensors."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with TIMER.scope(name):
                out = fn(*args, **kwargs)
                if block:
                    sync_on(out)
            return out
        return inner
    return wrap


def time_op(op, *args, reps: int = 7) -> float:
    """Milliseconds of one ``op(*args)``, the median of ``reps`` timings
    after a warm-up call (the reference's ``time_op_in_jit``, which timed
    inside one jit program to cancel dispatch latency; the port's ops run
    eagerly). On CUDA tensors each call is timed by CUDA events recorded on
    the current stream around it and read after a synchronize: the device's
    time for the launched work, host launch gaps between its kernels
    included. On CPU tensors, or with no tensor argument, it is timed by
    ``time.perf_counter``: host time, which says how fast PyTorch's CPU
    kernels are, not the card."""
    import torch
    cuda = [t for t in _tensors(args) if t.is_cuda]
    op(*args)
    times = []
    if cuda:
        dev = cuda[0].device
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                op(*args)
                b.record()
                torch.cuda.synchronize(dev)
                times.append(a.elapsed_time(b))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            op(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
