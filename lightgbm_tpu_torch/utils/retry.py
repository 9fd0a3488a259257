"""Retry with exponential backoff.

Port of ``lightgbm_tpu/utils/retry.py`` (reference analog: the socket
linkers retry a transient connect failure, linkers_socket.cpp:171-224).
Snapshot writes retry through it here.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type

from .. import log


def backoff_delays(attempts: int, base_delay: float = 0.1,
                   max_delay: float = 30.0, factor: float = 2.0):
    """Yield ``attempts - 1`` exponentially growing sleeps, capped at
    ``max_delay``; deterministic (no jitter), so tests can count them."""
    d = base_delay
    for _ in range(max(attempts - 1, 0)):
        yield min(d, max_delay)
        d *= factor


def call_with_backoff(fn: Callable, *, attempts: int = 3,
                      base_delay: float = 0.1, max_delay: float = 30.0,
                      retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                      should_retry: Optional[
                          Callable[[BaseException], bool]] = None,
                      name: Optional[str] = None,
                      sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()``; on a ``retry_on`` exception (that ``should_retry``,
    when given, accepts) retry with exponential backoff, and re-raise the
    last error once ``attempts`` are spent."""
    what = name or getattr(fn, "__name__", "operation")
    delays = list(backoff_delays(attempts, base_delay, max_delay))
    last: Optional[BaseException] = None
    for i in range(max(attempts, 1)):
        try:
            return fn()
        except retry_on as e:   # noqa: PERF203 - a retry loop
            if should_retry is not None and not should_retry(e):
                raise
            last = e
            if i >= len(delays):
                break
            log.warning(f"{what} failed ({type(e).__name__}: {e}); "
                        f"retry {i + 1}/{attempts - 1} in {delays[i]:.2f}s")
            from .. import obs   # lazy: obs -> atomic_io -> this package
            obs.emit("dist_retry", name=what, attempt=i + 1,
                     error=f"{type(e).__name__}: {e}",
                     delay_s=float(delays[i]))
            sleep(delays[i])
    assert last is not None
    raise last
