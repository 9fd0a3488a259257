"""The program's own spans in a traced stretch: its host syncs, and the
device's idle time inside ``boosting`` by the phase of the iteration.

``lightgbm_tpu_torch`` opens a ``record_function`` range for each of its
spans while a profiler records (``obs.tracing.span``); the trace keeps
them as ``user_annotation`` host events, on the clock of the device's
kernels, copies and memsets. Each phase of a boosting iteration has a
fixed name, and every call that blocks the host on the card sits in a
``sync.<site>`` span of its own. A level pass (``grow.pass``) is tiled by
its phases: ``pass.search``, ``pass.apply`` and ``pass.hist``.

The idle time inside ``boosting`` (``trace.idle_gaps`` cut to the
``boosting`` ranges) is cut at the edges of these spans, and each piece
goes to the innermost phase that covers it; a piece inside a pass between
two phases (the host's few microseconds from one to the next) goes to
``pass.apply``, the pass's own bookkeeping; a piece that no ``grow.pass``
covers goes to ``outside``: sampling, gradients, the front, the leaf
renewal and the score update. The four parts sum to the idle time inside
``boosting``; the idle time in ``eval`` is ``eval_ms``'s range and is left
out. A profile without the program's spans (a program that opens none)
gives None, so that such a program reports nothing rather than 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .trace import Profile, idle_gaps, union

BOOSTING = "boosting"
TREE = "grow.tree"
PASS = "grow.pass"
PHASES = ("pass.search", "pass.apply", "pass.hist")
SYNC = "sync."
OUTSIDE = "outside"


def spans(p: Profile, name: str) -> List[Tuple[float, float]]:
    """The program's spans of ``name`` (a name ending in "." is a
    prefix), as (start, end)."""
    if name.endswith("."):
        return [(s, e) for cat, n, s, e in p.host
                if cat == "user_annotation" and n.startswith(name)]
    return [(s, e) for cat, n, s, e in p.host
            if cat == "user_annotation" and n == name]


def has_spans(p: Optional[Profile]) -> bool:
    """Whether the traced program opens the iteration's spans."""
    return p is not None and bool(spans(p, TREE))


def _segments(p: Profile) -> List[Tuple[float, float, str]]:
    """Disjoint (start, end, part) stretches of the ``boosting`` ranges,
    sorted, each labelled with the part its idle time goes to."""
    kinds = (BOOSTING, PASS) + PHASES
    edges = []
    for cat, n, s, e in p.host:
        if cat == "user_annotation" and n in kinds and e > s:
            edges.append((s, 1, n, s))
            edges.append((e, 0, n, s))
    edges.sort()                        # at one instant, ends first
    open_: Dict[str, List[float]] = {k: [] for k in kinds}
    out: List[Tuple[float, float, str]] = []
    prev = None
    for t, starts, n, s in edges:
        if prev is not None and t > prev and open_[BOOSTING]:
            if not open_[PASS]:
                part = OUTSIDE
            else:
                inner = [(max(open_[k]), k) for k in PHASES if open_[k]]
                part = max(inner)[1] if inner else "pass.apply"
            out.append((prev, t, part))
        if starts:
            open_[n].append(s)
        else:
            open_[n].remove(s)
        prev = t
    return out


def idle_by_part(p: Optional[Profile]) -> Optional[Dict[str, float]]:
    """Seconds of device idle inside ``boosting``, by part: each of
    ``PHASES`` and ``OUTSIDE``; None without the program's spans."""
    if not has_spans(p):
        return None
    out = {k: 0.0 for k in PHASES + (OUTSIDE,)}
    segs = _segments(p)
    gaps = idle_gaps(p)
    i = j = 0
    while i < len(segs) and j < len(gaps):
        s0, s1, part = segs[i]
        g0, g1 = gaps[j]
        lo, hi = max(s0, g0), min(s1, g1)
        if hi > lo:
            out[part] += hi - lo
        if s1 <= g1:
            i += 1
        else:
            j += 1
    return out


def idle_ms(p: Optional[Profile], part: str) -> Optional[float]:
    """Idle milliseconds an iteration of one part (see idle_by_part)."""
    parts = idle_by_part(p)
    return None if parts is None else parts[part] / p.iterations * 1e3


def sync_spans(p: Profile) -> List[Tuple[float, float]]:
    return spans(p, SYNC)


def sync_seconds(p: Profile) -> float:
    """Host seconds inside ``sync.*`` spans (their union)."""
    return sum(e - s for s, e in union(sync_spans(p)))
