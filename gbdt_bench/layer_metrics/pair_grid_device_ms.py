"""Device milliseconds an iteration of the LambdaRank pair grid's own
operations: those the program launched inside its ``obj.pair_grid`` spans
(``objectives.py`` ``LambdaRank.get_gradients``: the gathers into the
query grid, ``lambdarank_grid``, the scatter back to rows).

The trace keeps no correlation id between a launch and its device
operation, so the two are matched by order on the one stream the program
uses, where operations start in the order they were launched. For each
span:

- the drain is the end of the last host call before the span that waits
  for the card (a ``...Synchronize``), or the traced stretch's start,
  which the harness opens on an empty queue;
- m is the launch calls (the CUDA API's kernel launches, memcpys and
  memsets) from the drain to the span's opening: work the queue may still
  hold when the span opens;
- n is the launch calls inside the span;
- the span's operations are the device operations m + 1 to m + n, in
  order of their start, of those that start after the drain.

A CUDA graph launch from the drain to the span's end, or fewer device
operations than launches, leaves the count unknown, and the metric then
reads nothing. Without an ``obj.pair_grid`` span (another objective, or a
program that opens none) it reads nothing either.
"""
from typing import List, Optional, Tuple

from gbdt_bench.spans import spans

GRID = "obj.pair_grid"
LAUNCH = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
          "cuMemset")


def span_operations(p) -> Optional[List[Tuple[str, str, float, float]]]:
    """The device operations launched inside the ``obj.pair_grid`` spans
    of the profile ``p`` (see the module's docstring), or None."""
    if p is None:
        return None
    opened = spans(p, GRID)
    if not opened:
        return None
    api = sorted((h for h in p.host if h[0].startswith("cuda_")),
                 key=lambda h: h[2])
    drains = [h[3] for h in api if "Synchronize" in h[1]]
    dev = sorted(p.device, key=lambda d: d[2])
    out = []
    for s, e in opened:
        drain = max((t for t in drains if t <= s), default=p.window[0])
        calls = [h for h in api if drain <= h[2] < e]
        if any("GraphLaunch" in h[1] for h in calls):
            return None
        m = sum(h[1].startswith(LAUNCH) for h in calls if h[2] < s)
        n = sum(h[1].startswith(LAUNCH) for h in calls if h[2] >= s)
        after = [d for d in dev if d[2] >= drain]
        if len(after) < m + n:
            return None
        out.extend(after[m:m + n])
    return out


def read(ctx):
    p = ctx.profile
    ops = span_operations(p)
    if not ops:
        return None
    return sum(t - s for _, _, s, t in ops) / p.iterations * 1e3
