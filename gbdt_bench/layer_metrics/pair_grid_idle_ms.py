"""Device-idle milliseconds an iteration inside the LambdaRank pair
grid's ``obj.pair_grid`` spans: whether the host's loop over query chunks
leaves the card waiting. Nothing without the span, or without a device
operation in the trace.

It is read only under the profiler, which adds a host cost to each of the
grid's launches (about 700 an iteration), so it reads the profiler's cost
as well as the loop's, and spreads with the host's speed from run to run:
6.4 to 17.4 ms over six traced runs of ``yahoo_ltr.bin63`` on one H100
while the grid's device time held at 13.7 ms. A change to the grid shows
in ``pair_grid_device_ms`` and ``launches_per_iter`` first; this one says
whether the card waits on the host inside the span at all.
"""
from gbdt_bench.spans import spans
from gbdt_bench.trace import idle_gaps, union
from gbdt_bench.layer_metrics.pair_grid_device_ms import GRID


def read(ctx):
    p = ctx.profile
    if p is None or not p.device:
        return None
    opened = union(spans(p, GRID))
    if not opened:
        return None
    idle = sum(max(0.0, min(e, g1) - max(s, g0))
               for g0, g1 in idle_gaps(p) for s, e in opened)
    return idle / p.iterations * 1e3
