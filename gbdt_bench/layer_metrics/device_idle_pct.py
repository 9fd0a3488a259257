"""The share of the profiled stretch that no device operation covers (the
union of their intervals, not the sum of their times)."""
from gbdt_bench.trace import busy_s


def read(ctx):
    p = ctx.profile
    if p is None or not p.device or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(p) / p.window_s)
