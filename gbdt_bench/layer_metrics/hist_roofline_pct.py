"""The least time for the bytes the profiled trees' histograms need
(work/needed.py) at the card's published bandwidth, as a share of the
device time of B1-B8."""
from gbdt_bench.trace import device_seconds
from gbdt_bench.work.needed import hist_bytes


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.profiled_trees:
        return None
    dev = device_seconds(p, True) / p.iterations
    if dev <= 0:
        return None
    need = sum(hist_bytes(t, ctx.shape) for t in ctx.profiled_trees) \
        / len(ctx.profiled_trees) / ctx.bandwidth
    return 100.0 * need / dev
