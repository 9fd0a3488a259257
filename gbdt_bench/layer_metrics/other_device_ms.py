"""Device milliseconds an iteration of every kernel outside the port's
hand-written B1-B8 (split search, objective, partition, glue)."""
from gbdt_bench.trace import device_seconds


def read(ctx):
    p = ctx.profile
    if p is None or not p.kernels():
        return None
    return device_seconds(p, False) / p.iterations * 1e3
