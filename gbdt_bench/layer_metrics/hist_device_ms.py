"""Device milliseconds an iteration of the port's hand-written kernels
B1-B8 (ops/hist_kernels.py -> csrc/), grouped by function name."""
from gbdt_bench.trace import device_seconds


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    s = device_seconds(p, True)
    return s / p.iterations * 1e3 if s > 0 else None
