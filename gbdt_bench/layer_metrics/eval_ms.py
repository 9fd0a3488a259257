"""Host milliseconds an iteration inside engine.train's ``eval`` range
(the validation metric), from the profile."""
from gbdt_bench.trace import range_seconds


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    s = range_seconds(p, "eval")
    return s / p.iterations * 1e3 if s > 0 else None
