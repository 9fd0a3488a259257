"""Device-idle milliseconds an iteration inside ``pass.hist`` spans: the
launch side of the route-and-histogram pass (B2, or B6 with B5/B8) and
the sibling subtraction."""
from gbdt_bench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx.profile, "pass.hist")
