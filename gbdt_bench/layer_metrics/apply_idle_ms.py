"""Device-idle milliseconds an iteration inside ``pass.apply`` spans (and
between a pass's phases): the level's bookkeeping, the tree arrays, the
route tables, the children's bounds and stats."""
from gbdt_bench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx.profile, "pass.apply")
