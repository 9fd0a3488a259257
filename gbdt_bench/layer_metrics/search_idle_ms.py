"""Device-idle milliseconds an iteration inside ``pass.search`` spans:
the split search and the level's selection, with its host read."""
from gbdt_bench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx.profile, "pass.search")
