"""The share of the level passes replayed as a CUDA graph: the program's
``pass.replay`` spans over its ``grow.pass`` spans in the traced stretch.
A program that replays no pass (one without the span) reports nothing."""
from gbdt_bench.spans import PASS, spans

REPLAY = "pass.replay"


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    replays = len(spans(p, REPLAY))
    passes = len(spans(p, PASS))
    if not replays or not passes:
        return None
    return replays / passes
