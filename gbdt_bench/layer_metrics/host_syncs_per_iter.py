"""Host syncs an iteration: the program's ``sync.*`` spans in the traced
stretch over its iterations (every call that blocks the host on the card
sits in one of its own), in the boosting loop and in ``eval``."""
from gbdt_bench.spans import has_spans, sync_spans


def read(ctx):
    p = ctx.profile
    if not has_spans(p):
        return None
    return len(sync_spans(p)) / p.iterations
