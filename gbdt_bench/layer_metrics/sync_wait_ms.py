"""Host milliseconds an iteration inside the program's ``sync.*`` spans:
the host waiting for the card to drain its queue."""
from gbdt_bench.spans import has_spans, sync_seconds


def read(ctx):
    p = ctx.profile
    if not has_spans(p):
        return None
    return sync_seconds(p) / p.iterations * 1e3
