"""The least time for an iteration's needed work (work/needed.py: the
larger of its bytes over the card's bandwidth and its operations over its
f32 rate) as a share of the unprofiled window's seconds an iteration."""
from gbdt_bench.work.needed import iteration_work, least_seconds


def read(ctx):
    if not ctx.window_trees or not ctx.window_iter_s:
        return None
    need = sum(least_seconds(*iteration_work(t, ctx.shape), ctx.bandwidth,
                             ctx.flops) for t in ctx.window_trees) \
        / len(ctx.window_trees)
    return 100.0 * need / ctx.window_iter_s
