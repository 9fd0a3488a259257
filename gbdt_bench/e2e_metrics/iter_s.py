"""Seconds a boosting iteration, eval included: the measured window's
seconds over the iterations completed in it (host clock, the window's
edges ending in a synchronise)."""


def read(ctx):
    if ctx.window_iterations <= 0:
        return None
    return ctx.window_s / ctx.window_iterations
