"""Seconds from the process's start to the window's opening: imports, the
CUDA context, the data, both constructs, the kernel library (built on the
first run in a checkout) and the warm-up iterations."""


def read(ctx):
    return ctx.setup_s
