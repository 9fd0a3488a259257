"""Device-idle milliseconds an iteration inside ``boosting`` but inside
no ``grow.pass``: sampling, gradients, the grower's front, the leaf
renewal and the score update."""
from gbdt_bench.spans import OUTSIDE, idle_ms


def read(ctx):
    return idle_ms(ctx.profile, OUTSIDE)
