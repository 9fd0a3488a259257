"""The least time of the pair work LightGBM's LambdaRank needs, as a share
of the pair grid's device time (``pair_grid_device_ms``).

The least time is the larger of the operations over the card's f32 rate
and the bytes over its bandwidth. The operations are the harness's count
(``Shape.extra_grad_flops``): 30 a (first-T document, document) cell of
each query, sum min(g, T) * g over the query sizes g at the truncation
level T, not from the grid the program builds, so a ragged or padded grid
leaves it as it is. The bytes are each document's score and label read
and its g and h written (16). Nothing without the span, or on a cell
without query groups.

The count is more than the pairs LightGBM visits, so the share reads high.
LightGBM takes, in each query's score order, i below min(T, g - 1) and
j above i, and skips a pair of equal labels; the cells also count the
diagonal and the j < i half of the T x T block. A query of 25 documents
holds 500 cells and 290 such (i, j); over ``yahoo_ltr.bin63``'s query
sizes the cells are 1.40 times the (i, j), and more than that times the
pairs of different labels, which change with the scores each iteration.
The reader sees the sizes only through that sum, so it cannot take the
pairs apart.
"""
from gbdt_bench.layer_metrics.pair_grid_device_ms import span_operations

BYTES_A_DOC = 16


def read(ctx):
    p = ctx.profile
    ops = span_operations(p)
    if not ops or ctx.shape.extra_grad_flops <= 0:
        return None
    dev = sum(t - s for _, _, s, t in ops) / p.iterations
    if dev <= 0:
        return None
    need = max(ctx.shape.extra_grad_flops / ctx.flops,
               ctx.shape.rows_train * BYTES_A_DOC / ctx.bandwidth)
    return 100.0 * need / dev
