"""Per-layer metrics, one module a metric, named as in BENCHMARK.json.

Each module defines ``read(ctx) -> Optional[float]`` over a
``harness.LayerContext``. A reader that finds nothing to read returns None
and the metric is left out of the result line; a share of a roofline or a
peak is never returned as 0.
"""
