"""End-to-end metrics, one module a metric, named as in BENCHMARK.json.
Each defines ``read(ctx) -> Optional[float]`` over a
``harness.EndToEndContext``; both come from the host clock."""
