"""Data generators, one module a generator, found by the ``generator``
name of a configuration file. Each module defines ``make(cfg, seed,
device) -> Data``; the rows are drawn on ``device`` from ``seed``."""
