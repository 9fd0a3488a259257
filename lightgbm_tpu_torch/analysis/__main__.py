"""CLI entry: ``LGBMTPU_LINT_ONLY=1 python -m lightgbm_tpu_torch.analysis``.

The environment variable short-circuits the parent package's imports, so
the lint pass never loads torch; see lightgbm_tpu_torch/__init__.py.
"""
import sys

from .core import main

if __name__ == "__main__":
    sys.exit(main())
