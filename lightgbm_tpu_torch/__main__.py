"""``python -m lightgbm_tpu_torch``: the reference's ``lightgbm`` command
line (src/main.cpp:9-31)."""
import sys

from .app import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], log_to_stderr=True))
