"""Logging and the fatal-error type of the port.

Messages go through the standard ``logging`` module under the
``lightgbm_tpu_torch`` logger; ``LightGBMError`` is what a fatal
configuration or data error raises (reference: utils/log.py, Log::Fatal).
"""
from __future__ import annotations

import logging

_LOG = logging.getLogger("lightgbm_tpu_torch")


class LightGBMError(RuntimeError):
    """Raised by fatal errors."""


def warning(msg: str, *args) -> None:
    _LOG.warning(msg, *args)
