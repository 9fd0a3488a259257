"""Virtual file access (reference: VirtualFileReader/Writer,
utils/file_io.h, src/io/file_io.cpp:57).

Port of ``lightgbm_tpu/io/vfs.py``: ``register_scheme`` installs an opener
for a URI scheme ("hdfs", "gs", ...); local paths use ``open``. No remote
transport ships here; the parser, the sidecar loaders and ``atomic_io``
go through this seam.
"""
from __future__ import annotations

import io as _io
import os
from typing import Callable, Dict

from .. import log

_OPENERS: Dict[str, Callable] = {}


def register_scheme(scheme: str, opener: Callable) -> None:
    """Install ``opener(path, mode) -> file-like`` for ``scheme://``
    paths."""
    _OPENERS[scheme.lower()] = opener


def _scheme_of(path: str) -> str:
    head, sep, _ = path.partition("://")
    return head.lower() if sep else ""


def open_file(path: str, mode: str = "rb"):
    """Open ``path`` through the scheme registry (local files directly)."""
    scheme = _scheme_of(path)
    if not scheme:
        return open(path, mode)
    opener = _OPENERS.get(scheme)
    if opener is None:
        log.fatal(f"no file handler registered for '{scheme}://' paths "
                  "(register one with lightgbm_tpu_torch.io.vfs."
                  "register_scheme)")
    return opener(path, mode)


def open_text(path: str, encoding: str = "utf-8"):
    """Text-mode open through the scheme registry."""
    if not _scheme_of(path):
        return open(path, "r", encoding=encoding, errors="replace")
    return _io.TextIOWrapper(open_file(path, "rb"), encoding=encoding,
                             errors="replace")


def exists(path: str) -> bool:
    """Whether ``path`` is readable. A transport error on a scheme path
    warns with its exception class before it counts as missing; only a
    clean not-found answer is quiet."""
    if not _scheme_of(path):
        return os.path.exists(path)
    try:
        with open_file(path, "rb"):
            return True
    except FileNotFoundError:
        return False
    except Exception as e:
        log.warning(f"vfs.exists({path!r}): transport error "
                    f"({type(e).__name__}: {e}); treating as missing")
        return False
