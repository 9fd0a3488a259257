"""Crash-safe file writes: write to a temporary file, fsync, rename.

Port of ``lightgbm_tpu/utils/atomic_io.py``. The bytes land in a temporary
file in the target's directory, are fsync'd, and only then replace the
final name (``os.replace``), so a reader never sees a half-written model,
snapshot or binary Dataset. Scheme paths (``gs://`` and the like) write
through the opener ``io/vfs.py`` has registered for the scheme, which is
taken to replace whole objects atomically.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

from . import faults


def _is_scheme_path(path: str) -> bool:
    head, sep, _ = path.partition("://")
    return bool(sep) and bool(head)


def atomic_write_with(path: str, writer: Callable, mode: str = "wb",
                      fault_name: Optional[str] = None) -> None:
    """Atomically replace ``path`` with what ``writer(fileobj)`` writes:
    the temporary file is fsync'd and renamed only if the writer returns.
    An armed ``fault_name`` fires after the write and before the rename,
    the window the protocol exists for: the final path stays untouched."""
    if _is_scheme_path(path):
        from ..io import vfs
        if fault_name:
            faults.fault_point(fault_name)
        with vfs.open_file(path, mode) as f:
            writer(f)
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.",
                               dir=d)
    try:
        with os.fdopen(fd, mode) as f:
            writer(f)
            if fault_name:
                faults.fault_point(fault_name)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        tmp = None
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def atomic_write_bytes(path: str, data: bytes,
                       fault_name: Optional[str] = None) -> None:
    atomic_write_with(path, lambda f: f.write(data), fault_name=fault_name)


def atomic_write_text(path: str, text: str, encoding: str = "utf-8",
                      fault_name: Optional[str] = None) -> None:
    atomic_write_bytes(path, text.encode(encoding), fault_name=fault_name)

