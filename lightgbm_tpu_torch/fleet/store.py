"""Shared artifact store: one directory of versioned model files per name.

Port of ``lightgbm_tpu/fleet/store.py`` (host code, copied; the files are
written through ``utils/atomic_io.py``).

Every replica in a fleet — in-process engine replicas and SO_REUSEPORT
worker processes alike — reads model text from the same store; a publish
writes the artifact ONCE and every replica's ModelRegistry builds its own
engine from that path. Layout::

    <root>/<name>/v000001.txt      model text, atomic_write_text
    <root>/<name>/CURRENT          the current version number (atomic)

``CURRENT`` is written after the artifact, so a reader that sees version v
can always open v's file; a crash between the two writes leaves the store
pointing at the previous complete artifact (the new file is inert).
"""
from __future__ import annotations

import os
import re
import threading
from typing import Dict, List, Optional, Tuple

from .. import log
from ..utils.atomic_io import atomic_write_text

_VFILE = re.compile(r"^v(\d{6})\.txt$")


class ArtifactStore:
    """Versioned model-text files under one root directory (thread-safe)."""

    def __init__(self, root: str):
        self.root = str(root)
        self._lock = threading.Lock()
        os.makedirs(self.root, exist_ok=True)

    def _dir(self, name: str) -> str:
        if not re.match(r"^[A-Za-z0-9_.@-]+$", name):
            raise ValueError(f"bad model name for artifact store: {name!r}")
        return os.path.join(self.root, name)

    def put(self, name: str, model) -> Tuple[int, str]:
        """Write ``model`` (a Booster, or model text, or a source path) as
        the next version of ``name``; returns ``(version, path)``."""
        from ..basic import Booster
        if isinstance(model, Booster):
            text = model.model_to_string()
        elif isinstance(model, str) and "\n" not in model \
                and os.path.exists(model):
            with open(model, "r") as f:
                text = f.read()
        elif isinstance(model, (str, bytes)):
            text = model.decode() if isinstance(model, bytes) else model
        else:
            raise TypeError(f"cannot store model of type {type(model)}")
        d = self._dir(name)
        with self._lock:
            os.makedirs(d, exist_ok=True)
            version = self.latest_version(name) + 1
            path = os.path.join(d, f"v{version:06d}.txt")
            atomic_write_text(path, text)
            atomic_write_text(os.path.join(d, "CURRENT"), f"{version}\n")
        log.debug(f"artifact store: {name} v{version} -> {path}")
        return version, path

    def latest_version(self, name: str) -> int:
        """Highest complete version of ``name`` (0 when none)."""
        d = self._dir(name)
        try:
            names = os.listdir(d)
        except OSError:
            return 0
        vs = [int(m.group(1)) for m in (_VFILE.match(n) for n in names) if m]
        return max(vs) if vs else 0

    def current_path(self, name: str) -> Optional[str]:
        """Path of the version ``CURRENT`` points at (None when empty)."""
        d = self._dir(name)
        try:
            with open(os.path.join(d, "CURRENT")) as f:
                v = int(f.read().strip())
        except (OSError, ValueError):
            v = self.latest_version(name)
        if v <= 0:
            return None
        path = os.path.join(d, f"v{v:06d}.txt")
        return path if os.path.exists(path) else None

    def versions(self, name: str) -> List[int]:
        d = self._dir(name)
        try:
            names = os.listdir(d)
        except OSError:
            return []
        return sorted(int(m.group(1))
                      for m in (_VFILE.match(n) for n in names) if m)

    def snapshot(self) -> Dict[str, Dict]:
        try:
            models = [n for n in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, n))]
        except OSError:
            models = []
        return {n: {"versions": self.versions(n),
                    "current": self.current_path(n)} for n in models}
