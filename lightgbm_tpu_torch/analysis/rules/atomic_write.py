"""Rule: non-atomic-artifact-write — bare ``open(path, "w")`` for artifacts.

A model file, benchmark JSON, or checkpoint written with a plain
``open(path, "w")`` is a torn-write hazard: a crash (or a concurrent reader —
the serving engine hot-reloads model files) between ``open`` and ``close``
leaves a half-written artifact that parses as garbage or not at all. The
checkpoint subsystem already learned this the hard way; every durable write
must go through ``utils/atomic_io`` (temp file + fsync + ``os.replace`` in
the same directory).

The rule flags ``open()`` / ``Path.write_text`` / ``Path.write_bytes`` calls
in any write mode. Genuinely transient writes (a LightGBM conf file into a
``TemporaryDirectory`` consumed in-process) are fine — suppress them inline
with ``# tpu-lint: disable=non-atomic-artifact-write``. The atomic-write
plumbing itself (``utils/atomic_io.py``, ``io/vfs.py``) is exempt: it is the
one place allowed to hold a bare file handle.
"""
from __future__ import annotations

import ast

from ..astwalk import walk

from ..core import ModuleContext, Rule, register

# modules that implement the atomic/virtual write layer itself
_EXEMPT_SUFFIXES = ("lightgbm_tpu_torch/utils/atomic_io.py",
                    "lightgbm_tpu_torch/io/vfs.py")
_WRITE_MODE_CHARS = set("wax")


@register
class NonAtomicArtifactWrite(Rule):
    name = "non-atomic-artifact-write"
    severity = "error"
    description = ("bare open(path, 'w')/write_text outside utils/atomic_io "
                   "— torn-write hazard for artifacts")
    rationale = ("a crash or concurrent hot-reload mid-write leaves a "
                 "corrupt model/benchmark file; route durable writes "
                 "through utils/atomic_io")

    def check_module(self, ctx: ModuleContext) -> None:
        if ctx.relpath.endswith(_EXEMPT_SUFFIXES):
            return
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id == "open":
                mode = _open_mode(node)
                if mode is not None and _WRITE_MODE_CHARS & set(mode):
                    ctx.report(self, node,
                               f"open(..., {mode!r}) writes in place; use "
                               "utils.atomic_io (tmp+fsync+os.replace) for "
                               "durable artifacts, or suppress for "
                               "transient/tempdir files")
            elif isinstance(f, ast.Attribute) and \
                    f.attr in ("write_text", "write_bytes"):
                ctx.report(self, node,
                           f".{f.attr}(...) writes in place; use "
                           "utils.atomic_io for durable artifacts, or "
                           "suppress for transient files")


def _open_mode(call: ast.Call):
    """The constant mode string of an ``open`` call, or None when the mode
    is dynamic/absent (absent => 'r', never a write)."""
    for kw in call.keywords:
        if kw.arg == "mode":
            v = kw.value
            return v.value if isinstance(v, ast.Constant) and \
                isinstance(v.value, str) else None
    if len(call.args) >= 2:
        v = call.args[1]
        return v.value if isinstance(v, ast.Constant) and \
            isinstance(v.value, str) else None
    return None
