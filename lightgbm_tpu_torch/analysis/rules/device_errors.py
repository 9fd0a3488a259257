"""Rule: swallowed-device-error — broad excepts that eat device failures.

The fault-tolerance layer only works if device errors actually REACH it: a
CUDA out-of-memory from a ``.to(device)`` or a launch must either
propagate, be retried through ``utils/retry``, or at minimum leave a
telemetry trace — ``try: x.to(dev) except Exception: pass`` converts a
recoverable OOM into silently missing data, the exact failure mode
``on_device_fault`` policies exist to prevent.

The rule flags a ``try`` whose body performs a device transfer or sync and
whose handler catches a broad type without any of the escape hatches:

- re-raising (any ``raise`` in the handler),
- retrying via ``call_with_backoff``,
- emitting telemetry (``obs.emit``/``emit``),
- handing the bound exception to a non-logging callee (the ingest
  pipeline's ``_fail(e)`` stash-and-surface protocol, or collecting it as
  data the way the liveness probe does) — a bare ``log.debug("...", e)``
  does NOT count: a debug line is where device errors go to disappear.

The port's device sites are ``.to(...)``, ``.cuda()``, ``.item()`` and
``torch.cuda.synchronize()``; its broad types add
``torch.cuda.OutOfMemoryError`` and ``RuntimeError`` (what a failed CUDA
call raises) to ``Exception``/``BaseException``/a bare ``except``. The
reference's names (``device_put``, ``device_get``, ``block_until_ready``,
``XlaRuntimeError``/``JaxRuntimeError``) stay in the sets, so both
linters give the same findings on the reference's fixtures.

Deliberate best-effort sites suppress inline with
``# tpu-lint: disable=swallowed-device-error`` and a reason comment.
Scoped to ``lightgbm_tpu_torch/`` product code; tests and scripts are free
to swallow what they like.
"""
from __future__ import annotations

import ast

from ..astwalk import walk
from typing import List, Optional

from ..core import ModuleContext, Rule, register

# device transfer/sync call names whose failures carry the device fault:
# the port's, then the reference's
_DEVICE_SITES = ("to", "cuda", "item", "synchronize",
                 "device_put", "device_get", "block_until_ready")

# exception names broad enough to (also) catch a CUDA error
_BROAD_TYPES = ("Exception", "BaseException", "RuntimeError",
                "OutOfMemoryError", "XlaRuntimeError", "JaxRuntimeError")

# callee attribute names that are logging, not handling
_LOG_METHODS = ("debug", "info", "warning", "warn", "error", "exception",
                "fatal", "critical")


def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _caught_names(h: ast.ExceptHandler) -> List[str]:
    t = h.type
    if t is None:
        return ["<bare>"]
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = []
    for e in elts:
        if isinstance(e, ast.Attribute):
            out.append(e.attr)
        elif isinstance(e, ast.Name):
            out.append(e.id)
    return out


def _uses_name(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in walk(node))


def _handler_is_ok(h: ast.ExceptHandler) -> bool:
    """True when the handler re-raises, retries, emits, or hands the bound
    exception to a non-logging callee."""
    exc_name = h.name
    for node in walk(h):
        if isinstance(node, ast.Raise):
            return True
        if not isinstance(node, ast.Call):
            continue
        cn = _call_name(node)
        if cn in ("emit", "call_with_backoff"):
            return True
        if cn in _LOG_METHODS or cn is None:
            continue
        if exc_name and any(_uses_name(a, exc_name)
                            for a in list(node.args)
                            + [kw.value for kw in node.keywords]):
            return True   # _fail(e) / dead.append(f"{e}") style handoff
    return False


@register
class SwallowedDeviceError(Rule):
    name = "swallowed-device-error"
    severity = "error"
    description = ("broad except around device transfer/sync sites that "
                   "neither re-raises, retries via utils/retry, emits "
                   "telemetry, nor hands the exception off")
    rationale = ("a swallowed CUDA out-of-memory turns a recoverable "
                 "device OOM into silently missing data; the "
                 "on_device_fault recovery ladder (ingest.py, gbdt.py) can "
                 "only act on errors that reach it")

    def check_module(self, ctx: ModuleContext) -> None:
        rp = ctx.relpath
        if "lightgbm_tpu_torch/" not in rp or \
                "lightgbm_tpu_torch/analysis/" in rp:
            return
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            has_device_site = any(
                isinstance(n, ast.Call) and _call_name(n) in _DEVICE_SITES
                for b in node.body for n in walk(b))
            if not has_device_site:
                continue
            for h in node.handlers:
                caught = _caught_names(h)
                broad = [c for c in caught
                         if c in _BROAD_TYPES or c == "<bare>"]
                if not broad or _handler_is_ok(h):
                    continue
                ctx.report(self, h,
                           f"except {'/'.join(broad)} around a device "
                           "transfer/sync swallows device faults; re-raise, "
                           "retry via utils.retry.call_with_backoff, emit "
                           "telemetry, or suppress a deliberate best-effort "
                           "site with a reason")
