"""Rule: telemetry-schema — every ``emit(...)`` site matches its schema.

The reference's rule on the port's call sites. Each ``emit`` /
``obs.emit`` / ``EVENTS.emit`` call site must

- name its event type with a string LITERAL (dynamic types defeat both this
  check and grep-ability),
- use a type registered in ``obs.events.EVENT_SCHEMAS``,
- pass every REQUIRED field of that type as a keyword argument, and
- pass no keyword that is neither required nor optional for the type.

This is the static complement of the runtime validation in
``obs.events.emit`` (which raises on violations): the runtime check catches
what executes; this catches every site that *could* execute — including
rarely-hit paths like fault injection and distributed retries. The schema
registry is extracted by AST-parsing the port's ``obs/events.py``, never by
importing it, so the rule runs without torch.

The ``obs/`` PLUMBING modules are out of scope (events.py, __init__.py,
metrics.py, tracing.py, memory.py hold the emit/validate machinery —
delegating wrappers with a non-literal etype — not telemetry call sites), as
are ``scripts/`` and the analysis package.  The obs modules that EMIT real
events (slo.py, flight.py, http_server.py) are in scope like any product
module: their literal emit sites must match EVENT_SCHEMAS.
"""
from __future__ import annotations

import ast

from ..astwalk import walk

from ..core import ModuleContext, Rule, event_schemas, register

_SKIP_PREFIXES = ("lightgbm_tpu_torch/obs/events.py",
                  "lightgbm_tpu_torch/obs/__init__.py",
                  "lightgbm_tpu_torch/obs/metrics.py",
                  "lightgbm_tpu_torch/obs/tracing.py",
                  "lightgbm_tpu_torch/obs/memory.py",
                  "lightgbm_tpu_torch/analysis/", "scripts/")


@register
class TelemetrySchema(Rule):
    name = "telemetry-schema"
    severity = "error"
    description = ("emit(...) call site with a non-literal/unregistered "
                   "event type or fields violating EVENT_SCHEMAS")
    rationale = ("a schema-violating emit on a rarely-hit path (fault "
                 "injection, retry) raises in production instead of in CI")

    def check_module(self, ctx: ModuleContext) -> None:
        if ctx.relpath.startswith(_SKIP_PREFIXES):
            return
        schemas = event_schemas()
        if not schemas:
            return   # obs/events.py unavailable: stay silent
        for node in walk(ctx.tree):
            if isinstance(node, ast.Call) and _is_emit_call(node):
                self._check_site(ctx, node, schemas)

    def _check_site(self, ctx: ModuleContext, node: ast.Call,
                    schemas) -> None:
        if not node.args:
            ctx.report(self, node, "emit() without an event type")
            return
        etype_node = node.args[0]
        if not (isinstance(etype_node, ast.Constant)
                and isinstance(etype_node.value, str)):
            ctx.report(self, node,
                       "event type must be a string literal (dynamic types "
                       "defeat schema checking and grep-ability)")
            return
        etype = etype_node.value
        if etype not in schemas:
            ctx.report(self, node,
                       f"unregistered event type {etype!r}; add it to "
                       "obs.events.EVENT_SCHEMAS")
            return
        required, optional = schemas[etype]
        kw_names = set()
        dynamic_kwargs = False
        for kw in node.keywords:
            if kw.arg is None:            # **fields — cannot check statically
                dynamic_kwargs = True
            else:
                kw_names.add(kw.arg)
        if not dynamic_kwargs:
            for name in sorted(required - kw_names):
                ctx.report(self, node,
                           f"event {etype!r} missing required field "
                           f"{name!r}")
        for name in sorted(kw_names - required - optional):
            ctx.report(self, node,
                       f"event {etype!r} passes unregistered field "
                       f"{name!r}")


def _is_emit_call(node: ast.Call) -> bool:
    """Anything whose terminal attr/name is ``emit``."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id == "emit"
    return isinstance(f, ast.Attribute) and f.attr == "emit"
