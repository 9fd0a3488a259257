"""Rule: unlocked-shared-state — cross-thread mutation without a lock.

The serving engine, the observability sinks, and the chunked ingest
pipeline are the places this codebase is deliberately multi-threaded
(prediction workers; the background metrics flusher; the encode/H2D/commit
stage threads), so they are the places a module-level mutable — a
cache dict, a ``global`` rebind — can be mutated by one thread while another
reads it. CPython's GIL makes single bytecodes atomic but NOT compound
check-then-act sequences; the classic symptom is a shape-bucket cache that
intermittently serves a half-built entry.

Scope is intentionally narrow (``serving.py``, ``server.py``, ``ingest.py``,
``obs/``): elsewhere,
module-level mutation is the normal single-threaded idiom and flagging it
would be noise. Within scope, the rule flags

1. a ``global X`` write (assign/augassign to a declared-global name) not
   under a ``with <...lock...>:`` block, and
2. a mutation (subscript-assign, ``del x[...]``, ``.append/.update/...``) of
   a name bound at module level to a mutable literal, in a function, not
   under a ``with <...lock...>:`` block.

Anything protected by a ``with`` whose context expression mentions a name
containing "lock" (``_LOCK``, ``self._lock``, ``threading.Lock`` instances)
passes. Single-threaded-by-design state can be suppressed inline with a
comment saying who guarantees single-threadedness.
"""
from __future__ import annotations

import ast

from ..astwalk import walk
from typing import Set

from ..core import ModuleContext, Rule, register, root_name

# exact file paths / directory prefixes that are deliberately multi-threaded:
# the serving engine + microbatch scheduler, the obs sinks, the chunked
# ingest pipeline, and the serving fleet (balancer/admission/rollout)
_SCOPE_FILES = ("lightgbm_tpu_torch/serving.py",
                "lightgbm_tpu_torch/server.py",
                "lightgbm_tpu_torch/ingest.py",
                "lightgbm_tpu_torch/online.py",
                # the write-ahead feed log is appended by serve-handler
                # threads and scanned/committed by the refit worker
                "lightgbm_tpu_torch/wal.py",
                # the delayed-label join buffer is mutated by serve-ingress
                # capture, label-arrival handlers, and the sweep thread
                "lightgbm_tpu_torch/join.py",
                # pod collectives run while the ingest worker threads are
                # still committing chunks; any module-level state here is
                # cross-thread by construction
                "lightgbm_tpu_torch/parallel/multihost.py")
_SCOPE_DIRS = ("lightgbm_tpu_torch/obs/", "lightgbm_tpu_torch/fleet/")
_MUTATING_METHODS = {"append", "extend", "add", "update", "setdefault",
                     "pop", "popitem", "clear", "remove", "insert",
                     "discard", "appendleft"}
_MUTABLE_LITERALS = (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp,
                     ast.SetComp)


@register
class UnlockedSharedState(Rule):
    name = "unlocked-shared-state"
    severity = "error"
    description = ("module-level mutable or global rebind mutated without "
                   "holding a lock (serving.py / obs/ scope)")
    rationale = ("serving and obs are multi-threaded; unlocked compound "
                 "mutations race and intermittently corrupt caches")

    def check_module(self, ctx: ModuleContext) -> None:
        if not (ctx.relpath in _SCOPE_FILES
                or ctx.relpath.startswith(_SCOPE_DIRS)
                or ctx.relpath.startswith("<")):   # fixtures stay in scope
            return
        shared = _module_level_mutables(ctx.tree)
        for fn in walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(ctx, fn, shared)

    def _check_function(self, ctx: ModuleContext, fn: ast.AST,
                        shared: Set[str]) -> None:
        globals_written: Set[str] = set()
        for node in fn.body:
            for sub in walk(node):
                if isinstance(sub, ast.Global):
                    globals_written.update(sub.names)
        for node in walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                    node is not fn:
                continue   # nested defs are visited on their own
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in globals_written \
                            and not _under_lock(ctx, node):
                        ctx.report(self, node,
                                   f"global {t.id!r} rebound without a lock; "
                                   "wrap the write (and its paired reads) in "
                                   "'with <lock>:' or suppress with a single-"
                                   "threadedness justification")
                    elif isinstance(t, ast.Subscript) and \
                            _roots_shared(t, shared | globals_written) and \
                            not _under_lock(ctx, node):
                        ctx.report(self, node,
                                   f"item write to module-level mutable "
                                   f"{root_name(t)!r} without a lock")
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            _roots_shared(t, shared | globals_written) and \
                            not _under_lock(ctx, node):
                        ctx.report(self, node,
                                   f"del on module-level mutable "
                                   f"{root_name(t)!r} without a lock")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATING_METHODS and \
                    _roots_shared(node.func.value,
                                  shared | globals_written) and \
                    not _under_lock(ctx, node):
                ctx.report(self, node,
                           f".{node.func.attr}() on module-level mutable "
                           f"{root_name(node.func.value)!r} without a lock")


def _module_level_mutables(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, _MUTABLE_LITERALS):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(node, ast.AnnAssign) and node.value is not None and \
                isinstance(node.value, _MUTABLE_LITERALS) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _roots_shared(node: ast.AST, shared: Set[str]) -> bool:
    rn = root_name(node)
    return rn is not None and rn in shared


def _under_lock(ctx: ModuleContext, node: ast.AST) -> bool:
    """Some ancestor is a ``with`` whose context expr mentions a lock-ish
    name (contains 'lock', any case) or calls an RLock/Lock factory."""
    for anc in ctx.ancestors(node):
        if not isinstance(anc, (ast.With, ast.AsyncWith)):
            continue
        for item in anc.items:
            for sub in walk(item.context_expr):
                name = sub.id if isinstance(sub, ast.Name) else \
                    sub.attr if isinstance(sub, ast.Attribute) else ""
                if "lock" in name.lower():
                    return True
    return False
