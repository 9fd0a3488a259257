"""Rule: host-sync-in-jit — host syncs in the port's hot loops.

The reference's rule flags host materialization inside jitted code. The
port has no jit: its growers are Python loops that launch kernels, so the
same hazard is a device->host sync inside those loops. Each ``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``,
``bool``/``int``/``float`` of a tensor reduction (``bool(x.any())``) or
op whose output size depends on the data (``.nonzero()``) blocks
the host until every launch queued before it has run, so the card idles
while the host prepares the next launch (PERF.md §5, bottleneck 1: the card
is idle most of each iteration, and the wall follows the level loop's
critical path).

Audited, lexically and through the same module's helpers they call (one
level deep, so ``select_level`` and ``_membership_leaves`` count as the
level loop's):

- the depthwise grower's level loops (``ops/grow_depthwise.py``
  ``grow_tree_depthwise``, its serial ``_grow_serial`` and
  ``grow_tree_depthwise_lean``);
- the lossguide grower's step loop (``ops/grow.py`` ``grow_tree``);
- the engine's iteration loop (``engine.py`` ``train``) and the trainer's
  per-iteration methods (``models/gbdt.py`` ``train_one_iter``, ``_grow``),
  whose whole bodies run once an iteration.

A sync that IS the design — the one a level and a step needs to size the
next launch on the host — says so in an inline suppression with its
reason. Every other sync is a finding. ``x.shape``/``x.numel()``-style
metadata is not a sync and is not flagged.

The serving scheduler loop (``server.py`` ``_scheduler_loop``) and the
other queue-draining loops get the reference's stricter audit unchanged:
one thread drains the shared queue, so ANY blocking call there —
``time.sleep``, an unbounded ``.join()``, a ``.get()`` with no timeout —
stalls every queued request, not just its own.
"""
from __future__ import annotations

import ast

from ..astwalk import walk
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core import ModuleContext, Rule, register

# method calls that copy a tensor to the host or wait for the card
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
# ops whose output size depends on the data: the host waits for the card
# to learn it
_SIZE_SYNCS = {"nonzero", "argwhere", "unique", "masked_select"}
# builtin casts that read a tensor's value on the host ...
_SYNC_BUILTINS = {"float", "int", "bool"}
# ... when their argument is a tensor reduction
_REDUCTIONS = {"any", "all", "sum", "max", "min", "argmax", "argmin",
               "mean", "prod", "count_nonzero"}

# loops audited for per-level / per-step / per-iteration syncs:
# (path, function) -> what the loop is, for the message
HOT_LOOPS: Dict[Tuple[str, str], str] = {
    ("lightgbm_tpu_torch/ops/grow_depthwise.py", "grow_tree_depthwise"):
        "level loop",
    ("lightgbm_tpu_torch/ops/grow_depthwise.py", "_grow_serial"):
        "level loop",
    ("lightgbm_tpu_torch/ops/grow_depthwise.py", "grow_tree_depthwise_lean"):
        "level loop",
    ("lightgbm_tpu_torch/ops/grow.py", "grow_tree"): "step loop",
    ("lightgbm_tpu_torch/engine.py", "train"): "iteration loop",
}
# functions whose whole body runs once an iteration
PER_ITERATION: Set[Tuple[str, str]] = {
    ("lightgbm_tpu_torch/models/gbdt.py", "train_one_iter"),
    ("lightgbm_tpu_torch/models/gbdt.py", "_grow"),
}

# scheduler loops: ONE thread drains a shared queue, so any blocking call
# there stalls everything queued behind it (the reference's list, pointed
# at the port's files)
SCHED_LOOPS: Set[Tuple[str, str]] = {
    ("lightgbm_tpu_torch/server.py", "_scheduler_loop"),
    ("lightgbm_tpu_torch/online.py", "run"),
    ("lightgbm_tpu_torch/online.py", "_worker_loop"),
    ("lightgbm_tpu_torch/obs/__init__.py", "_flush_loop"),
    ("lightgbm_tpu_torch/fleet/replica.py", "_probe_loop"),
    ("lightgbm_tpu_torch/online.py", "_sweep_loop"),
}


def sync_kind(node: ast.AST) -> Optional[str]:
    """What host sync the call ``node`` is (``.item()``,
    ``bool(x.any())``, ...), or None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
        if f.attr == "synchronize" or not node.args:
            return f".{f.attr}()"
        return None
    if isinstance(f, ast.Attribute) and f.attr in _SIZE_SYNCS:
        return f".{f.attr}()"
    if isinstance(f, ast.Name) and f.id in _SYNC_BUILTINS and \
            len(node.args) == 1:
        arg = node.args[0]
        if isinstance(arg, ast.Call) and \
                isinstance(arg.func, ast.Attribute) and \
                arg.func.attr in _REDUCTIONS:
            return f"{f.id}(...{arg.func.attr}())"
    return None


def _module_functions(tree: ast.Module) -> Dict[str, ast.AST]:
    """Top-level functions and methods by bare name (first definition)."""
    out: Dict[str, ast.AST] = {}
    for node in walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """The nodes of ``fn``'s body, without nested function bodies."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def loop_sync_sites(ctx: ModuleContext) -> List[Tuple[int, str, str]]:
    """Every host sync the audited loops of this module reach:
    (line, sync, where) sorted by line, suppressed sites included. The
    inventory chip_smoke.py prints; the rule reports the same sites."""
    funcs = _module_functions(ctx.tree)
    out: Dict[int, Tuple[int, str, str]] = {}

    def scan(nodes: Iterable[ast.AST], where: str, depth: int) -> None:
        for n in nodes:
            kind = sync_kind(n)
            if kind is not None:
                out.setdefault(id(n), (n.lineno, kind, where))
            if depth == 0 and isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Name) and n.func.id in funcs:
                callee = funcs[n.func.id]
                scan(_own_nodes(callee),
                     f"{where}, in {n.func.id}() called at line "
                     f"{n.lineno}", 1)

    for name, fn in funcs.items():
        what = HOT_LOOPS.get((ctx.relpath, name))
        if what is not None:
            seen: Set[int] = set()
            for loop in walk(fn):
                if not isinstance(loop, (ast.For, ast.While)) or \
                        id(loop) in seen:
                    continue
                nodes = [n for n in walk(loop)]
                seen.update(id(n) for n in nodes)
                scan(nodes, f"the {what} of {name}() (line {loop.lineno})",
                     0)
        if (ctx.relpath, name) in PER_ITERATION:
            scan(_own_nodes(fn), f"{name}(), once an iteration", 0)
    return sorted(out.values())


@register
class HostSyncInJit(Rule):
    name = "host-sync-in-jit"
    severity = "error"
    description = ("host sync (.item()/.cpu()/.tolist()/.numpy()/"
                   "torch.cuda.synchronize/bool(x.any())) inside the "
                   "level, step or iteration loop, or a blocking call in a "
                   "scheduler loop")
    rationale = ("each sync idles the card until the host queues the next "
                 "launch; the growers' loops are the port's critical path "
                 "(PERF.md §5, bottleneck 1)")

    def check_module(self, ctx: ModuleContext) -> None:
        for line, kind, where in loop_sync_sites(ctx):
            ctx.report(self, line,
                       f"{kind} in {where} blocks the host until the card "
                       "drains its queue; keep the value on the card, or "
                       "suppress the one intended sync with its reason")
        for node in walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and (ctx.relpath, node.name) in SCHED_LOOPS:
                self._check_sched_loop(ctx, node)

    # -- request-scheduler loops: blocking-call-in-scheduler-loop hazard --
    def _check_sched_loop(self, ctx: ModuleContext, fn: ast.AST) -> None:
        """A scheduler loop may only ever wait ON ITS QUEUE, with a timeout:
        flag time.sleep (the queue should do the waiting), ``.join()`` with
        no timeout (unbounded stall of every queued request), and ``.get()``
        with neither timeout nor args (blocks forever, deaf to shutdown)."""
        for loop in walk(fn):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                fname = f.attr if isinstance(f, ast.Attribute) else \
                    f.id if isinstance(f, ast.Name) else ""
                if fname == "sleep":
                    ctx.report(self, node,
                               f"sleep inside the {fn.name}() scheduler loop "
                               "stalls every queued request; wait on the "
                               "queue instead (q.get(timeout=...))")
                elif fname == "join" and not node.args and not node.keywords:
                    ctx.report(self, node,
                               f".join() with no timeout inside the "
                               f"{fn.name}() scheduler loop can block "
                               "forever; pass a timeout or hand the wait to "
                               "the queue")
                elif fname == "get" and not node.args and \
                        not any(kw.arg == "timeout" for kw in node.keywords):
                    ctx.report(self, node,
                               f".get() with no timeout inside the "
                               f"{fn.name}() scheduler loop blocks forever "
                               "and is deaf to shutdown; use "
                               "get(timeout=...) or get_nowait()")
