"""Rule: lock-order — cross-module lock acquisition cycles + check-then-act.

The serve/online/obs stack is a dozen cooperating threads (microbatch
scheduler, metrics flusher, online refit cycles, registry hot-swap, flight
recorder) sharing half a dozen locks. Two threads acquiring the same pair of
locks in opposite orders is a potential deadlock that no per-line visitor can
see: the two ``with`` blocks live in different modules and the inversion only
exists in the composed call graph.

Pass 1 (``analysis/facts.py``) records every acquisition with the locks
lexically held at that site, and every call made while holding a lock. This
rule composes them:

- **edges**: holding A and acquiring B (nested ``with``, or calling a
  function that — transitively — acquires B) adds the edge A -> B to the
  repo-wide acquisition-order graph. Callees are resolved by name: bare
  calls prefer the same module; method calls match any scanned function with
  that name. Resolution is deliberately restricted to candidates that
  actually acquire locks, so generic names (``get``, ``update``) cannot spray
  edges from lock-free helpers.
- **cycles** in that graph (A -> B -> A) are potential deadlocks: error.
- **self-cycles** on a non-reentrant ``threading.Lock`` (holding A and
  re-acquiring A, directly or through a callee) are guaranteed deadlocks:
  error. RLocks are reentrant and exempt.
- **check-then-act escalation**: the same lock acquired in two separate
  ``with`` blocks of one function, where state captured under the first
  block is consumed under the second — the classic stale-decision race
  (value read, lock dropped, decision made on a value another thread may
  have changed): warning.

The static graph is validated at runtime by a lockwatch, which records REAL
acquisition orders and asserts zero inversions (the reference's, installed
by tests/conftest.py, in the port's serving, fleet and online tests; this
package's ``analysis/lockwatch.py`` in scripts/torch_lockwatch_drill.py) —
the two views keep each other honest.

Scope mirrors the shared-state rule: the deliberately multi-threaded modules
(serving/server/ingest/online + obs/) plus fixtures. Elsewhere lock nesting
is not flagged.
"""
from __future__ import annotations

import ast

from ..astwalk import walk
from typing import Dict, List, Optional, Set, Tuple

from ..core import ModuleContext, Rule, register

_SCOPE_FILES = ("lightgbm_tpu_torch/serving.py",
                "lightgbm_tpu_torch/server.py",
                "lightgbm_tpu_torch/ingest.py",
                "lightgbm_tpu_torch/online.py")
_SCOPE_DIRS = ("lightgbm_tpu_torch/obs/", "lightgbm_tpu_torch/fleet/")


def _in_scope(relpath: str) -> bool:
    return (relpath in _SCOPE_FILES or relpath.startswith(_SCOPE_DIRS)
            or relpath.startswith("<"))          # fixtures stay in scope


@register
class LockOrder(Rule):
    name = "lock-order"
    severity = "error"
    description = ("inconsistent lock acquisition order across the serve/"
                   "online/obs call graph (potential deadlock), plus "
                   "check-then-act re-acquisition races")
    rationale = ("two threads taking the same pair of locks in opposite "
                 "orders deadlock under load; the inversion spans modules "
                 "and only exists in the composed call graph")

    # -- per-module: check-then-act escalation --
    def check_module(self, ctx: ModuleContext) -> None:
        if not _in_scope(ctx.relpath) or ctx.facts is None:
            return
        for node in walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_then_act(ctx, node)

    def _check_then_act(self, ctx: ModuleContext, fn: ast.AST) -> None:
        builder = _rebuilder(ctx)
        withs: Dict[str, List[ast.With]] = {}
        cls = _enclosing_class(ctx, fn)
        for node in walk(fn):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if _innermost_function(ctx, node) is not fn:
                continue       # nested defs get their own visit
            for item in node.items:
                lid = builder.resolve_lock_expr(item.context_expr, cls,
                                                fn.name, {})
                if lid is not None:
                    withs.setdefault(lid, []).append(node)
        for lid, blocks in withs.items():
            blocks.sort(key=lambda w: w.lineno)
            for i, first in enumerate(blocks):
                stored = _names_stored(first)
                if not stored:
                    continue
                for second in blocks[i + 1:]:
                    used = stored & _names_loaded(second)
                    if used:
                        ctx.report(
                            self, second,
                            f"check-then-act on {_short(lid)}: "
                            f"{', '.join(sorted(used))!s} captured under the "
                            f"lock at line {first.lineno} is consumed under "
                            "a separate re-acquisition — another thread may "
                            "have changed the state in between; widen the "
                            "critical section or re-validate inside it",
                            severity="warning")
                        break

    # -- repo-wide: acquisition-order graph + cycle detection --
    def check_repo(self, facts, emit) -> None:
        funcs = [f for f in facts.all_functions() if _in_scope(f.module)]
        if not funcs:
            return
        res = _Resolver(facts, funcs)
        trans = _transitive_acquires(funcs, res)

        # edge: (A, B) -> (path, line, description of the site)
        edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        for f in funcs:
            for a in f.acquires:
                for h in a.held:
                    self._note_edge(facts, emit, edges, h, a.lock_id,
                                    f.module, a.line,
                                    f"{f.qual}() acquires {_short(a.lock_id)}"
                                    f" while holding {_short(h)}")
            for c in f.calls:
                if not c.held:
                    continue
                for callee in res.resolve(c, f, trans):
                    for b in trans.get(callee.qual + "@" + callee.module,
                                       ()):
                        for h in c.held:
                            self._note_edge(
                                facts, emit, edges, h, b, f.module, c.line,
                                f"{f.qual}() calls {callee.qual}() — which "
                                f"acquires {_short(b)} — while holding "
                                f"{_short(h)}")

        self._report_cycles(edges, emit)

    def _note_edge(self, facts, emit, edges, a: str, b: str, path: str,
                   line: int, desc: str) -> None:
        if a == b:
            # re-acquiring a held non-reentrant Lock is a self-deadlock;
            # RLocks (and unknown kinds) are assumed reentrant
            if facts.lock_kind(a) == "Lock":
                emit(path, line,
                     f"self-deadlock: {desc} — {_short(a)} is a "
                     "non-reentrant threading.Lock, so this acquisition "
                     "blocks forever; use an RLock or restructure")
            return
        edges.setdefault((a, b), (path, line, desc))

    def _report_cycles(self, edges, emit) -> None:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
        seen_cycles: Set[Tuple[str, ...]] = set()
        for start in sorted(graph):
            cyc = _find_cycle(graph, start)
            if not cyc:
                continue
            canon = _canonical(cyc)
            if canon in seen_cycles:
                continue
            seen_cycles.add(canon)
            # anchor the finding at the lexically first edge of the cycle
            cycle_edges = [(cyc[i], cyc[(i + 1) % len(cyc)])
                           for i in range(len(cyc))]
            sites = [edges[e] for e in cycle_edges if e in edges]
            path, line, _ = min(sites, key=lambda s: (s[0], s[1]))
            order = " -> ".join(_short(l) for l in cyc + (cyc[0],))
            detail = "; ".join(f"{p}:{n}: {d}" for p, n, d in sites)
            emit(path, line,
                 f"lock-order cycle (potential deadlock): {order}. "
                 f"Sites: {detail}")


# ---------------------------------------------------------------------------
# helpers


def _short(lock_id: str) -> str:
    path, _, name = lock_id.partition("::")
    return f"{name} ({path.rsplit('/', 1)[-1]})"


def _rebuilder(ctx: ModuleContext):
    """Pass 1's collector for this module, used to re-resolve lock exprs when
    walking the AST in pass 2 (kept off the ModuleFacts to keep facts
    pickle-simple)."""
    from .. import facts as facts_mod
    b = facts_mod._ModuleFactsBuilder(ctx.relpath, ctx.tree)
    b._scan_module_level()
    b._scan_classes_for_locks()
    return b


def _innermost_function(ctx: ModuleContext, node: ast.AST) -> Optional[ast.AST]:
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _enclosing_class(ctx: ModuleContext, fn: ast.AST) -> Optional[str]:
    for anc in ctx.ancestors(fn):
        if isinstance(anc, ast.ClassDef):
            return anc.name
    return None


def _names_stored(block: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in walk(block):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _names_loaded(block: ast.AST) -> Set[str]:
    return {n.id for n in walk(block)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _transitive_acquires(funcs, res: "_Resolver") -> Dict[str, Set[str]]:
    """Fixpoint of "locks this function (or anything it calls) acquires",
    keyed by ``qual@module``."""
    trans: Dict[str, Set[str]] = {
        f.qual + "@" + f.module: {a.lock_id for a in f.acquires}
        for f in funcs}
    changed = True
    while changed:
        changed = False
        for f in funcs:
            key = f.qual + "@" + f.module
            cur = trans[key]
            for c in f.calls:
                for callee in res.resolve(c, f, trans):
                    extra = trans.get(callee.qual + "@" + callee.module, set())
                    if not extra <= cur:
                        cur |= extra
                        changed = True
    return trans


class _Resolver:
    """Receiver-aware callee resolution over the pass-1 facts.

    Name-only matching sprays edges: ``self._ring.clear()`` (a deque) must
    NOT resolve to every ``clear`` method in the repo. Resolution therefore
    follows what the receiver expression says:

    - bare call -> same-module function of that name, else any module's;
    - ``self.m()`` -> the caller's own class's ``m`` only;
    - ``self.attr.m()`` -> class of ``self.attr = SomeClass(...)`` from
      ``__init__`` (pass-1 ``attr_instance_of``), else UNRESOLVED;
    - ``X.m()`` / ``mod.X.m()`` -> the class of the module-level singleton
      ``X = SomeClass(...)`` wherever it is defined (singleton names are
      repo-unique in practice), else ``X``'s module's top-level ``m`` when
      ``X`` names a scanned module, else UNRESOLVED;
    - anything else -> UNRESOLVED.

    UNRESOLVED sites contribute no edges: a linter edge must be defensible,
    and the runtime lockwatch catches whatever static resolution misses.
    Only lock-acquiring candidates count (lock-free helpers can't add
    edges)."""

    def __init__(self, facts, funcs) -> None:
        self.facts = facts
        self.by_name: Dict[str, List] = {}
        for f in funcs:
            self.by_name.setdefault(f.name, []).append(f)
        # singleton name -> [(module relpath, class name)]
        self.singletons: Dict[str, List[Tuple[str, str]]] = {}
        for rel, m in facts.modules.items():
            for var, cls in m.instance_of.items():
                self.singletons.setdefault(var, []).append((rel, cls))
        # module basename (and package dir name for __init__) -> relpath
        self.mod_by_name: Dict[str, List[str]] = {}
        for rel in facts.modules:
            base = rel.rsplit("/", 1)[-1][:-3]
            if base == "__init__" and "/" in rel:
                base = rel.rsplit("/", 2)[-2]
            self.mod_by_name.setdefault(base, []).append(rel)

    def resolve(self, call, caller, trans) -> List:
        cands = self._candidates(call, caller)
        return [f for f in cands if trans.get(f.qual + "@" + f.module)]

    def _candidates(self, call, caller) -> List:
        cands = self.by_name.get(call.name, ())
        r = call.receiver
        if not call.is_method:                     # bare name
            same = [f for f in cands if f.module == caller.module]
            return same or list(cands)
        if r == "self":
            if "." not in caller.qual:
                return []
            cls = caller.qual.split(".", 1)[0]
            return [f for f in cands if f.module == caller.module
                    and f.qual == f"{cls}.{call.name}"]
        if r is None or r == "?":
            return []
        if r.startswith("self."):
            if "." not in caller.qual:
                return []
            cls = caller.qual.split(".", 1)[0]
            m = self.facts.modules.get(caller.module)
            inst = m.attr_instance_of.get((cls, r[5:])) if m else None
            if inst is None:
                return []
            return [f for f in cands if f.module == caller.module
                    and f.qual == f"{inst}.{call.name}"]
        # "X" or "mod.X": module-level singleton, or a module itself
        var = r.rsplit(".", 1)[-1]
        hits = []
        for rel, cls in self.singletons.get(var, ()):
            hits.extend(f for f in cands
                        if f.module == rel and f.qual == f"{cls}.{call.name}")
        if hits or "." in r:
            return hits
        for rel in self.mod_by_name.get(var, ()):
            hits.extend(f for f in cands
                        if f.module == rel and f.qual == call.name)
        return hits


def _find_cycle(graph: Dict[str, Set[str]], start: str) \
        -> Optional[Tuple[str, ...]]:
    """First simple cycle reachable from ``start`` (DFS with path stack)."""
    path: List[str] = []
    on_path: Set[str] = set()
    done: Set[str] = set()

    def dfs(node: str) -> Optional[Tuple[str, ...]]:
        path.append(node)
        on_path.add(node)
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                i = path.index(nxt)
                return tuple(path[i:])
            if nxt not in done:
                found = dfs(nxt)
                if found:
                    return found
        path.pop()
        on_path.discard(node)
        done.add(node)
        return None

    return dfs(start)


def _canonical(cycle: Tuple[str, ...]) -> Tuple[str, ...]:
    i = cycle.index(min(cycle))
    return cycle[i:] + cycle[:i]
