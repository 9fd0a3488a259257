"""The port's lint, pass 1: per-module facts for the dataflow-aware rules.

The counterpart of ``lightgbm_tpu/analysis/facts.py``. It walks each
module ONCE and extracts the cross-cutting facts the concurrency and
collective rules need:

- the lock landscape: every ``threading.Lock()``/``RLock()`` creation site
  (module-level, ``self._lock = ...`` class attributes, function locals),
  every ``with <lock>:`` acquisition with the set of locks already held at
  that point, and every call made while holding a lock (the raw material for
  the cross-module acquisition-order graph);
- rank-dependent branches: every ``if/elif/else`` chain whose test reads a
  per-rank value, with each arm's ordered callees (the raw material of
  collective-divergence and collective-order);
- axis uses: every string literal given as a mesh axis name
  (``axis_name=``, ``feature_axis_name=``, ``Mesh(devices, ("data",))``,
  ``mesh_axis``), for collective-consistency.

The reference's jit, donation and shard_map facts have no counterpart: the
port compiles nothing at run time (no ``torch.compile``, no TorchScript).

Like everything in ``analysis/``, this is pure stdlib ``ast``: no torch, no
package imports. Identity conventions: a lock is ``"<relpath>::<name>"`` for
module-level locks, ``"<relpath>::<Class>.<attr>"`` for instance locks, and
``"<relpath>::<func>.<name>"`` for function locals, so the same source lock
gets the same node in the repo-wide graph no matter which module acquires it.
"""
from __future__ import annotations

import ast

from .astwalk import walk
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

_LOCK_FACTORIES = {"Lock", "RLock", "allocate_lock"}

# The port's cross-process collectives: the raw torch.distributed ones, the
# parallel/multihost.py and fence.py wrappers the rest of the port calls,
# and the growers' cross-rank sum. Every rank MUST enter each of these or
# the group hangs. (The in-process shard sums, ``_psum`` over one process's
# devices, rendezvous with nothing and are not listed.) The reference's jax
# names stay in the sets, so that both linters give the same findings on the
# reference's fixtures; the port calls none of them.
PROC_COLLECTIVES = {
    "all_gather", "all_reduce", "broadcast", "all_gather_object",
    "broadcast_object_list", "all_to_all", "reduce_scatter", "barrier",
    "wire_allgather", "allgather_sketches", "allgather_rows",
    "gather_rows_tensor", "allreduce_sum", "consistency_fence",
    "mesh_preflight", "_xsum",
    # the reference's
    "process_allgather", "broadcast_one_to_all", "sync_global_devices",
}

# everything that rendezvous across ranks: the above and the reference's
# in-jit device collectives
RENDEZVOUS_COLLECTIVES = PROC_COLLECTIVES | {
    "psum", "pmean", "pmax", "pmin", "ppermute", "psum_scatter"}

# Names whose VALUE differs per rank. A branch conditioned on one of these
# (directly or through a local assigned from one) partitions the group: a
# collective under only some arms is a deadlock-by-skipped-collective.
RANK_SOURCES = {"process_index", "is_writer_rank", "host_row_range"}

# keyword / dict-key names whose string value names a mesh axis
AXIS_KEYWORDS = {"axis_name", "feature_axis_name", "feature_axis",
                 "mesh_axis"}


@dataclasses.dataclass(frozen=True)
class LockDef:
    lock_id: str
    kind: str          # "Lock" | "RLock" | "unknown"
    path: str
    line: int


@dataclasses.dataclass(frozen=True)
class Acquire:
    lock_id: str
    line: int
    held: Tuple[str, ...]     # lock ids already held (lexically) at this site


@dataclasses.dataclass(frozen=True)
class CallSite:
    name: str                 # bare name or method attr
    line: int
    held: Tuple[str, ...]
    is_method: bool
    # who the method was called on: None (bare call), "self",
    # "NAME" (a plain-name receiver: singleton, module or local),
    # "self.attr" (an instance attribute), "mod.NAME" (a module-qualified
    # singleton), or "?" (anything more complex — unresolvable)
    receiver: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BranchArm:
    """One arm of an ``if``/``elif``/``else`` chain: the ordered callee
    names lexically inside it (nested compounds included, nested ``def``
    bodies excluded — they do not run when the arm runs)."""
    line: int
    events: Tuple[Tuple[str, int], ...]   # ordered (callee name, line)


@dataclasses.dataclass(frozen=True)
class Branch:
    """A flattened ``if/elif/else`` chain inside a function body. The
    implicit empty ``else`` of a chain with no ``orelse`` is materialized as
    a trailing empty arm so "the other ranks do nothing" is comparable."""
    line: int
    rank_dependent: bool
    markers: Tuple[str, ...]              # RANK_SOURCES seen in the tests
    arms: Tuple[BranchArm, ...]


@dataclasses.dataclass
class FunctionFacts:
    module: str               # relpath
    qual: str                 # "func" or "Class.method"
    line: int
    acquires: List[Acquire]
    calls: List[CallSite]
    branches: List[Branch] = dataclasses.field(default_factory=list)

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class AxisUse:
    """A string literal naming a mesh axis: ``where`` is the keyword or
    the constructor that takes it."""
    where: str
    axis: str
    line: int


@dataclasses.dataclass
class ModuleFacts:
    relpath: str
    lock_defs: Dict[str, LockDef]              # lock_id -> def
    functions: Dict[str, FunctionFacts]        # qual -> facts
    axis_uses: List[AxisUse]
    instance_of: Dict[str, str]                # module var -> class name
    attr_instance_of: Dict[Tuple[str, str], str]  # (cls, attr) -> class name

    def lock_kind(self, lock_id: str) -> str:
        d = self.lock_defs.get(lock_id)
        return d.kind if d else "unknown"


@dataclasses.dataclass
class RepoFacts:
    modules: Dict[str, ModuleFacts]
    mesh_axes: Set[str]

    def all_functions(self) -> List[FunctionFacts]:
        return [f for m in self.modules.values()
                for f in m.functions.values()]

    def lock_kind(self, lock_id: str) -> str:
        path = lock_id.split("::", 1)[0]
        m = self.modules.get(path)
        return m.lock_kind(lock_id) if m else "unknown"


# ---------------------------------------------------------------------------
# per-module extraction


def _is_lock_factory_call(node: ast.AST) -> Optional[str]:
    """``threading.Lock()`` / ``RLock()`` / ``_thread.allocate_lock()`` ->
    the lock kind, else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else ""
    if name in _LOCK_FACTORIES:
        return "Lock" if name == "allocate_lock" else name
    return None


class _ModuleFactsBuilder(ast.NodeVisitor):
    """Single walk collecting lock defs/acquisitions, calls-under-lock,
    branches and axis literals."""

    def __init__(self, relpath: str, tree: ast.Module):
        self.relpath = relpath
        self.tree = tree
        self.lock_defs: Dict[str, LockDef] = {}
        self.class_locks: Dict[Tuple[str, str], str] = {}   # (cls, attr)->kind
        self.instance_of: Dict[str, str] = {}               # mod var -> class
        self.attr_instance_of: Dict[Tuple[str, str], str] = {}
        self.functions: Dict[str, FunctionFacts] = {}
        self.axis_uses: List[AxisUse] = []

    # -- entry --
    def build(self) -> ModuleFacts:
        self._scan_module_level()
        self._scan_classes_for_locks()
        for node in self.tree.body:
            self._walk_scope(node, cls=None, func=None)
        self._scan_axis_literals()
        return ModuleFacts(relpath=self.relpath, lock_defs=self.lock_defs,
                           functions=self.functions,
                           axis_uses=self.axis_uses,
                           instance_of=self.instance_of,
                           attr_instance_of=self.attr_instance_of)

    # -- module-level lock defs + singleton instances --
    def _scan_module_level(self) -> None:
        for node in self.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            kind = _is_lock_factory_call(node.value)
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if kind:
                    lid = f"{self.relpath}::{t.id}"
                    self.lock_defs[lid] = LockDef(lid, kind, self.relpath,
                                                  node.lineno)
                elif isinstance(node.value, ast.Call) and \
                        isinstance(node.value.func, ast.Name):
                    self.instance_of[t.id] = node.value.func.id

    def _scan_classes_for_locks(self) -> None:
        for node in self.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in walk(node):
                if not isinstance(sub, ast.Assign):
                    continue
                kind = _is_lock_factory_call(sub.value)
                for t in sub.targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    if kind:
                        self.class_locks[(node.name, t.attr)] = kind
                        lid = f"{self.relpath}::{node.name}.{t.attr}"
                        self.lock_defs[lid] = LockDef(lid, kind, self.relpath,
                                                      sub.lineno)
                    elif isinstance(sub.value, ast.Call) and \
                            isinstance(sub.value.func, ast.Name):
                        # self.attr = SomeClass(...): instance attribute —
                        # lets pass 2 resolve self.attr.method() precisely
                        self.attr_instance_of[(node.name, t.attr)] = \
                            sub.value.func.id

    # -- lock identity resolution --
    def resolve_lock_expr(self, expr: ast.AST, cls: Optional[str],
                          func: Optional[str],
                          local_locks: Dict[str, str]) -> Optional[str]:
        if isinstance(expr, ast.Name):
            lid = f"{self.relpath}::{expr.id}"
            if lid in self.lock_defs:
                return lid
            if expr.id in local_locks:
                return local_locks[expr.id]
            if "lock" in expr.id.lower():
                return lid
            return None
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and cls is not None:
                    if (cls, expr.attr) in self.class_locks or \
                            "lock" in expr.attr.lower():
                        return f"{self.relpath}::{cls}.{expr.attr}"
                    return None
                inst_cls = self.instance_of.get(base.id)
                if inst_cls is not None and \
                        ((inst_cls, expr.attr) in self.class_locks
                         or "lock" in expr.attr.lower()):
                    return f"{self.relpath}::{inst_cls}.{expr.attr}"
                if "lock" in expr.attr.lower():
                    return f"{self.relpath}::{base.id}.{expr.attr}"
            elif "lock" in expr.attr.lower():
                return f"{self.relpath}::?.{expr.attr}"
        return None

    # -- function bodies: acquisitions + calls with held-lock context --
    def _walk_scope(self, node: ast.AST, cls: Optional[str],
                    func: Optional[str]) -> None:
        if isinstance(node, ast.ClassDef):
            for child in node.body:
                self._walk_scope(child, cls=node.name, func=None)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{cls}.{node.name}" if cls else node.name
            ff = self.functions.setdefault(
                qual, FunctionFacts(module=self.relpath, qual=qual,
                                    line=node.lineno, acquires=[], calls=[]))
            local_locks: Dict[str, str] = {}
            for child in node.body:
                self._visit_stmt(child, cls, qual, ff, (), local_locks)
            _scan_branches(node, ff)
            return
        # other module-level statements: nothing to do

    def _visit_stmt(self, node: ast.AST, cls: Optional[str], qual: str,
                    ff: FunctionFacts, held: Tuple[str, ...],
                    local_locks: Dict[str, str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: its body is a separate function scope
            self._walk_scope(node, cls=cls, func=qual)
            return
        if isinstance(node, ast.ClassDef):
            self._walk_scope(node, cls=node.name, func=None)
            return
        if isinstance(node, ast.Assign):
            kind = _is_lock_factory_call(node.value)
            if kind:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        lid = f"{self.relpath}::{qual}.{t.id}"
                        local_locks[t.id] = lid
                        self.lock_defs[lid] = LockDef(lid, kind, self.relpath,
                                                      node.lineno)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                lid = self.resolve_lock_expr(item.context_expr, cls, qual,
                                             local_locks)
                self._visit_expr(item.context_expr, qual, ff, inner)
                if lid is not None:
                    ff.acquires.append(Acquire(lid, node.lineno, inner))
                    inner = inner + (lid,)
            for child in node.body:
                self._visit_stmt(child, cls, qual, ff, inner, local_locks)
            return
        # generic statement: record calls in expressions, recurse into
        # compound bodies with unchanged held-set
        for field in ast.iter_child_nodes(node):
            if isinstance(field, ast.stmt):
                self._visit_stmt(field, cls, qual, ff, held, local_locks)
            else:
                self._visit_expr(field, qual, ff, held)

    def _visit_expr(self, node: ast.AST, qual: str, ff: FunctionFacts,
                    held: Tuple[str, ...]) -> None:
        for sub in walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Attribute):
                    ff.calls.append(CallSite(f.attr, sub.lineno, held, True,
                                             _receiver_of(f.value)))
                elif isinstance(f, ast.Name):
                    ff.calls.append(CallSite(f.id, sub.lineno, held, False))

    # -- mesh axis literals --
    def _scan_axis_literals(self) -> None:
        def lit(node: ast.AST) -> Optional[str]:
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                return node.value
            return None

        for node in walk(self.tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    v = lit(kw.value) if kw.arg in AXIS_KEYWORDS else None
                    if v is not None:
                        self.axis_uses.append(AxisUse(kw.arg, v, node.lineno))
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else \
                    f.id if isinstance(f, ast.Name) else ""
                # Mesh(devices, ("data", "feature"))
                if name == "Mesh" and len(node.args) > 1 and \
                        isinstance(node.args[1], (ast.Tuple, ast.List)):
                    for e in node.args[1].elts:
                        v = lit(e)
                        if v is not None:
                            self.axis_uses.append(AxisUse("Mesh", v,
                                                          node.lineno))
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if lit(k) in AXIS_KEYWORDS and lit(v) is not None:
                        self.axis_uses.append(AxisUse(lit(k), lit(v),
                                                      node.lineno))
            elif isinstance(node, ast.Compare) and \
                    isinstance(node.left, ast.Attribute) and \
                    node.left.attr in AXIS_KEYWORDS | {"axis_names"}:
                for comp in node.comparators:
                    v = lit(comp)
                    if v is not None:
                        self.axis_uses.append(AxisUse(node.left.attr, v,
                                                      node.lineno))


def _receiver_of(base: ast.AST) -> str:
    """Encode a method call's receiver expression (see CallSite.receiver)."""
    if isinstance(base, ast.Name):
        return "self" if base.id == "self" else base.id
    if isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name):
        if base.value.id == "self":
            return f"self.{base.attr}"
        return f"{base.value.id}.{base.attr}"
    return "?"


# ---------------------------------------------------------------------------
# branch facts: rank-dependent conditions + per-arm call sequences


def _calls_under(stmts) -> Tuple[Tuple[str, int], ...]:
    """Ordered (callee name, line) lexically under ``stmts``, pruning nested
    ``def``/``class``/lambda bodies (those do not run when the arm runs)."""
    out: List[Tuple[str, int]] = []

    def rec(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                f = child.func
                name = f.attr if isinstance(f, ast.Attribute) else \
                    f.id if isinstance(f, ast.Name) else ""
                if name:
                    out.append((name, child.lineno))
            rec(child)

    for s in stmts:
        rec(s)
    out.sort(key=lambda p: p[1])
    return tuple(out)


def _scan_branches(fnode: ast.AST, ff: FunctionFacts) -> None:
    """Collect every ``if/elif/else`` chain in ``fnode``'s body with (a)
    whether any condition in the chain is rank-dependent — mentions a
    ``RANK_SOURCES`` name/attr or a local assigned from one (one-level
    lexical taint, statements in source order) — and (b) each arm's ordered
    callee names, for the collective-divergence/-order rules."""
    tainted: Set[str] = set()

    def markers_of(expr: ast.AST) -> Tuple[Set[str], bool]:
        marks: Set[str] = set()
        via_taint = False

        def scan(sub: ast.AST) -> None:
            nonlocal via_taint
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return
            if isinstance(sub, ast.Call):
                f = sub.func
                callee = f.attr if isinstance(f, ast.Attribute) else \
                    f.id if isinstance(f, ast.Name) else ""
                if callee in PROC_COLLECTIVES:
                    # an allgather's OUTPUT is rank-uniform by construction
                    # even when its arguments mention process_index — do not
                    # propagate taint out of the collective
                    return
            if isinstance(sub, ast.Name):
                if sub.id in RANK_SOURCES:
                    marks.add(sub.id)
                elif sub.id in tainted:
                    via_taint = True
            elif isinstance(sub, ast.Attribute) and sub.attr in RANK_SOURCES:
                marks.add(sub.attr)
            for child in ast.iter_child_nodes(sub):
                scan(child)

        scan(expr)
        return marks, via_taint

    def taint_assign(stmt: ast.AST) -> None:
        value = getattr(stmt, "value", None)
        if value is None:
            return
        marks, via = markers_of(value)
        if not marks and not via:
            return
        targets = stmt.targets if isinstance(stmt, ast.Assign) else \
            [stmt.target] if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)) \
            else []
        for t in targets:
            for sub in walk(t):
                # only Store-context names become tainted locals: the base
                # name of an attribute/subscript target (``self`` in
                # ``self.x = ...``) is a Load and must NOT be poisoned
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Store):
                    tainted.add(sub.id)
                elif isinstance(sub, ast.Starred) and \
                        isinstance(sub.value, ast.Name):
                    tainted.add(sub.value.id)

    def visit(stmts) -> None:
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                taint_assign(s)
                continue
            if isinstance(s, ast.If):
                tests, arm_bodies, cur = [], [], s
                while True:
                    tests.append(cur.test)
                    arm_bodies.append((cur.lineno, cur.body))
                    o = cur.orelse
                    if len(o) == 1 and isinstance(o[0], ast.If):
                        cur = o[0]
                        continue
                    # explicit else, or the implicit empty one
                    arm_bodies.append((o[0].lineno if o else cur.lineno, o))
                    break
                marks: Set[str] = set()
                dep = False
                for t in tests:
                    m, via = markers_of(t)
                    marks |= m
                    dep = dep or via
                ff.branches.append(Branch(
                    line=s.lineno, rank_dependent=bool(marks) or dep,
                    markers=tuple(sorted(marks)),
                    arms=tuple(BranchArm(line=ln, events=_calls_under(body))
                               for ln, body in arm_bodies)))
                for _ln, body in arm_bodies:
                    visit(body)
                continue
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(s, attr, None)
                if sub:
                    visit(sub)
            for h in getattr(s, "handlers", []) or []:
                visit(h.body)

    visit(getattr(fnode, "body", []))


# ---------------------------------------------------------------------------
# repo-level assembly


def build_module_facts(relpath: str, tree: ast.Module) -> ModuleFacts:
    return _ModuleFactsBuilder(relpath, tree).build()


def mesh_axes(mesh_path: Optional[str] = None) -> Set[str]:
    """Axis names declared in ``parallel/mesh.py`` (``DATA_AXIS = "data"``
    style constants), parsed without importing. Falls back to {"data"}."""
    from .core import _FACT_CACHE, PKG_DIR, _parse_file
    path = mesh_path or os.path.join(PKG_DIR, "parallel", "mesh.py")
    key = "mesh_axes:" + path
    if key in _FACT_CACHE:
        return _FACT_CACHE[key]
    out: Set[str] = set()
    tree = _parse_file(path)
    if tree is not None:
        for node in walk(tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id.endswith("_AXIS"):
                        out.add(node.value.value)
    _FACT_CACHE[key] = out or {"data"}
    return _FACT_CACHE[key]


def build_repo_facts(modules: Sequence[Tuple[str, ast.Module]]) -> RepoFacts:
    """Pass 1 over every parsed module: (relpath, tree) -> RepoFacts."""
    mods = {rel: build_module_facts(rel, tree) for rel, tree in modules}
    return RepoFacts(modules=mods, mesh_axes=set(mesh_axes()))
