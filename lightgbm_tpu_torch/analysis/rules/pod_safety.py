"""The cross-process rule family of the port (the reference's tpu-lint v3).

Multi-process training has three bug classes that only surface with more
than one rank, where they hang or silently corrupt instead of erroring:

- a collective reachable under rank-dependent control flow: the ranks that
  skip the branch never enter the rendezvous and the others wait forever
  (ROADMAP C18: ``engine._write_snapshot`` sent only the writer rank into
  ``get_resume_state``, whose lazy-CEGB gather is a collective);
- two rank-divergent code paths issuing the same collectives in different
  ORDER: every rank enters a rendezvous, but rank A's all_reduce pairs
  with rank B's all_gather and the payloads are garbage with no diagnostic;
- a cross-process payload not routed through the wire codec in
  ``parallel/multihost.py`` (``wire-dtype``): the codec sends raw uint8
  bytes with their dtype and shape negotiated, and sums in f32 staged
  through the host for gloo; a raw ``dist.all_gather`` elsewhere pairs
  tensors whose dtype, shape and device every rank must already agree
  on, and a disagreement hangs NCCL or fails only on the multi-card path.

The first two compose the pass-1 call graph (``facts.FunctionFacts.calls``
+ per-branch-arm sequences from ``facts.Branch``): a branch arm "reaches" a
collective if any call in it transitively issues one. Resolution is by bare
callee name, preferring same-module definitions — the same convention the
lock-order graph uses.

The reference's ``nonaddressable-access`` has no torch form: a torch
tensor lives on one device of one process, and the port keeps no array
that spans processes (the trainer's row state is every rank's whole vector,
its bins are local, ``parallel/multihost.py``), so there is nothing a rank
can materialize that it does not hold; another rank's rows reach it only as
the output of a collective (``allgather_rows``, ``gather_rows_tensor``),
which the two rules above already audit.
"""
from __future__ import annotations

import ast

from ..astwalk import walk
from typing import Dict, List, Optional, Set, Tuple

from ..core import ModuleContext, Rule, register
from ..facts import RENDEZVOUS_COLLECTIVES

# the blessed raw torch.distributed sites: the wire codec's gather primitive
# and the cross-rank sum in parallel/multihost.py; everything else goes
# through them or carries a justified suppression
_WIRE_MODULE = "lightgbm_tpu_torch/parallel/multihost.py"
_WIRE_BLESSED_FUNCS = {"_gather_raw", "allreduce_sum"}
_WIRE_CALLS = {"all_gather", "all_reduce", "broadcast", "all_gather_object",
               "broadcast_object_list", "all_to_all", "reduce_scatter",
               "gather", "scatter", "reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "send", "recv", "isend", "irecv"}

# call-graph depth cap: collective closure memoizes, this only bounds
# pathological recursion through unresolvable name collisions
_MAX_DEPTH = 12


# ---------------------------------------------------------------------------
# call-graph collective closure


def _function_index(facts) -> Dict[str, List]:
    """Bare function name -> FunctionFacts (all modules), in deterministic
    (module, qual) order so name-collision resolution is stable."""
    idx: Dict[str, List] = {}
    for ff in sorted(facts.all_functions(),
                     key=lambda f: (f.module, f.qual)):
        idx.setdefault(ff.name, []).append(ff)
    return idx


# bare names that are overwhelmingly builtin/container methods: resolving
# them to a same-named repo function (list.append -> Dataset.append) wires
# unrelated call chains together and poisons the closure
_NEVER_RESOLVE = frozenset({
    "append", "extend", "insert", "pop", "add", "remove", "discard",
    "get", "items", "keys", "values", "update", "setdefault", "copy",
    "join", "split", "strip", "format", "encode", "decode", "sum",
    "write", "read", "flush", "close", "open", "put", "mean", "max",
    "min", "sort", "index", "count",
})


def _resolve(idx: Dict[str, List], name: str, module: str):
    """The FunctionFacts a bare call name refers to, preferring a definition
    in the caller's own module; None when unknown (stdlib/jax/etc.).

    Underscore-private names resolve only within their own module — a
    ``_callback``-style hook variable in one module must not bind to an
    unrelated private helper elsewhere."""
    if name in _NEVER_RESOLVE:
        return None
    cands = idx.get(name)
    if not cands:
        return None
    local = [c for c in cands if c.module == module]
    if local:
        return local[0]
    if name.startswith("_"):
        return None
    return cands[0]


class _Closure:
    """Memoized flattened collective sequences over the repo call graph."""

    def __init__(self, facts):
        self.idx = _function_index(facts)
        self._memo: Dict[Tuple[str, str], Tuple[str, ...]] = {}

    def of_function(self, ff, _depth: int = 0) -> Tuple[str, ...]:
        key = (ff.module, ff.qual)
        if key in self._memo:
            return self._memo[key]
        if _depth > _MAX_DEPTH:
            return ()
        self._memo[key] = ()          # cycle guard: recursion sees ()
        seq = self.of_events(
            tuple((c.name, c.line) for c in ff.calls), ff.module,
            _depth=_depth)
        self._memo[key] = seq
        return seq

    def of_events(self, events: Tuple[Tuple[str, int], ...], module: str,
                  _depth: int = 0) -> Tuple[str, ...]:
        """Flattened collective op sequence for an ordered (name, line)
        event list: direct collective names verbatim, other callees expanded
        through their own closure."""
        out: List[str] = []
        for name, _line in sorted(events, key=lambda p: p[1]):
            if name in RENDEZVOUS_COLLECTIVES:
                out.append(name)
                continue
            callee = _resolve(self.idx, name, module)
            if callee is not None:
                out.extend(self.of_function(callee, _depth=_depth + 1))
        return tuple(out)


def _branch_desc(br) -> str:
    marks = ", ".join(br.markers) if br.markers else "a rank-derived local"
    return f"branch conditioned on {marks}"


# ---------------------------------------------------------------------------


@register
class CollectiveDivergence(Rule):
    name = "collective-divergence"
    severity = "error"
    description = ("collective reachable under a rank-dependent branch "
                   "that other ranks skip (deadlock-by-skipped-collective)")
    rationale = ("process_index/is_writer-style conditions partition the "
                 "group; a rendezvous entered by only some arms hangs the "
                 "ranks that did enter it, with no error anywhere — the "
                 "engine.py snapshot hang class (ROADMAP C18)")

    def check_module(self, ctx: ModuleContext) -> None:
        return          # purely cross-module: everything happens in check_repo

    def check_repo(self, facts, emit) -> None:
        clo = _Closure(facts)
        for ff in facts.all_functions():
            for br in ff.branches:
                if not br.rank_dependent:
                    continue
                arm_seqs = [clo.of_events(a.events, ff.module)
                            for a in br.arms]
                arm_sets = [frozenset(s) for s in arm_seqs]
                union: Set[str] = set().union(*arm_sets) if arm_sets else set()
                if not union:
                    continue
                if all(s == union for s in arm_sets):
                    continue          # every arm reaches every collective
                ops = ", ".join(sorted(union))
                emit(ff.module, br.line,
                     f"{_branch_desc(br)} reaches collective(s) [{ops}] in "
                     "some arms but not all: ranks taking the other arm "
                     "never enter the rendezvous and the pod deadlocks — "
                     "hoist the collective out of the branch or make every "
                     "arm issue the same collective sequence "
                     f"(in {ff.qual})")


@register
class CollectiveOrder(Rule):
    name = "collective-order"
    severity = "error"
    description = ("rank-divergent branch arms issue the same collectives "
                   "in different order or multiplicity")
    rationale = ("when every rank enters a rendezvous but in a different "
                 "order, psums pair with all_gathers across ranks and the "
                 "payloads are silently corrupt (or the shapes hang) — "
                 "order must be verified per code path, not per function")

    def check_module(self, ctx: ModuleContext) -> None:
        return          # purely cross-module: everything happens in check_repo

    def check_repo(self, facts, emit) -> None:
        clo = _Closure(facts)
        for ff in facts.all_functions():
            for br in ff.branches:
                if not br.rank_dependent:
                    continue
                arm_seqs = [clo.of_events(a.events, ff.module)
                            for a in br.arms]
                nonempty = [s for s in arm_seqs if s]
                if len(nonempty) < 2:
                    continue
                sets = {frozenset(s) for s in nonempty}
                if len(sets) != 1:
                    continue          # set mismatch: collective-divergence
                if len(set(nonempty)) == 1:
                    continue          # identical sequences: consistent
                shown = " vs ".join(
                    "[" + ", ".join(s) + "]" for s in dict.fromkeys(nonempty))
                emit(ff.module, br.line,
                     f"{_branch_desc(br)}: arms issue the same collectives "
                     f"in different sequences ({shown}) — ranks taking "
                     "different arms pair mismatched rendezvous and the "
                     "payloads corrupt silently; make the per-arm "
                     f"collective order identical (in {ff.qual})")


@register
class WireDtype(Rule):
    name = "wire-dtype"
    severity = "error"
    description = ("raw torch.distributed collective outside the wire "
                   "codec in parallel/multihost.py")
    rationale = ("the codec negotiates each payload's dtype and shape and "
                 "stages gloo sums through the host; a raw collective "
                 "elsewhere pairs tensors every rank must already agree "
                 "on, and a mismatch hangs or corrupts only across "
                 "processes")

    def check_module(self, ctx: ModuleContext) -> None:
        direct = self._direct_imports(ctx)
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = self._raw_collective(ctx, node.func, direct)
            if name is None:
                continue
            if ctx.relpath == _WIRE_MODULE and \
                    self._enclosing_func(ctx, node) in _WIRE_BLESSED_FUNCS:
                continue
            ctx.report(
                self, node,
                f"torch.distributed.{name}() outside the multihost.py wire "
                "codec: the ranks must agree on the payload's dtype, shape "
                "and device with no negotiation — route it through "
                "parallel/multihost.wire_allgather / allreduce_sum, or "
                "justify why the payload cannot differ across ranks")

    @staticmethod
    def _direct_imports(ctx: ModuleContext) -> Set[str]:
        """Collectives imported by name from torch.distributed."""
        out: Set[str] = set()
        for node in walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and \
                    node.module == "torch.distributed":
                out.update(a.asname or a.name for a in node.names
                           if a.name in _WIRE_CALLS)
        return out

    @staticmethod
    def _raw_collective(ctx: ModuleContext, f: ast.AST,
                        direct: Set[str]) -> Optional[str]:
        if isinstance(f, ast.Name):
            return f.id if f.id in direct else None
        if not isinstance(f, ast.Attribute) or f.attr not in _WIRE_CALLS:
            return None
        base = f.value
        if isinstance(base, ast.Name) and base.id in ctx.dist_aliases:
            return f.attr
        if isinstance(base, ast.Attribute) and base.attr == "distributed" \
                and isinstance(base.value, ast.Name) and \
                base.value.id in ctx.torch_aliases:
            return f.attr
        return None

    @staticmethod
    def _enclosing_func(ctx: ModuleContext, node: ast.AST) -> Optional[str]:
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc.name
        return None
