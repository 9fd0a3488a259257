"""The port's lint core: rule registry, AST scan, suppressions, baseline,
reporters.

The counterpart of ``lightgbm_tpu/analysis/core.py`` for
``lightgbm_tpu_torch``: the same two-pass scan over the port's tree and
``chip_smoke.py``, for the hazard classes that carry over to PyTorch/CUDA
(non-atomic artifact writes, collectives under rank-dependent branches,
lock-order cycles, unlocked shared state, telemetry schemas, non-finite
policy literals, swallowed device errors, unregistered parameters) and
those redone for torch (host syncs in the hot loops, f64 numpy reaching
the card unasked, raw ``torch.distributed`` collectives outside the wire
codec, a rank reading another rank's rows, collective group names).

Design constraints (enforced by tests/test_torch_analysis.py):

- **No torch, no JAX, nothing of lightgbm_tpu.** Everything here is pure
  stdlib ``ast``/``tokenize`` over source text; facts about the port
  (registered params, event schemas, mesh axes, the UNCONSUMED table) are
  extracted by parsing its files as ASTs, never by importing them.
  ``LGBMTPU_LINT_ONLY=1 python -m lightgbm_tpu_torch.analysis`` runs
  without ``torch`` or ``jax`` ever entering ``sys.modules``.
- **Fast.** One parse per file, one shared walk per rule.

Workflow surfaces, the reference's:

- inline suppression: ``# tpu-lint: disable=<rule>[,<rule>...]`` on the
  flagged line (or on a standalone comment line directly above it);
  ``# tpu-lint: disable-file=<rule>`` anywhere suppresses for the module.
  The syntax is the reference's, so one comment serves both linters.
- baseline: grandfathered findings live in ``baseline.json`` next to this
  module, keyed by (rule, path, source-line text) so entries survive line
  drift; every entry carries a human justification. ``--update-baseline``
  regenerates entries (preserving justifications for findings that remain);
  a baseline entry whose finding disappeared becomes a ``stale-baseline``
  finding, so fixed code forces baseline cleanup. The port's baseline is
  empty: every finding is fixed or suppressed inline with its reason.
"""
from __future__ import annotations

import ast

from .astwalk import walk
import dataclasses
import io
import json
import os
import re
import time
import tokenize
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG_DIR = os.path.join(REPO_ROOT, "lightgbm_tpu_torch")
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")
# the default scan surface: the port and its card smoke run (the port's
# scripts/torch_*.py are already held by the reference's lint, which
# scans scripts/)
DEFAULT_PATHS = ("lightgbm_tpu_torch", "chip_smoke.py")

SEVERITIES = ("error", "warning")

_SUPPRESS_RE = re.compile(r"#\s*tpu-lint:\s*disable=([\w\-, ]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*tpu-lint:\s*disable-file=([\w\-, ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    message: str
    severity: str = "error"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.severity}] " \
               f"{self.rule}: {self.message}"


class Rule:
    """One hazard class. Subclasses set ``name``/``severity``/``description``
    /``rationale`` and implement :meth:`check_module` (AST rules) or
    :meth:`run_dynamic` (runtime smoke rules, gated behind ``--dynamic``).
    Rules that need the repo-wide pass-1 facts (lock graphs span modules)
    additionally implement :meth:`check_repo`, called once after every
    module has been analyzed."""

    name: str = ""
    severity: str = "error"
    description: str = ""
    rationale: str = ""
    kind: str = "ast"            # "ast" | "dynamic"

    def check_module(self, ctx: "ModuleContext") -> None:
        raise NotImplementedError

    def check_repo(self, facts, emit) -> None:
        """Cross-module pass: ``facts`` is a ``facts.RepoFacts``; report via
        ``emit(path, line, message, severity=None)``. Default: nothing."""

    def run_dynamic(self, device: str = "cuda") -> List[Finding]:
        """Run the runtime check on the torch ``device`` named."""
        raise NotImplementedError


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule (as a singleton instance) to the
    registry; the registry order is the report order."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if inst.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {inst.name!r}")
    _REGISTRY[inst.name] = inst
    return cls


def all_rules() -> Dict[str, Rule]:
    """Rule name -> instance; importing the rules package populates it."""
    from . import rules as _rules  # noqa: F401  (registration side effect)
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# per-module context


class ModuleContext:
    """Everything a rule needs about one module: the AST, source lines,
    parent links, import aliases, and a ``report`` sink."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.findings: List[Finding] = []
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.numpy_aliases, self.torch_aliases, self.dist_aliases = \
            _import_aliases(self.tree)
        self.line_suppressions, self.file_suppressions = \
            _parse_suppressions(source)
        # pass-1 facts, attached by the scan before rules run: this
        # module's ``facts.ModuleFacts`` and the repo-wide ``RepoFacts``
        self.facts = None
        self.repo_facts = None

    # -- reporting --
    def report(self, rule: Rule, node: Any, message: str,
               severity: Optional[str] = None) -> None:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        self.findings.append(Finding(
            rule=rule.name, path=self.relpath, line=line, message=message,
            severity=severity or rule.severity))

    # -- helpers rules share --
    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def is_np_attr(self, node: ast.AST, attr: Optional[str] = None) -> bool:
        """``node`` is ``np.<attr>`` for any imported numpy alias."""
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in self.numpy_aliases
                and (attr is None or node.attr == attr))

    def is_torch_attr(self, node: ast.AST, attr: Optional[str] = None) \
            -> bool:
        """``node`` is ``torch.<attr>`` for any imported torch alias."""
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in self.torch_aliases
                and (attr is None or node.attr == attr))

    def mentions_device_api(self, node: ast.AST) -> bool:
        """Subtree references torch (device work happens near here)."""
        for sub in walk(node):
            if isinstance(sub, ast.Name) and sub.id in self.torch_aliases:
                return True
        return False

    def code_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def is_suppressed(self, f: Finding) -> bool:
        if f.rule in self.file_suppressions or \
                "all" in self.file_suppressions:
            return True
        rules = self.line_suppressions.get(f.line, ())
        return f.rule in rules or "all" in rules


def _import_aliases(tree: ast.Module) -> Tuple[Set[str], Set[str], Set[str]]:
    """The names bound to numpy, to torch and to ``torch.distributed``."""
    numpy_a, torch_a, dist_a = set(), set(), set()
    for node in walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = a.asname or a.name.split(".")[0]
                if a.name == "numpy":
                    numpy_a.add(name)
                elif a.name == "torch.distributed":
                    (dist_a if a.asname else torch_a).add(name)
                elif a.name == "torch" or a.name.startswith("torch."):
                    torch_a.add(name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        dist_a.add(a.asname or "distributed")
    return numpy_a, torch_a, dist_a


def _parse_suppressions(source: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """Map line -> suppressed rule names (a standalone comment also covers
    the next line), plus the module-wide set from ``disable-file=``."""
    per_line: Dict[int, Set[str]] = {}
    whole_file: Set[str] = set()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except tokenize.TokenizeError:   # pragma: no cover - ast.parse ran first
        return per_line, whole_file
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_FILE_RE.search(tok.string)
        if m:
            whole_file.update(r.strip() for r in m.group(1).split(",")
                              if r.strip())
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        line = tok.start[0]
        per_line.setdefault(line, set()).update(rules)
        # a comment alone on its line shields the following line too
        if tok.line.strip().startswith("#"):
            per_line.setdefault(line + 1, set()).update(rules)
    return per_line, whole_file


# ---------------------------------------------------------------------------
# shared AST predicates (used by several rules)


def root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of an attribute/subscript chain (``a.b[0].c`` -> a)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


# ---------------------------------------------------------------------------
# package facts, extracted WITHOUT importing the package


_FACT_CACHE: Dict[str, Any] = {}


def registered_params(config_path: Optional[str] = None) -> Set[str]:
    """Canonical names + aliases from config.py's ``_PARAMS`` literal."""
    path = config_path or os.path.join(PKG_DIR, "config.py")
    key = "params:" + path
    if key in _FACT_CACHE:
        return _FACT_CACHE[key]
    names: Set[str] = set()
    tree = _parse_file(path)
    if tree is not None:
        for node in walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if not (any(isinstance(t, ast.Name) and t.id == "_PARAMS"
                            for t in targets)
                        and isinstance(node.value, ast.Dict)):
                    continue
                for k, v in zip(node.value.keys, node.value.values):
                    if isinstance(k, ast.Constant) and isinstance(k.value,
                                                                  str):
                        names.add(k.value)
                    if isinstance(v, ast.Tuple) and len(v.elts) == 2:
                        for alias in walk(v.elts[1]):
                            if isinstance(alias, ast.Constant) and \
                                    isinstance(alias.value, str):
                                names.add(alias.value)
    _FACT_CACHE[key] = names
    return names


def unconsumed_params(gbdt_path: Optional[str] = None) -> Set[str]:
    """The names of ``models/gbdt.py``'s ``UNCONSUMED`` table: accepted
    parameters the port reads nowhere, each warned about when set."""
    path = gbdt_path or os.path.join(PKG_DIR, "models", "gbdt.py")
    key = "unconsumed:" + path
    if key in _FACT_CACHE:
        return _FACT_CACHE[key]
    out: Set[str] = set()
    tree = _parse_file(path)
    if tree is not None:
        for node in walk(tree):
            if isinstance(node, ast.Assign) and \
                    any(isinstance(t, ast.Name) and t.id == "UNCONSUMED"
                        for t in node.targets) and \
                    isinstance(node.value, ast.Tuple):
                for row in node.value.elts:
                    if isinstance(row, ast.Tuple) and row.elts and \
                            isinstance(row.elts[0], ast.Constant):
                        out.add(row.elts[0].value)
    _FACT_CACHE[key] = out
    return out


def nonfinite_policies(config_path: Optional[str] = None) -> Set[str]:
    """Legal nonfinite_policy literals, read from the validation tuple in
    config.py's ``_post_process`` (falls back to the known trio)."""
    path = config_path or os.path.join(PKG_DIR, "config.py")
    key = "nfpol:" + path
    if key in _FACT_CACHE:
        return _FACT_CACHE[key]
    out: Set[str] = set()
    tree = _parse_file(path)
    if tree is not None:
        for node in walk(tree):
            if not isinstance(node, ast.Compare):
                continue
            left = node.left
            if isinstance(left, ast.Attribute) and \
                    left.attr == "nonfinite_policy":
                for comp in node.comparators:
                    for sub in walk(comp):
                        if isinstance(sub, ast.Constant) and \
                                isinstance(sub.value, str):
                            out.add(sub.value)
    _FACT_CACHE[key] = out or {"fatal", "warn_skip_tree", "clip"}
    return _FACT_CACHE[key]


def event_schemas(events_path: Optional[str] = None) \
        -> Dict[str, Tuple[Set[str], Set[str]]]:
    """Event type -> (required field names, optional field names), parsed
    from the ``EVENT_SCHEMAS`` literal in obs/events.py."""
    path = events_path or os.path.join(PKG_DIR, "obs", "events.py")
    key = "events:" + path
    if key in _FACT_CACHE:
        return _FACT_CACHE[key]
    schemas: Dict[str, Tuple[Set[str], Set[str]]] = {}
    tree = _parse_file(path)

    def dict_keys(d: ast.AST) -> Set[str]:
        return {k.value for k in getattr(d, "keys", ())
                if isinstance(k, ast.Constant) and isinstance(k.value, str)}

    if tree is not None:
        for node in walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if not any(isinstance(t, ast.Name) and t.id == "EVENT_SCHEMAS"
                           for t in targets):
                    continue
                val = node.value
                if not isinstance(val, ast.Dict):
                    continue
                for k, v in zip(val.keys, val.values):
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str) and \
                            isinstance(v, ast.Tuple) and len(v.elts) == 2:
                        schemas[k.value] = (dict_keys(v.elts[0]),
                                            dict_keys(v.elts[1]))
    _FACT_CACHE[key] = schemas
    return schemas


def _parse_file(path: str) -> Optional[ast.Module]:
    try:
        with open(path) as fh:
            return ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return None


# ---------------------------------------------------------------------------
# baseline


@dataclasses.dataclass
class BaselineEntry:
    rule: str
    path: str
    line: int          # advisory; matching is by (rule, path, code)
    code: str          # stripped source line at the finding
    justification: str

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def load_baseline(path: str) -> List[BaselineEntry]:
    if not path or not os.path.exists(path):
        return []
    with open(path) as fh:
        doc = json.load(fh)
    return [BaselineEntry(rule=e["rule"], path=e["path"],
                          line=int(e.get("line", 0)),
                          code=e.get("code", ""),
                          justification=e.get("justification", ""))
            for e in doc.get("entries", [])]


def baseline_key(f: Finding, code: str) -> Tuple[str, str, str]:
    return (f.rule, f.path, code)


# ---------------------------------------------------------------------------
# the two-pass scan


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]                  # live (post-suppress, -baseline)
    suppressed: List[Finding]
    baselined: List[Finding]
    stale_baseline: List[BaselineEntry]
    parse_errors: List[Finding]
    files: int
    elapsed_s: float
    # exit-code semantics: "warn" fails on ANY live finding (the strict
    # default, and the historical behavior); "error" lets warning-severity
    # findings through (reported, but exit 0) so advisory rules can ride
    # along without breaking tier-1 / bench preflight
    threshold: str = "warn"

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity != "error"]

    @property
    def failed(self) -> bool:
        gating = self.findings if self.threshold == "warn" else self.errors
        return bool(gating or self.parse_errors or self.stale_baseline)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": 2,
            "findings": [f.to_dict() for f in self.findings],
            "parse_errors": [f.to_dict() for f in self.parse_errors],
            "stale_baseline": [e.to_dict() for e in self.stale_baseline],
            "summary": {
                "files": self.files,
                "findings": len(self.findings),
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
                "stale_baseline": len(self.stale_baseline),
                "elapsed_s": round(self.elapsed_s, 3),
                "threshold": self.threshold,
                "ok": not self.failed,
            },
        }


def iter_python_files(paths: Sequence[str], root: str = REPO_ROOT) \
        -> List[str]:
    """Expand files/directories (relative to ``root``) into sorted .py
    paths; hidden dirs and __pycache__ are skipped."""
    out: List[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            out.append(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in dirnames
                           if not d.startswith(".") and d != "__pycache__"]
            for fn in filenames:
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def analyze_source(source: str, relpath: str = "<fixture>",
                   rules: Optional[Sequence[str]] = None,
                   keep_suppressed: bool = False) -> List[Finding]:
    """Analyze one source string (the fixture-test entry point). Runs both
    passes — facts are built from the single module, and ``check_repo``
    rules (lock-order) see a one-module repo — so fixture trios exercise the
    cross-module rules too. Returns live findings; with ``keep_suppressed``
    returns suppressed ones too."""
    from . import facts as facts_mod
    chosen = _select(rules)
    ctx = ModuleContext(relpath, source)
    repo = facts_mod.build_repo_facts([(ctx.relpath, ctx.tree)])
    ctx.facts = repo.modules[ctx.relpath]
    ctx.repo_facts = repo
    _run_rules(ctx, chosen)
    _run_repo_rules(repo, chosen, {ctx.relpath: ctx})
    live, suppressed = _split_findings(ctx)
    return live + (suppressed if keep_suppressed else [])


def analyze_paths(paths: Optional[Sequence[str]] = None,
                  rules: Optional[Sequence[str]] = None,
                  baseline_path: Optional[str] = DEFAULT_BASELINE,
                  root: str = REPO_ROOT,
                  severity_threshold: str = "warn") -> AnalysisResult:
    """Two-pass repo scan. Pass 1 parses every module and builds the
    repo-wide facts (lock graph raw material, rank-dependent branches,
    collective group uses); pass 2 runs the per-module rules with
    those facts attached, then the cross-module ``check_repo`` rules."""
    from . import facts as facts_mod
    t0 = time.perf_counter()
    chosen = _select(rules)
    files = iter_python_files(paths or DEFAULT_PATHS, root=root)
    parse_errors: List[Finding] = []
    ctxs: Dict[str, ModuleContext] = {}
    for full in files:
        rel = os.path.relpath(full, root).replace(os.sep, "/")
        try:
            with open(full, encoding="utf-8") as fh:
                src = fh.read()
        except (OSError, UnicodeDecodeError) as e:
            parse_errors.append(Finding("parse", rel, 1,
                                        f"unreadable: {e}", "error"))
            continue
        try:
            ctxs[rel] = ModuleContext(rel, src)
        except SyntaxError as e:
            parse_errors.append(Finding("parse", rel, e.lineno or 1,
                                        f"does not parse: {e.msg}", "error"))

    repo = facts_mod.build_repo_facts(
        [(rel, ctx.tree) for rel, ctx in ctxs.items()])
    live: List[Finding] = []
    suppressed: List[Finding] = []
    code_of: Dict[Finding, str] = {}
    for rel, ctx in ctxs.items():
        ctx.facts = repo.modules[rel]
        ctx.repo_facts = repo
        _run_rules(ctx, chosen)
    _run_repo_rules(repo, chosen, ctxs)
    for ctx in ctxs.values():
        file_live, file_supp = _split_findings(ctx, code_of=code_of)
        live.extend(file_live)
        suppressed.extend(file_supp)

    baseline = load_baseline(baseline_path) if baseline_path else []
    by_key: Dict[Tuple[str, str, str], List[BaselineEntry]] = {}
    for e in baseline:
        by_key.setdefault((e.rule, e.path, e.code), []).append(e)
    matched: Set[int] = set()
    remaining: List[Finding] = []
    baselined: List[Finding] = []
    for f in live:
        entries = by_key.get(baseline_key(f, code_of.get(f, "")))
        if entries:
            matched.update(id(e) for e in entries)
            baselined.append(f)
        else:
            remaining.append(f)
    # a baseline entry only goes stale if its file was actually scanned —
    # a --changed-only run must not declare every out-of-scope entry stale
    stale = [e for e in baseline
             if id(e) not in matched and e.path in ctxs]
    return AnalysisResult(findings=remaining, suppressed=suppressed,
                          baselined=baselined, stale_baseline=stale,
                          parse_errors=parse_errors, files=len(files),
                          elapsed_s=time.perf_counter() - t0,
                          threshold=severity_threshold)


def _select(rules: Optional[Sequence[str]]) -> List[Rule]:
    table = all_rules()
    if rules is None:
        return [r for r in table.values() if r.kind == "ast"]
    missing = [n for n in rules if n not in table]
    if missing:
        raise KeyError(f"unknown rule(s): {', '.join(missing)} "
                       f"(known: {', '.join(sorted(table))})")
    return [table[n] for n in rules if table[n].kind == "ast"]


def _run_rules(ctx: ModuleContext, rules: List[Rule]) -> None:
    for rule in rules:
        rule.check_module(ctx)


def _run_repo_rules(repo_facts, rules: List[Rule],
                    ctxs: Dict[str, ModuleContext]) -> None:
    """Run each rule's cross-module pass; findings land on the owning
    module's context so the normal suppression filter applies to them."""
    for rule in rules:
        def emit(path: str, line: int, message: str,
                 severity: Optional[str] = None, _rule=rule) -> None:
            ctx = ctxs.get(path)
            if ctx is None:      # site outside the scanned set: anchor to
                ctx = next(iter(ctxs.values()))   # any module (best effort)
            ctx.findings.append(Finding(
                rule=_rule.name, path=path, line=line, message=message,
                severity=severity or _rule.severity))
        rule.check_repo(repo_facts, emit)


def _split_findings(ctx: ModuleContext,
                    code_of: Optional[Dict[Finding, str]] = None) \
        -> Tuple[List[Finding], List[Finding]]:
    live, suppressed = [], []
    for f in sorted(ctx.findings, key=lambda f: (f.line, f.rule)):
        if code_of is not None:
            code_of[f] = ctx.code_at(f.line)
        (suppressed if ctx.is_suppressed(f) else live).append(f)
    return live, suppressed


# ---------------------------------------------------------------------------
# reporters / CLI


def render_human(res: AnalysisResult) -> str:
    lines: List[str] = []
    for f in res.parse_errors + res.findings:
        gates = f.severity == "error" or res.threshold == "warn"
        lines.append(("FAIL " if gates else "WARN ") + f.render())
    for e in res.stale_baseline:
        lines.append(f"FAIL {e.path}:{e.line}: [error] stale-baseline: "
                     f"baseline entry for rule {e.rule!r} no longer matches "
                     f"any finding — remove it (code was: {e.code!r})")
    status = "FAIL" if res.failed else "PASS"
    lines.append(f"{status} tpu-lint: {res.files} files, "
                 f"{len(res.findings)} finding(s), "
                 f"{len(res.suppressed)} suppressed, "
                 f"{len(res.baselined)} baselined, "
                 f"{len(res.stale_baseline)} stale baseline entr(ies) "
                 f"in {res.elapsed_s:.2f}s")
    return "\n".join(lines)


def render_json(res: AnalysisResult) -> str:
    return json.dumps(res.to_dict(), sort_keys=True)


def render_sarif(res: AnalysisResult) -> str:
    """SARIF 2.1.0 document for CI annotation (one run, findings + parse
    errors as results; rule metadata from the registry)."""
    table = all_rules()
    rules_meta = [
        {"id": name,
         "shortDescription": {"text": rule.description or name},
         "fullDescription": {"text": rule.rationale or rule.description},
         "defaultConfiguration": {
             "level": "error" if rule.severity == "error" else "warning"}}
        for name, rule in sorted(table.items())]
    results = []
    for f in res.parse_errors + res.findings:
        results.append({
            "ruleId": f.rule,
            "level": "error" if f.severity == "error" else "warning",
            "message": {"text": f.message},
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": max(1, f.line)}}}],
        })
    for e in res.stale_baseline:
        results.append({
            "ruleId": "stale-baseline",
            "level": "error",
            "message": {"text": f"baseline entry for rule {e.rule!r} no "
                                f"longer matches any finding (code was: "
                                f"{e.code!r})"},
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": e.path},
                "region": {"startLine": max(1, e.line)}}}],
        })
    doc = {
        "version": "2.1.0",
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "runs": [{
            "tool": {"driver": {"name": "tpu-lint",
                                "informationUri": "README.md",
                                "rules": rules_meta}},
            "results": results,
        }],
    }
    return json.dumps(doc, sort_keys=True)


def changed_files(root: str = REPO_ROOT) -> Optional[List[str]]:
    """Repo-relative .py files with uncommitted changes (staged, unstaged,
    or untracked), for ``--changed-only``. None when git is unavailable."""
    import subprocess
    try:
        proc = subprocess.run(["git", "status", "--porcelain=v1", "-uall"],
                              cwd=root, capture_output=True, text=True,
                              timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    out: List[str] = []
    for ln in proc.stdout.splitlines():
        if len(ln) < 4 or ln.startswith("D "):
            continue
        p = ln[3:]
        if " -> " in p:                      # rename: scan the new name
            p = p.split(" -> ")[-1]
        p = p.strip().strip('"')
        if p.endswith(".py"):
            out.append(p)
    return out


def _update_baseline(res: AnalysisResult, baseline_path: str,
                     root: str) -> int:
    """Regenerate the baseline from current live findings, keeping the
    justification of entries that still match; new entries get a TODO
    justification the author must replace."""
    old = load_baseline(baseline_path)
    just: Dict[Tuple[str, str, str], str] = {
        (e.rule, e.path, e.code): e.justification for e in old}
    entries: List[Dict[str, Any]] = []
    src_cache: Dict[str, List[str]] = {}
    for f in res.findings + res.baselined:
        if f.path not in src_cache:
            try:
                with open(os.path.join(root, f.path)) as fh:
                    src_cache[f.path] = fh.read().splitlines()
            except OSError:
                src_cache[f.path] = []
        lines = src_cache[f.path]
        code = lines[f.line - 1].strip() if f.line <= len(lines) else ""
        entries.append(BaselineEntry(
            rule=f.rule, path=f.path, line=f.line, code=code,
            justification=just.get((f.rule, f.path, code),
                                   "TODO: justify or fix")).to_dict())
    entries.sort(key=lambda e: (e["path"], e["line"], e["rule"]))
    doc = {"version": 1,
           "comment": "tpu-lint grandfathered findings; each entry needs a "
                      "justification. Regenerate with --update-baseline.",
           "entries": entries}
    tmp = baseline_path + ".tmp"
    # a temporary file, os.replace'd into place below
    with open(tmp, "w") as fh:   # tpu-lint: disable=non-atomic-artifact-write
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, baseline_path)
    print(f"wrote {len(entries)} baseline entr(ies) to {baseline_path}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.analysis",
        description="tpu-lint for the PyTorch/CUDA port: static analysis "
                    "of lightgbm_tpu_torch")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: the repo surface)")
    ap.add_argument("--format", choices=("human", "json", "sarif"),
                    default="human")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file ('none' disables)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--changed-only", action="store_true",
                    help="scan only files with uncommitted git changes "
                         "(sub-second pre-commit mode; cross-module rules "
                         "see only the changed files)")
    ap.add_argument("--severity-threshold", choices=("warn", "error"),
                    default="warn",
                    help="'warn' (default) fails on any finding; 'error' "
                         "reports warnings but only errors set exit 1")
    ap.add_argument("--dynamic", action="store_true",
                    help="also run dynamic (runtime smoke) rules; these "
                         "import the port and train on --device")
    ap.add_argument("--device", default="cuda",
                    help="torch device the dynamic rules train on "
                         "(default: cuda; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            print(f"{name:28s} [{rule.kind}/{rule.severity}] "
                  f"{rule.description}")
        return 0

    rules = [r.strip() for r in args.rules.split(",")] if args.rules else None
    baseline = None if args.baseline == "none" else args.baseline
    paths = args.paths or None
    if args.changed_only:
        changed = changed_files(REPO_ROOT)
        if changed is None:
            print("tpu-lint: --changed-only needs git; falling back to a "
                  "full scan", flush=True)
        else:
            surface = set(iter_python_files(paths or DEFAULT_PATHS))
            paths = [p for p in changed
                     if os.path.join(REPO_ROOT, p) in surface]
            if not paths:
                print("PASS tpu-lint: no changed files on the scan surface")
                return 0
    if args.update_baseline:
        res = analyze_paths(paths, rules=rules, baseline_path=None)
        return _update_baseline(res, baseline or DEFAULT_BASELINE, REPO_ROOT)

    res = analyze_paths(paths, rules=rules, baseline_path=baseline,
                        severity_threshold=args.severity_threshold)
    if args.dynamic:
        dyn_findings: List[Finding] = []
        for rule in all_rules().values():
            if rule.kind != "dynamic" or (rules and rule.name not in rules):
                continue
            dyn_findings.extend(rule.run_dynamic(device=args.device))
        res.findings.extend(dyn_findings)
    rc = 1 if res.failed else 0
    print(render_sarif(res) if args.format == "sarif" else
          render_json(res) if args.format == "json" else render_human(res))
    return rc
