"""The port's lint (lightgbm_tpu_torch.analysis) against the reference's
(lightgbm_tpu.analysis), on the CPU.

- Every rule that carries over gives the reference's findings (rule, line,
  message) on every fixture of tests/test_static_analysis.py, at every
  path those fixtures are analyzed under (the reference's paths mapped to
  the port's files); for host-sync-in-jit, whose loop audit is redone, the
  scheduler-loop findings it keeps.
- Each redone rule (host syncs in the hot loops, dtype-drift, wire-dtype,
  collective-consistency) fires on a positive fixture, stays silent on a
  negative one and honours its suppression; the dynamic non-finite smoke
  passes on the CPU.
- The port's lint flags C18's line on the parent's ``_write_snapshot``;
  the port's tree is clean against its empty baseline, within a CPU-second
  bound; a stale baseline entry is a finding; the registry sweep finds
  every parameter read or listed in UNCONSUMED.
- ``LGBMTPU_LINT_ONLY=1`` keeps torch and jax out of ``sys.modules``; the
  port holds no ``torch.compile``/``torch.jit`` and no ``jax`` (why the
  jit rules have no counterpart).
- The port's ``lockwatch`` catches a two-lock inversion in a fresh
  process and names both sites by their repository paths.
"""
import ast
import json
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest
import torch

import lightgbm_tpu.analysis as ref_lint
import lightgbm_tpu_torch.analysis as lint
from lightgbm_tpu_torch.analysis.core import DEFAULT_BASELINE, REPO_ROOT
from lightgbm_tpu_torch.analysis.rules.host_sync import loop_sync_sites
from lightgbm_tpu_torch.analysis.rules.params import (NO_EFFECT,
                                                      registered_not_consumed)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_static_analysis as ref_fixtures  # noqa: E402

# six pytest workers share the box's cores: one torch thread a process
torch.set_num_threads(1)

CARRIED = ("non-atomic-artifact-write", "collective-divergence",
           "collective-order", "lock-order", "unlocked-shared-state",
           "telemetry-schema", "nonfinite-policy-literal",
           "swallowed-device-error", "unregistered-param")
REDONE = ("host-sync-in-jit", "dtype-drift", "wire-dtype",
          "collective-consistency", "nonfinite-policy-smoke")
NO_COUNTERPART = ("retrace-hazard", "donation-safety", "unsharded-transfer",
                  "compile-budget", "nonaddressable-access")
PKG = os.path.join(REPO_ROOT, "lightgbm_tpu_torch")


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


def _names(findings):
    return [f.rule for f in findings]


def _fixtures():
    """(name, source) of every fixture snippet of the reference's tests:
    its module-level strings that parse as Python and define something."""
    out = []
    for name, val in sorted(vars(ref_fixtures).items()):
        if not (name.isupper() and isinstance(val, str) and "\n" in val):
            continue
        try:
            tree = ast.parse(textwrap.dedent(val))
        except SyntaxError:
            continue
        if any(isinstance(n, (ast.FunctionDef, ast.ClassDef, ast.Assign))
               for n in tree.body):
            out.append((name, val))
    return out


def _ref_paths():
    """The paths the reference's fixture tests analyze under."""
    paths = {"<fixture>"}
    for name, val in vars(ref_fixtures).items():
        if name.endswith("_REL") and isinstance(val, str):
            paths.add(val)
    return sorted(paths)


def _to_port(path):
    return path.replace("lightgbm_tpu/", "lightgbm_tpu_torch/", 1)


def _key(findings, rule):
    """(rule, line, message) of ``rule``'s findings, the port's paths in the
    messages written as the reference's."""
    out = []
    for f in findings:
        if f.rule != rule:
            continue
        if rule == "host-sync-in-jit" and "scheduler loop" not in f.message:
            continue
        out.append((f.rule, f.line,
                    f.message.replace("lightgbm_tpu_torch/", "lightgbm_tpu/")))
    return sorted(out)


def test_the_rule_tables_partition_the_reference():
    ours, ref = set(lint.all_rules()), set(ref_lint.all_rules())
    assert ours == set(CARRIED) | set(REDONE)
    assert ref == set(CARRIED) | set(REDONE) | set(NO_COUNTERPART)
    for name, rule in lint.all_rules().items():
        assert rule.description and rule.rationale, name
    # the runtime ledger of collectives is re-exported, not copied
    from lightgbm_tpu_torch.parallel import collectivewatch
    assert lint.collectivewatch is collectivewatch
    assert not os.path.exists(os.path.join(PKG, "analysis",
                                           "collectivewatch.py"))


@pytest.mark.parametrize("rule", CARRIED + ("host-sync-in-jit",))
def test_carried_rules_match_the_reference_on_its_fixtures(rule):
    fixtures, paths = _fixtures(), _ref_paths()
    assert len(fixtures) > 100 and len(paths) > 8
    fired = 0
    for name, src in fixtures:
        for path in paths:
            for keep in (False, True):
                ref = _key(ref_lint.analyze_source(
                    src, relpath=path, rules=[rule], keep_suppressed=keep),
                    rule)
                got = _key(lint.analyze_source(
                    src, relpath=_to_port(path), rules=[rule],
                    keep_suppressed=keep), rule)
                assert got == ref, (name, path, keep)
                fired += bool(ref)
    assert fired, f"no fixture fires {rule}"


# ---- redone: host syncs in the hot loops ----

DEPTHWISE_REL = "lightgbm_tpu_torch/ops/grow_depthwise.py"

LEVEL_LOOP_BAD = """
import torch

def select(res):
    return res.nonzero()

def grow_tree_depthwise(res, hist):
    for lvl in range(8):
        si = select(res)
        n = int(si.shape[0])
        total = hist.sum().item()
        if bool(res.any()):
            break
"""

LEVEL_LOOP_SUPPRESSED = """
import torch

def grow_tree_depthwise(res, hist):
    for lvl in range(8):
        # the one intended sync a level
        # tpu-lint: disable=host-sync-in-jit
        si = res.nonzero()
        n = int(si.shape[0])
"""

LEVEL_LOOP_CLEAN = """
import torch

def grow_tree_depthwise(res, hist):
    for lvl in range(8):
        n = int(res.shape[0]) + res.numel()
        hist = hist + res.sum()
    return hist.item()
"""

ITERATION_BAD = """
import torch

class GBDT:
    def train_one_iter(self):
        ok = bool(torch.isfinite(self.train_score).all())
        torch.cuda.synchronize()
        return self.train_score.cpu().numpy()
"""


def test_host_sync_fires_in_the_level_loop_and_its_helpers():
    found = lint.analyze_source(LEVEL_LOOP_BAD, relpath=DEPTHWISE_REL,
                                rules=["host-sync-in-jit"])
    got = sorted((f.line, f.message.split(" in ")[0]) for f in found)
    assert got == [(5, ".nonzero()"), (11, ".item()"),
                   (12, "bool(...any())")], got
    assert "in select() called at line 9" in found[0].message
    # the same source elsewhere is not a hot loop
    assert not lint.analyze_source(LEVEL_LOOP_BAD, relpath="<fixture>",
                                   rules=["host-sync-in-jit"])


def test_host_sync_suppressed_and_clean():
    assert not lint.analyze_source(LEVEL_LOOP_SUPPRESSED,
                                   relpath=DEPTHWISE_REL,
                                   rules=["host-sync-in-jit"])
    kept = lint.analyze_source(LEVEL_LOOP_SUPPRESSED, relpath=DEPTHWISE_REL,
                               rules=["host-sync-in-jit"],
                               keep_suppressed=True)
    assert _names(kept) == ["host-sync-in-jit"]
    # metadata is no sync, and a read after the loop is outside it
    assert not lint.analyze_source(LEVEL_LOOP_CLEAN, relpath=DEPTHWISE_REL,
                                   rules=["host-sync-in-jit"])


def test_host_sync_per_iteration_body():
    found = lint.analyze_source(ITERATION_BAD,
                                relpath="lightgbm_tpu_torch/models/gbdt.py",
                                rules=["host-sync-in-jit"])
    assert [f.line for f in found] == [6, 7, 8, 8]


def test_host_sync_inventory_of_the_port():
    """The syncs the audited loops reach today: one a depthwise level
    (the serial pass's count read, ``.item()``; select_level on the
    sharded and lean loops), one a lossguide step, the categorical
    membership read,
    the non-finite guard and feval's numpy copy, each suppressed with its
    reason; chip_smoke.py prints the same inventory."""
    inv = {}
    for rel in ("ops/grow_depthwise.py", "ops/grow.py", "engine.py",
                "models/gbdt.py"):
        path = os.path.join(PKG, rel)
        ctx = lint.ModuleContext("lightgbm_tpu_torch/" + rel,
                                 open(path).read())
        sites = loop_sync_sites(ctx)
        for line, _kind, _where in sites:
            assert "tpu-lint: disable=host-sync-in-jit" in \
                "\n".join(ctx.lines[line - 4:line]), (rel, line)
        inv[rel] = [kind for _line, kind, _where in sites]
    assert inv == {"ops/grow_depthwise.py": ["bool(...any())", ".nonzero()",
                                             ".item()"],
                   "ops/grow.py": [".tolist()"],
                   "engine.py": [".cpu()", ".numpy()"],
                   "models/gbdt.py": ["bool(...all())"]}, inv


# ---- redone: dtype-drift ----

DTYPE_BAD = """
import numpy as np
import torch

def upload(n, dev, vals):
    acc = np.zeros(n)
    a = torch.as_tensor(acc, device=dev)
    b = torch.from_numpy(np.ones(n)).to(dev)
    c = torch.from_numpy(vals.astype(np.float64)).cuda()
    d = torch.tensor(np.array([0.5, 1.5]), device=dev)
    return a, b, c, d
"""

DTYPE_SUPPRESSED = """
import numpy as np
import torch

def upload(n, dev):
    acc = np.zeros(n)
    # exact f64 sums on the card, by design
    # tpu-lint: disable=dtype-drift
    return torch.as_tensor(acc, device=dev)
"""

DTYPE_CLEAN = """
import numpy as np
import torch

def upload(n, dev, vals):
    acc = np.zeros(n, dtype=np.float32)
    a = torch.as_tensor(acc, device=dev)
    b = torch.as_tensor(np.zeros(n), dtype=torch.float32, device=dev)
    c = torch.from_numpy(np.ones(n)).to(dev, torch.float32)
    d = torch.as_tensor(np.array([1, 2]), device=dev)
    e = torch.as_tensor(vals, device=dev)
    host = np.zeros(n)
    return a, b, c, d, e, host.sum()
"""


def test_dtype_drift_trio():
    found = lint.analyze_source(DTYPE_BAD, rules=["dtype-drift"])
    assert [f.line for f in found] == [7, 8, 9, 10]
    assert "acc, built with numpy's float64 (line 6)" in found[0].message
    assert not lint.analyze_source(DTYPE_SUPPRESSED, rules=["dtype-drift"])
    assert _names(lint.analyze_source(
        DTYPE_SUPPRESSED, rules=["dtype-drift"], keep_suppressed=True)) \
        == ["dtype-drift"]
    assert not lint.analyze_source(DTYPE_CLEAN, rules=["dtype-drift"])


# ---- redone: wire-dtype ----

MULTIHOST_REL = "lightgbm_tpu_torch/parallel/multihost.py"

WIRE_BAD = """
import torch
import torch.distributed as dist

def push(t):
    dist.all_reduce(t)
    torch.distributed.broadcast(t, src=0)
"""

WIRE_SUPPRESSED = """
import torch.distributed as dist

def push(t):
    # int32 counts, the same shape on every rank by construction
    # tpu-lint: disable=wire-dtype
    dist.all_reduce(t)
"""

WIRE_BLESSED = """
import torch.distributed as dist

def _gather_raw(wire, outs):
    dist.all_gather(outs, wire)

def allreduce_sum(buf):
    dist.all_reduce(buf)
"""


def test_wire_dtype_trio():
    found = lint.analyze_source(WIRE_BAD, relpath=MULTIHOST_REL,
                                rules=["wire-dtype"])
    assert [f.line for f in found] == [6, 7]
    assert "torch.distributed.all_reduce()" in found[0].message
    assert not lint.analyze_source(WIRE_SUPPRESSED, rules=["wire-dtype"])
    # the codec's two primitives are the blessed sites, in multihost.py only
    assert not lint.analyze_source(WIRE_BLESSED, relpath=MULTIHOST_REL,
                                   rules=["wire-dtype"])
    assert len(lint.analyze_source(WIRE_BLESSED, relpath="<fixture>",
                                   rules=["wire-dtype"])) == 2


# ---- redone: collective-consistency ----

AXIS_BAD = """
import dataclasses

def plan(gp, devs, Mesh):
    gp = dataclasses.replace(gp, axis_name="rows")
    mesh = Mesh(devs, ("data", "feat"))
    return gp.axis_name == "dta", {"mesh_axis": "batch"}
"""

AXIS_CLEAN = """
import dataclasses
from lightgbm_tpu_torch.parallel.mesh import DATA_AXIS

def plan(gp, devs, Mesh, mesh):
    gp = dataclasses.replace(gp, axis_name=mesh.axis_names[0])
    m = Mesh(devs, ("data", "feature"))
    return gp.axis_name == DATA_AXIS, {"mesh_axis": "data"}
"""


def test_collective_consistency_axis_literals():
    found = lint.analyze_source(AXIS_BAD, rules=["collective-consistency"])
    got = sorted((f.line, f.message.split(" names")[0]) for f in found)
    assert got == [(5, "axis_name='rows'"), (6, "Mesh='feat'"),
                   (7, "axis_name='dta'"), (7, "mesh_axis='batch'")], got
    assert not lint.analyze_source(AXIS_CLEAN,
                                   rules=["collective-consistency"])


def test_nonfinite_smoke_on_the_cpu():
    rule = lint.all_rules()["nonfinite-policy-smoke"]
    assert rule.kind == "dynamic"
    assert rule.run_dynamic(device="cpu") == []


def test_nonfinite_smoke_reports_a_broken_guard(monkeypatch):
    """With the trainer's gradient guard made a pass-through, the NaN
    gradients reach the trees: the score guard still stops fatal and
    skips under warn_skip_tree, but clip no longer completes its 5 trees,
    and the smoke says so."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    monkeypatch.setattr(GBDT, "guard_gradients",
                        lambda self, g, h: (g, h, False))
    found = lint.all_rules()["nonfinite-policy-smoke"].run_dynamic(
        device="cpu")
    assert [f.rule for f in found] == ["nonfinite-policy-smoke"]
    assert found[0].message.startswith("[cpu] clip: "), found[0].message


# ---- C18 and the port's tree ----

PARENT_WRITE_SNAPSHOT = '''
from . import snapshot as snap


def _write_snapshot(booster, callbacks, directory, iteration, keep):
    es_state = None
    try:
        if snap.is_writer_rank():
            path = snap.write_snapshot(booster, directory, iteration,
                                       keep=keep, es_state=es_state)
    except Exception as e:
        pass
'''


def test_collective_divergence_flags_c18_on_the_parent():
    """The parent's _write_snapshot, analyzed with the port's snapshot.py
    and models/gbdt.py and parallel/multihost.py (whose get_resume_state
    gathers the lazy bitset): the writer-only branch reaches a collective
    the other rank skips. The repaired engine.py is clean."""
    import lightgbm_tpu_torch.analysis.core as core
    from lightgbm_tpu_torch.analysis import facts as F
    mods = [("lightgbm_tpu_torch/engine.py", PARENT_WRITE_SNAPSHOT)]
    for rel in ("snapshot.py", "models/gbdt.py", "parallel/multihost.py"):
        mods.append(("lightgbm_tpu_torch/" + rel,
                     open(os.path.join(PKG, rel)).read()))
    ctxs = {rel: core.ModuleContext(rel, src) for rel, src in mods}
    repo = F.build_repo_facts([(r, c.tree) for r, c in ctxs.items()])
    rule = lint.all_rules()["collective-divergence"]
    core._run_repo_rules(repo, [rule], ctxs)
    found = [f for f in ctxs["lightgbm_tpu_torch/engine.py"].findings
             if f.rule == "collective-divergence"]
    assert [f.line for f in found] == [8], found
    assert "gather_rows_tensor" in found[0].message
    assert "_write_snapshot" in found[0].message
    res = lint.analyze_paths(paths=["lightgbm_tpu_torch"],
                             rules=["collective-divergence"],
                             baseline_path=None)
    assert not res.findings, [f.render() for f in res.findings]
    assert any(f.path == "lightgbm_tpu_torch/engine.py"
               for f in res.suppressed)


def test_port_tree_is_clean_and_cheap():
    t0 = time.process_time()
    res = lint.analyze_paths(baseline_path=DEFAULT_BASELINE)
    cpu_s = time.process_time() - t0
    assert not res.parse_errors, [f.render() for f in res.parse_errors]
    assert not res.findings, [f.render() for f in res.findings]
    assert not res.stale_baseline and not res.baselined
    assert lint.load_baseline(DEFAULT_BASELINE) == []
    assert res.files > 90
    assert cpu_s < 30.0, f"the port's lint took {cpu_s:.1f} CPU s"
    doc = json.loads(lint.render_json(res))
    assert doc["summary"]["ok"] is True
    sarif = json.loads(lint.render_sarif(res))
    assert sarif["runs"][0]["results"] == []
    # every suppression carries its reason: a comment of more than the
    # directive on its line or the line above
    for f in res.suppressed:
        lines = open(os.path.join(REPO_ROOT, f.path)).read().splitlines()
        if f.path == "chip_smoke.py":
            continue        # the file-level suppression, reasoned above it
        near = " ".join(lines[max(0, f.line - 4):f.line])
        words = re.sub(r"#\s*tpu-lint:\s*disable=[\w\-, ]+", "", near)
        assert re.search(r"#\s*[^\s#]+\s+[^\s#]+", words), (f.path, f.line)


def test_stale_baseline_entry_is_a_finding(tmp_path):
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"entries": [{
        "rule": "non-atomic-artifact-write",
        "path": "lightgbm_tpu_torch/wal.py", "line": 1,
        "code": "open(gone, 'w')", "justification": "fixed since"}]}))
    res = lint.analyze_paths(paths=["lightgbm_tpu_torch/wal.py"],
                             baseline_path=str(base))
    assert res.failed and len(res.stale_baseline) == 1
    assert "stale-baseline" in lint.render_human(res)
    # an entry that still matches baselines its finding instead
    src = "def f(p):\n    open(p, 'w')\n"
    fixture = tmp_path / "w.py"
    fixture.write_text(src)
    base.write_text(json.dumps({"entries": [{
        "rule": "non-atomic-artifact-write", "path": "w.py", "line": 2,
        "code": "open(p, 'w')", "justification": "a test fixture"}]}))
    res = lint.analyze_paths(paths=[str(fixture)], baseline_path=str(base),
                             root=str(tmp_path))
    assert not res.findings and len(res.baselined) == 1


def test_registry_sweep_reads_every_parameter():
    """Every registered parameter is read outside config.py or listed in
    models/gbdt.py UNCONSUMED or the sweep's NO_EFFECT table (packed_levels
    is read since C21, histogram_impl has no effect on the card,
    num_threads caps the native parser's threads)."""
    assert registered_not_consumed() == []
    assert {"pred_early_stop", "hist_dtype"} <= lint.unconsumed_params()
    assert set(NO_EFFECT) == {"histogram_impl"}
    assert set(NO_EFFECT) <= lint.registered_params()


def test_port_has_no_jit_and_no_jax():
    """Why retrace-hazard, donation-safety, unsharded-transfer and
    compile-budget have no counterpart: the port compiles nothing at run
    time (no torch.compile, torch.jit.script or torch.jit.trace) and
    imports no jax (nor the reference package)."""
    hits = []
    for root, _dirs, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            for node in ast.walk(ast.parse(open(path).read())):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                hits += [f"{path}:{node.lineno} imports {m}" for m in mods
                         if m.split(".")[0] in ("jax", "jaxlib",
                                                "lightgbm_tpu")]
                if isinstance(node, ast.Attribute) and (
                        node.attr == "compile" and isinstance(
                            node.value, ast.Name) and node.value.id == "torch"
                        or node.attr in ("script", "trace") and isinstance(
                            node.value, ast.Attribute) and
                        node.value.attr == "jit"):
                    hits.append(f"{path}:{node.lineno} uses .{node.attr}")
    assert hits == []


def test_lint_only_cli_imports_neither_torch_nor_jax():
    code = (
        "import os, sys\n"
        "os.environ['LGBMTPU_LINT_ONLY'] = '1'\n"
        "from lightgbm_tpu_torch.analysis import main\n"
        "rc = main(['--format=json'])\n"
        "assert rc == 0, 'lint failed'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'lightgbm_tpu')]\n"
        "assert not bad, f'leaked into the lint pass: {bad[:3]}'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    proc = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.analysis",
                           "--list-rules"], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120,
                          env=_env(LGBMTPU_LINT_ONLY="1"))
    assert proc.returncode == 0 and "host-sync-in-jit" in proc.stdout


LOCKWATCH_SCRIPT = """
import importlib.util, os, sys, threading
root = sys.argv[1]
spec = importlib.util.spec_from_file_location(
    "lightgbm_tpu_torch.analysis.lockwatch",
    os.path.join(root, "lightgbm_tpu_torch", "analysis", "lockwatch.py"))
lw = importlib.util.module_from_spec(spec)
sys.modules[spec.name] = lw
spec.loader.exec_module(lw)
assert lw.install()
# a module under lightgbm_tpu_torch/ creates its locks after the patch
sys.path.insert(0, sys.argv[2])
import lightgbm_tpu_torch.lw_pair as pair
assert isinstance(pair.A, lw._LockProxy)
assert not isinstance(threading.Lock(), lw._LockProxy)
lw.WATCH.assert_clean("consistent so far")
pair.forward()
t = threading.Thread(target=pair.backward, name="inverter")
t.start(); t.join()
try:
    lw.WATCH.assert_clean("the drill")
except AssertionError as e:
    print("CAUGHT", e)
print("SITES", sorted({s for e in lw.WATCH.edges() for s in e}))
"""

LW_PAIR = """
import threading
A = threading.Lock()
B = threading.Lock()

def forward():
    with A:
        with B:
            pass

def backward():
    with B:
        with A:
            pass
"""


def test_port_lockwatch_catches_an_inversion_by_relative_path(tmp_path):
    pkg = tmp_path / "lightgbm_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "lw_pair.py").write_text(LW_PAIR)
    proc = subprocess.run(
        [sys.executable, "-c", LOCKWATCH_SCRIPT, REPO_ROOT, str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CAUGHT lockwatch recorded 1 lock-order inversion(s) during " \
        "the drill" in proc.stdout, proc.stdout
    sites = proc.stdout.split("SITES ", 1)[1]
    assert "'lightgbm_tpu_torch/lw_pair.py:3'" in sites
    assert "'lightgbm_tpu_torch/lw_pair.py:4'" in sites
    # the acquisitions that made each direction, by path too
    assert "MainThread at lightgbm_tpu_torch/lw_pair.py:8" in proc.stdout
    assert "inverter at lightgbm_tpu_torch/lw_pair.py:13" in proc.stdout
