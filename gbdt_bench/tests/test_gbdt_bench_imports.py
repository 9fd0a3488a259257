"""Nothing the benchmark loads brings in JAX or the JAX package: run.py,
the harness and the reference in a fresh process, and a whole run on the
CPU, leave no module whose top-level name is jax, jaxlib, flax or
lightgbm_tpu (compared as whole names: lightgbm_tpu_torch is the port)."""
import json
import subprocess
import sys

from gbdt_bench.tests._tiny import ROOT

LOAD = '''
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("bench_run", sys.argv[1] + "/gbdt_bench/run.py")
mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)
import gbdt_bench.reference.binning, gbdt_bench.reference.trees
import gbdt_bench.reference.objectives, gbdt_bench.reference.metrics
import gbdt_bench.harness, gbdt_bench.judge, gbdt_bench.calibrate
if sys.argv[2] == "run":
    sys.path.insert(0, sys.argv[1] + "/gbdt_bench/tests")
    from gbdt_bench.tests._tiny import tiny_cell
    gbdt_bench.harness.run_cell(tiny_cell(), 3, 0.3, False, "cpu",
                                info=lambda s: None)
print(json.dumps(sorted(sys.modules)))
'''


def _top_levels(mode):
    out = subprocess.run([sys.executable, "-c", LOAD, ROOT, mode],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_loading_the_benchmark_and_reference_imports_no_jax():
    top = _top_levels("load")
    assert not top & {"jax", "jaxlib", "flax", "lightgbm_tpu"}
    assert "lightgbm_tpu_torch" not in top     # the reference needs no port


def test_a_whole_run_imports_no_jax():
    top = _top_levels("run")
    assert "lightgbm_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "lightgbm_tpu"}
