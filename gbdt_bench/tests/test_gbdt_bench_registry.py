"""Configurations, traffic mixes, limits and metrics are found by their
names in BENCHMARK.json: a new configuration, traffic mix and per-layer
metric, added as new files only (and entries in BENCHMARK.json), run in a
copy of the benchmark without an edit to any file already there."""
import json
import os
import shutil
import subprocess
import sys

from gbdt_bench.tests._tiny import ROOT
from gbdt_bench import harness

NEW_METRIC = '''"""A metric added as a file of its own: construct seconds in ms."""


def read(ctx):
    return ctx.construct_s * 1000.0
'''

DRIVE = '''
import json, sys
sys.path.insert(0, sys.argv[1])
from gbdt_bench import harness
assert harness.HERE.startswith(sys.argv[1]), harness.HERE
cell = harness.load_cell(sys.argv[1], "tiny.few")
r = harness.run_cell(cell, 7, 0.5, True, "cpu", info=lambda s: None)
print(json.dumps(r))
'''


def test_every_cell_resolves_by_name():
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) <= set(
            __import__("gbdt_bench.judge", fromlist=["NAMES"]).NAMES)
        assert {"leaf_gap", "split_gap", "count_mismatch"} <= set(cell.limits)
        for m in cell.end_to_end:
            assert os.path.exists(os.path.join(harness.HERE, "e2e_metrics",
                                               m + ".py"))
        for m in cell.per_layer:
            assert os.path.exists(os.path.join(harness.HERE,
                                               "layer_metrics", m + ".py"))


def test_new_config_traffic_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(harness.HERE, root / "gbdt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "lightgbm_tpu_torch"),
               root / "lightgbm_tpu_torch")
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    before = {p: open(p, "rb").read()
              for p in (root / "gbdt_bench").rglob("*") if p.is_file()}
    g = root / "gbdt_bench"
    cfg = harness.load_json(harness.HERE, "configs", "higgs.json")
    cfg.update(name="tiny", rows_train=6000, rows_valid=1000)
    (g / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (g / "traffic" / "few.json").write_text(json.dumps(
        {"params": {"max_bin": 15}, "warmup_iterations": 2,
         "profile_iterations": 2}))
    (g / "limits" / "tiny.few.json").write_text(json.dumps(
        harness.load_json(harness.HERE, "limits", "higgs.bin63.json")))
    (g / "layer_metrics" / "construct_ms.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "tiny", "source": "https://example.org",
                             "file": "gbdt_bench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.few", "config": "tiny",
                               "traffic": "few", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "construct_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "dataset construct", "moves":
                               "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", DRIVE, str(root)],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["construct_ms"]["unit"] == "ms"
    assert r["metrics"]["construct_ms"]["value"] > 0
    for p, data in before.items():
        assert open(p, "rb").read() == data, f"{p} was edited"
