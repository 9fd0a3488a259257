"""The result line: its keys, in order, with the numbers compared last;
and the command refuses to run without a CUDA card."""
import json
import os
import subprocess
import sys

import pytest

from gbdt_bench.tests._tiny import ROOT, tiny_cell
from gbdt_bench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    cell = tiny_cell()
    r = harness.run_cell(cell, 2 ** 31 + 11, 0.5, traced, "cpu",
                         info=lambda s: None)
    keys = list(r)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in keys) == traced
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = cell.per_layer if traced else cell.end_to_end
    assert set(r["metrics"]) <= set(names)
    if not traced:
        assert set(r["metrics"]) == {"iter_s", "setup_s"}
    else:
        assert {"construct_s", "eval_ms", "step_mfu_pct"} <= set(r["metrics"])
        assert r["device"]["window_s"] > 0
    for m in r["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join("gbdt_bench", "run.py"), "--workload",
         "higgs.bin63", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
