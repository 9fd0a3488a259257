"""On a machine with an NVIDIA card: each cell runs end to end through the
command, correct, with the result line the contract asks for. Elsewhere
these skip with a reason. Run on the card with
``python -m pytest gbdt_bench/tests -q -m cuda``."""
import json
import os
import subprocess
import sys

import pytest
import torch

from gbdt_bench.tests._tiny import ROOT
from gbdt_bench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark measures the port's "
                    "CUDA kernels, which have no CPU mode)")


def _cells():
    return [w["name"] for w in harness.load_json(ROOT, "BENCHMARK.json")
            ["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
def test_every_cell_runs_correct_on_the_card(card, traced):
    for name in _cells():
        out = subprocess.run(
            [sys.executable, os.path.join("gbdt_bench", "run.py"),
             "--workload", name, "--seed", "2718281828", "--seconds", "2",
             "--trace", str(traced)], cwd=ROOT, capture_output=True,
            text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        r = json.loads(out.stdout.strip().splitlines()[-1])
        assert r["correct"] is True, r["checks"]
        assert r["device"]["platform"] == "gpu"
        assert r["device"]["memory_peak_bytes"] > 0
        if traced:
            assert r["device"]["busy_s"] > 0
            assert r["breakdown"]["device_ops"]
