"""The cell ``yahoo_ltr.bin63`` at a size the CPU holds (6,000 documents,
60 columns): the sound run is correct; the check fails the control (the
reference in the program's place with its gradients in bfloat16) and the
port with its ranking path broken underneath the timed path (the ideal DCG
taken over all of a query's documents instead of at the truncation level;
NDCG altered where it is produced). And the three readers of the
LambdaRank pair grid on hand-built profiles. ``calibrate_ranking.py``
reads the same at the cell's own size on the card: ``calibrate.py`` with
``RANKING_FAULTS`` added to its port faults."""
import types

import numpy as np
import pytest
import torch

from gbdt_bench.tests._tiny import tiny_cell
from gbdt_bench import harness, judge, trace
from gbdt_bench.gen import ranking
from gbdt_bench.layer_metrics import (pair_grid_device_ms,
                                      pair_grid_idle_ms,
                                      pair_grid_roofline_pct)
from gbdt_bench.work.needed import Shape

CELL = "yahoo_ltr.bin63"
SEED = 2 ** 31 + 7


def _all_documents_normaliser(mp):
    """LambdaRank's inverse ideal DCG over every document of a query, not
    its top ``lambdarank_truncation_level``: the port before it followed
    LightGBM's CalMaxDCGAtK."""
    def plant(lt):
        from lightgbm_tpu_torch import objectives
        init = objectives.LambdaRank.init

        def all_documents(self, label, weight=None, group=None):
            init(self, label, weight, group)
            lab = label.cpu().numpy()
            gains = self._label_gain.cpu().numpy().astype(np.float64)
            inv = np.zeros(len(self.group), dtype=np.float64)
            start = 0
            for q, n in enumerate(self.group):
                ls = np.sort(lab[start:start + n])[::-1].astype(np.int64)
                dcg = float((gains[ls] / np.log2(np.arange(n) + 2.0)).sum())
                inv[q] = 1.0 / dcg if dcg > 0 else 0.0
                start += n
            self._inv_max_dcg = torch.as_tensor(
                inv.astype(np.float32), device=label.device)
        mp.setattr(objectives.LambdaRank, "init", all_documents)
    return plant


def _altered_ndcg(mp):
    def plant(lt):
        from lightgbm_tpu_torch import metrics
        ndcg = metrics.ndcg
        mp.setattr(metrics, "ndcg", lambda *a, **k: ndcg(*a, **k) + 0.01)
    return plant


RANKING_FAULTS = {"all_documents_normaliser": _all_documents_normaliser,
                  "altered_ndcg": _altered_ndcg}


def _run(plant=None):
    return harness.run_cell(tiny_cell(CELL), SEED, 0.3, False, "cpu",
                            info=lambda s: None, plant=plant)


def test_the_sound_run_is_correct():
    r = _run()
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("fault,number", [
    ("all_documents_normaliser", "leaf_gap"), ("altered_ndcg", "metric_gap")])
def test_a_broken_ranking_path_is_not_correct(fault, number, monkeypatch):
    r = _run(RANKING_FAULTS[fault](monkeypatch))
    assert r["correct"] is False
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]


def test_the_control_fails_and_the_reference_in_f32_passes():
    cell = tiny_cell(CELL)
    prob = judge.Problem(cell.params, ranking.make(cell.config, 31, "cpu"),
                         torch.device("cpu"))
    low = judge.ControlOutputs(prob, dtype=torch.bfloat16)
    assert not judge.compare(judge.readings(prob, low), cell.limits)[0]
    same = judge.ControlOutputs(prob, dtype=None)
    ok, rows = judge.compare(judge.readings(prob, same), cell.limits)
    assert ok, rows


def test_calibrate_ranking_plants_the_ranking_faults_in_calibrate(
        monkeypatch):
    from gbdt_bench import calibrate, calibrate_ranking
    from gbdt_bench.tests import test_gbdt_bench_control as control
    every = calibrate_ranking.port_faults()
    assert set(every) == (set(control.PORT_FAULTS) - {"altered_metric"}
                          | set(RANKING_FAULTS))
    assert list(calibrate_ranking.port_faults(
        ["all_documents_normaliser", "half_rows"])) == [
            "all_documents_normaliser", "half_rows"]
    with pytest.raises(SystemExit):
        calibrate_ranking.port_faults(["no_such_fault"])
    kept, seen = control.PORT_FAULTS, {}

    def calibrate_main(argv):
        seen.update(faults=sorted(control.PORT_FAULTS), argv=argv)
        return 0
    monkeypatch.setattr(calibrate, "main", calibrate_main)
    assert calibrate_ranking.main(["--faults", "altered_ndcg", "--",
                                   "--workload", CELL]) == 0
    assert seen == {"faults": ["altered_ndcg"], "argv": ["--workload", CELL]}
    assert control.PORT_FAULTS is kept


# ---- the readers, on hand-built profiles (times in seconds) ----

def _api(name, s, e):
    return ("cuda_runtime", name, s, e)


def _profile(extra_host=()):
    """Two iterations; each opens ``obj.pair_grid`` once. The first finds
    the queue drained; before the second, two launches still wait in the
    queue and start only after the span has opened."""
    host = [("user_annotation", "obj.pair_grid", 1.0, 2.0),
            _api("cudaStreamSynchronize", 0.5, 0.8),
            _api("cudaLaunchKernel", 1.1, 1.12),
            _api("cudaLaunchKernel", 1.2, 1.22),
            _api("cudaMemsetAsync", 1.3, 1.32),
            _api("cudaLaunchKernel", 2.4, 2.42),
            _api("cudaStreamSynchronize", 4.0, 4.5),
            _api("cudaLaunchKernel", 5.0, 5.02),
            _api("cudaLaunchKernelExC", 5.1, 5.12),
            ("user_annotation", "obj.pair_grid", 6.0, 7.0),
            _api("cudaMemcpyAsync", 6.1, 6.12),
            _api("cudaLaunchKernel", 6.3, 6.32),
            _api("cudaGetDevice", 6.4, 6.41),
            *extra_host]
    dev = [("kernel", "earlier", 0.2, 0.6),
           ("kernel", "sort", 1.15, 1.3), ("kernel", "gather", 1.3, 1.5),
           ("gpu_memset", "Memset", 1.5, 1.6),
           ("kernel", "later", 2.5, 3.0),
           ("kernel", "queued", 6.2, 6.6), ("kernel", "queued", 6.6, 6.8),
           ("gpu_memcpy", "Memcpy DtoD", 6.8, 7.2),
           ("kernel", "scatter", 7.2, 7.3)]
    return trace.Profile(2, dev, host, (0.0, 10.0))


def _ctx(p, flops=95.0, rows=10):
    shape = Shape(rows_train=rows, rows_valid=0, features=1, bins=64,
                  chan_bytes=2, num_leaves=2, extra_grad_flops=flops)
    return types.SimpleNamespace(profile=p, shape=shape, flops=1e3,
                                 bandwidth=1e4)


def test_the_grid_operations_are_matched_by_launch_order():
    ops = pair_grid_device_ms.span_operations(_profile())
    # the queued two belong to the launches before the second span
    assert [o[1] for o in ops] == ["sort", "gather", "Memset",
                                   "Memcpy DtoD", "scatter"]
    # (0.15 + 0.2 + 0.1) + (0.4 + 0.1) s over 2 iterations
    assert pair_grid_device_ms.read(_ctx(_profile())) == \
        pytest.approx(0.95 / 2 * 1e3)


def test_the_idle_time_inside_the_spans():
    # first span idle 1.0-1.15 and 1.6-2.0, second 6.0-6.2
    assert pair_grid_idle_ms.read(_ctx(_profile())) == \
        pytest.approx(0.75 / 2 * 1e3)


def test_the_roofline_share_takes_the_larger_of_operations_and_bytes():
    # operations 95 / 1e3 s against bytes 10 * 16 / 1e4 s: 0.095 s over
    # 0.475 s an iteration
    assert pair_grid_roofline_pct.read(_ctx(_profile())) == \
        pytest.approx(20.0)
    # bytes-bound: 1,000 documents read 16,000 bytes, 1.6 s
    assert pair_grid_roofline_pct.read(_ctx(_profile(), flops=1.0,
                                            rows=1000)) == \
        pytest.approx(100.0 * 1.6 / 0.475)
    # a cell without query groups counts no pair work
    assert pair_grid_roofline_pct.read(_ctx(_profile(), flops=0.0)) is None


def test_nothing_is_read_without_the_span_or_with_an_unknown_count():
    p = _profile()
    bare = trace.Profile(2, p.device, [h for h in p.host
                                       if h[1] != "obj.pair_grid"], p.window)
    graph = _profile([_api("cudaGraphLaunch", 5.5, 5.6)])
    for m in (pair_grid_device_ms, pair_grid_idle_ms,
              pair_grid_roofline_pct):
        assert m.read(_ctx(bare)) is None, m.__name__
        assert m.read(_ctx(None)) is None, m.__name__
    # a graph's kernels cannot be counted by its launch
    assert pair_grid_device_ms.read(_ctx(graph)) is None
    assert pair_grid_roofline_pct.read(_ctx(graph)) is None
    # a CPU trace has no device operation to be idle
    cpu = trace.Profile(2, [], p.host, p.window)
    assert pair_grid_idle_ms.read(_ctx(cpu)) is None
    assert pair_grid_device_ms.read(_ctx(cpu)) is None
