"""The comparison that decides ``correct`` fails what it must: the control
(the reference put in the program's place with its gradients in bfloat16,
the precision below the configuration's float32) and a run of the port
with its timed path broken underneath (a step that leaves its state
unchanged; half of the rows left out and the rest counted double; the
reported metric altered where it is produced; a tree's score update
skipped; the top two bins merged; one leaf value altered where it is
produced, from the first iteration after the warm-up on, in the stored
tree and the scores alike). A cell with one chip has no exchange
between chips to leave out. Both at a size the CPU holds;
calibrate.py reads the same at the cells' own sizes on the card."""
import pytest
import torch

from gbdt_bench.tests._tiny import tiny_cell
from gbdt_bench import harness, judge
from gbdt_bench.gen import higgs

CELLS = ("higgs.bin63", "higgs.bin255", "higgs.bagged")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["half_rows", "alter_leaf", "short_tree",
                                   "reused_bag", "extra_column"])
def test_faults_in_the_reference_in_the_programs_place_fail(name, fault):
    cell = tiny_cell(name)
    prob = judge.Problem(cell.params, higgs.make(cell.config, 31, "cpu"),
                         torch.device("cpu"))
    out = judge.ControlOutputs(prob, dtype=None, fault=fault)
    sampled = prob.bag_fraction < 1.0 or prob.columns_searched < 28
    failed = not judge.compare(judge.readings(prob, out), cell.limits)[0]
    # a cell that draws no bag or columns has no draw to break
    assert failed or (fault in ("reused_bag", "extra_column")
                      and not sampled)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_fails_and_the_reference_in_f32_passes(name, seed):
    cell = tiny_cell(name)
    host = higgs.make(cell.config, seed, "cpu")
    prob = judge.Problem(cell.params, host, torch.device("cpu"))
    low = judge.ControlOutputs(prob, dtype=torch.bfloat16)
    assert not judge.compare(judge.readings(prob, low), cell.limits)[0]
    same = judge.ControlOutputs(prob, dtype=None)
    ok, rows = judge.compare(judge.readings(prob, same), cell.limits)
    assert ok, rows


def _unchanged(mp):
    def plant(lt):
        from lightgbm_tpu_torch.models import gbdt
        add = gbdt.GBDT._add_tree

        def no_step(self, tree, leaf_id, cls):
            add(self, tree._replace(leaf_value=torch.zeros_like(
                tree.leaf_value)), leaf_id, cls)
        mp.setattr(gbdt.GBDT, "_add_tree", no_step)
    return plant


def _half_rows(mp):
    def plant(lt):
        from lightgbm_tpu_torch.models import gbdt

        def half(self):
            ones = self._bag_ones
            keep = torch.arange(ones.shape[0], device=ones.device) % 2 == 0
            return keep.to(ones.dtype) * 2.0
        mp.setattr(gbdt.GBDT, "_bag", property(half))
    return plant


def _altered_metric(mp):
    def plant(lt):
        from lightgbm_tpu_torch import metrics
        auc = metrics.auc
        mp.setattr(metrics, "auc", lambda *a, **k: auc(*a, **k) + 0.01)
    return plant


def _score_skipped(mp):
    def plant(lt):
        from lightgbm_tpu_torch.models import gbdt
        apply = gbdt.GBDT._apply_tree_delta

        def skip_second(self, score, delta, cls):
            return score if self.iter_ == 1 else apply(self, score, delta,
                                                       cls)
        mp.setattr(gbdt.GBDT, "_apply_tree_delta", skip_second)
    return plant


def _bins_off(mp):
    def plant(lt):
        from lightgbm_tpu_torch.binning import BinMapper
        to_bins = BinMapper.values_to_bins_torch

        def merged_top(self, v):
            return to_bins(self, v).clamp(max=max(self.num_bins - 2, 0))
        mp.setattr(BinMapper, "values_to_bins_torch", merged_top)
    return plant


def _late_leaf(mp):
    def plant(lt):
        from lightgbm_tpu_torch.models import gbdt
        add = gbdt.GBDT._add_tree
        warmup = harness.load_json(harness.HERE, "traffic", "bin63.json")[
            "warmup_iterations"]

        def altered(self, tree, leaf_id, cls):
            if self.iter_ >= warmup:
                lv = tree.leaf_value.clone()
                lv[0] = lv[0] * 1.5
                tree = tree._replace(leaf_value=lv)
            add(self, tree, leaf_id, cls)
        mp.setattr(gbdt.GBDT, "_add_tree", altered)
    return plant


PORT_FAULTS = {"unchanged": _unchanged, "late_leaf": _late_leaf, "half_rows": _half_rows,
               "altered_metric": _altered_metric,
               "score_skipped": _score_skipped, "bins_off": _bins_off}


@pytest.mark.parametrize("fault", sorted(PORT_FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    r = harness.run_cell(tiny_cell(), 5, 0.3, False, "cpu",
                         info=lambda s: None,
                         plant=PORT_FAULTS[fault](monkeypatch))
    assert r["correct"] is False


def test_the_same_run_unbroken_is_correct():
    r = harness.run_cell(tiny_cell(), 5, 0.3, False, "cpu",
                         info=lambda s: None)
    assert r["correct"] is True, r["checks"]
