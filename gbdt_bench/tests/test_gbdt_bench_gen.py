"""The generators: the same seed draws the same rows, the valid set is the
tail of the same draw, and every seed of the ranking generator has the same
query sizes in another order."""
import numpy as np
import torch

from gbdt_bench.tests._tiny import ROWS  # noqa: F401  (puts ROOT on sys.path)
from gbdt_bench import harness
from gbdt_bench.gen import higgs, ranking


def _cfg(name, **kw):
    return {**harness.load_json(harness.HERE, "configs", name + ".json"), **kw}


def test_higgs_same_seed_same_rows_and_other_seed_other_rows():
    cfg = _cfg("higgs", rows_train=3000, rows_valid=500)
    a, b = higgs.make(cfg, 2 ** 33 + 7, "cpu"), higgs.make(cfg, 2 ** 33 + 7,
                                                          "cpu")
    c = higgs.make(cfg, 2 ** 33 + 8, "cpu")
    for x, y in ((a.x_train, b.x_train), (a.y_train, b.y_train),
                 (a.x_valid, b.x_valid), (a.y_valid, b.y_valid)):
        assert torch.equal(x, y)
    assert not torch.equal(a.x_train, c.x_train)
    assert a.x_train.shape == (3000, 28) and a.x_valid.shape == (500, 28)
    assert 0.2 < float(a.y_train.mean()) < 0.8


def test_higgs_valid_set_is_the_tail_of_one_draw():
    whole = higgs.make(_cfg("higgs", rows_train=3500, rows_valid=0), 11,
                       "cpu")
    split = higgs.make(_cfg("higgs", rows_train=3000, rows_valid=500), 11,
                       "cpu")
    assert torch.equal(split.x_valid, whole.x_train[3000:])
    assert torch.equal(split.y_valid, whole.y_train[3000:])
    assert torch.equal(split.x_train, whole.x_train[:3000])


def test_ranking_seeds_share_query_sizes_in_another_order():
    cfg = _cfg("yahoo_ltr", rows_train=4000, queries_valid=40, features=30,
               relevant_features=5)
    a, b = ranking.make(cfg, 5, "cpu"), ranking.make(cfg, 5, "cpu")
    c = ranking.make(cfg, 6, "cpu")
    assert torch.equal(a.x_train, b.x_train)
    assert np.array_equal(a.group_train, b.group_train)
    assert np.array_equal(np.sort(a.group_train), np.sort(c.group_train))
    assert np.array_equal(np.sort(a.group_valid), np.sort(c.group_valid))
    assert not np.array_equal(a.group_train, c.group_train)
    assert int(a.group_train.sum()) == a.x_train.shape[0] <= 4000
    assert len(a.group_valid) == 40
    assert set(np.unique(a.y_train.numpy())) <= {0, 1, 2, 3, 4}
