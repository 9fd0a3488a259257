"""The voting-parallel learner of the PyTorch/CUDA port (GrowParams
voting_top_k, ops/grow_depthwise.voting_exchange) on the CPU: the cases of
the reference's tests/test_voting.py on the port, on
``virtual_devices(8, "cpu")``, and the port's voting trees against the
reference's on its 8 virtual XLA devices (structure exactly, leaf values
within rtol 1e-4, ROADMAP C2).

Each level measures both children of every split (2 slots a split), each
shard votes for the 2k features of its best local gains, and only the k
elected features' histograms are summed. With top_k >= F every feature is
elected and the learner equals the data-parallel one: byte for byte on a
dyadic-lattice objective (every sum exact, even the children measured
where the data-parallel learner subtracts), within rtol 1e-4, atol 1e-5
on the binary objective (the reference's slow case). Both packages run
unquantized, as the reference's ``use_quantized_grad=auto`` does on the
CPU.
"""
import numpy as np
import pytest

from sklearn.datasets import make_classification
from sklearn.metrics import roc_auc_score

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import grow as G
from lightgbm_tpu_torch.parallel.mesh import virtual_devices
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

_P = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
      "min_data_in_leaf": 5}
CPU = {"device_type": "cpu", "use_quantized_grad": False, "prewarm": 0}


@pytest.fixture(autouse=True)
def mesh8():
    with virtual_devices(8, "cpu") as devs:
        yield devs


def _port(p, X, y, rounds, **kw):
    q = {**p, **CPU}
    return lt.train(q, lt.Dataset(X, label=y, params=q),
                    num_boost_round=rounds, **kw)


def _lattice_fobj(preds, train_data):
    labels = train_data.get_label()
    g = np.round((np.asarray(preds, np.float64) - labels) * 512.0) / 512.0
    return g.astype(np.float32), np.full(g.shape, 0.25, np.float32)


@pytest.mark.slow
def test_voting_equals_dp_when_topk_covers_all_features():
    """top_k >= F elects every feature: the data-parallel model within
    rtol 1e-4, atol 1e-5 (the reference's slow case)."""
    X, y = make_classification(n_samples=800, n_features=8, random_state=0)
    b_dp = _port({**_P, "tree_learner": "data"}, X, y, 8)
    b_vote = _port({**_P, "tree_learner": "voting", "top_k": 8}, X, y, 8)
    np.testing.assert_allclose(b_dp.predict(X), b_vote.predict(X),
                               rtol=1e-4, atol=1e-5)


def test_voting_equals_dp_on_the_lattice():
    """The tier-1 counterpart of the slow case: on lattice gradients the
    voting model with every feature elected is the data-parallel model
    byte for byte, and so is its 2-D mesh run."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((1500, 8)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] > 0).astype(np.float32)
    p = {**_P, "objective": "none", "num_shards": 8}
    b_dp = _port({**p, "tree_learner": "data"}, X, y, 4, fobj=_lattice_fobj)
    b_vote = _port({**p, "tree_learner": "voting", "top_k": 8}, X, y, 4,
                   fobj=_lattice_fobj)
    assert b_vote._gbdt.gp.voting_top_k == 8
    head = [b.model_to_string().split("\nparameters:\n")[0]
            for b in (b_dp, b_vote)]
    assert head[0] == head[1]
    b_2d = _port({**p, "tree_learner": "voting", "top_k": 8,
                  "num_shards": 4, "feature_shards": 2}, X, y, 4,
                 fobj=_lattice_fobj)
    assert b_2d.model_to_string().split("\nparameters:\n")[0] == head[0]


def test_voting_matches_reference():
    """3 of 12 features elected a level on 8 shards: the reference's
    voting trees (the same elections), structure exactly, leaf values and
    predictions within rtol 1e-4 (C2)."""
    X, y = make_classification(n_samples=800, n_features=12, n_informative=4,
                               random_state=1)
    p = {**_P, "tree_learner": "voting", "top_k": 3}
    ref = lgb.train(p, lgb.Dataset(X, label=y), num_boost_round=3)
    port = _port(p, X, y, 3)
    rt, pt = ref._gbdt.finalize(), port._host_trees()
    assert len(rt) == len(pt) == 3
    for a, b in zip(rt, pt):
        for name in ("split_feature", "threshold_bin", "default_left",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-4,
                               atol=1e-6)


def test_voting_quality_with_small_topk():
    """Electing 6 of 30 features keeps the model's quality: the
    informative features win the vote."""
    X, y = make_classification(n_samples=1200, n_features=30, n_informative=5,
                               random_state=1)
    b_vote = _port({**_P, "tree_learner": "voting", "top_k": 6}, X, y, 15)
    assert b_vote._gbdt.gp.voting_top_k == 6 and b_vote._gbdt._dp
    auc = roc_auc_score(y, b_vote.predict(X))
    assert auc > 0.95, f"voting-parallel AUC {auc}"


def test_voting_traffic_compression_accounting():
    """The level's histogram sum shrinks from F to top_k features (plus
    the [F] vote tally and score): the reference's arithmetic, and the
    bytes the port's shard sums move, counted (``ops/grow.ALLREDUCE``)."""
    F, B, K, S = 30, 64, 6, 8
    full_bytes = S * 3 * F * B * 4
    voting_bytes = S * 3 * K * B * 4 + 2 * F * 4
    assert voting_bytes < 0.25 * full_bytes
    X, y = make_classification(n_samples=1200, n_features=F, n_informative=5,
                               random_state=1)
    counted = {}
    for learner in ("data", "voting"):
        G.reset_allreduce()
        _port({**_P, "tree_learner": learner, "top_k": K, "max_bin": 63},
              X, y, 2)
        counted[learner] = dict(G.ALLREDUCE)
    G.reset_allreduce()
    # a level's sum: 8 shards x [S, 3, F or K, B]; voting measures both
    # children (2 S slots), so its share is 2 K / F of the data-parallel
    # learner's at equal levels, well below a quarter here
    assert counted["voting"]["hist_bytes"] < \
        0.5 * counted["data"]["hist_bytes"]
    assert counted["voting"]["hist_calls"] > 0
