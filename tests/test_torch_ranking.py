"""Ranking in the PyTorch/CUDA port (lightgbm_tpu_torch) against the JAX
reference (lightgbm_tpu), on the CPU: Dataset query groups, the
lambdarank and rank_xendcg objectives and the ndcg@k / map@k metrics.

The data: 40 ragged queries, about 600 rows, 6 features, graded labels
0-4, with a one-doc query, queries whose labels are all equal (all 2, and
all 0: inverse ideal DCG 0) and a 45-doc query, longer than the default
truncation level 20. The reference trains on its Pallas kernels in
interpret mode (histogram_impl=pallas), the port with device_type="cpu".

The port normalises each query's lambdas by its ideal DCG at the
truncation level, as LightGBM does; the reference by the ideal DCG over
all of a query's documents. The two agree at a level at or above every
query's size, so the port is held against the reference at
``FULL_LEVEL`` (45, the longest query), and at the default level 20
against the plain reference of the benchmark (gbdt_bench/reference/,
written to LightGBM's definition) and against the reference's pair grid
fed the port's normalisers.

Exact: the query grid, the inverse ideal DCGs and label gains, the
rank_xendcg gradients at a constant score, the chunked pair grid against
one chunk, ndcg@k and map@k for several eval_at lists and on edge queries
(ties, queries of 1 and 2 documents, an all-0 query, k = 1, k beyond the
longest query, a 249-document query; the port's torch f64 adds in numpy's
order, SumPlan, itself held against numpy's sums),
the first tree's structure quantized and not, the structure of every tree
of 3-iteration models. Tolerances: gradients and hessians within 1e-6 of
the array's largest magnitude (measured up to 2.51e-7): the discounts
1 / log2(i + 2) of XLA:CPU, log(x) times 1/ln 2 on its own log, differ
from torch's by an ulp on some i, and XLA:CPU sums the pair grid's minor
axis in another order (ROADMAP.md C6); first-tree leaf values rtol 1e-4
plus 1e-4 of the largest leaf (C2), predictions after 3 iterations rtol
1e-4 plus 1e-4 of the largest.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu import config as ref_config
from lightgbm_tpu import metrics as ref_metrics
from lightgbm_tpu import objectives as ref_obj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import config as t_config
from lightgbm_tpu_torch import metrics as t_metrics
from lightgbm_tpu_torch import objectives as t_obj

from test_torch_objectives import BASE, CPU, STRUCT

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from gbdt_bench.reference import metrics as plain_metrics  # noqa: E402
from gbdt_bench.reference import objectives as plain_obj  # noqa: E402

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

# a truncation level at or above every query's size: there the port's
# normaliser (ideal DCG at the level) and the reference's (over all
# documents) agree
FULL_LEVEL = 45
RANK = dict(BASE, objective="lambdarank", metric="ndcg", eval_at=[1, 3, 5],
            lambdarank_truncation_level=FULL_LEVEL)
OBJ_CASES = {
    "default": {},
    "no_norm": {"lambdarank_norm": False},
    "sigmoid2": {"sigmoid": 2.0},
    "label_gain": {"label_gain": [0, 1, 3, 7, 20]},
    "xendcg": {"objective": "rank_xendcg"},
}


def ranking_data(seed=0):
    """(X, y, group): 37 queries of 2-24 docs (the first with every label
    2: no pair of different gains), a one-doc query, a 45-doc query, and
    an 8-doc query whose labels are all 0 (no ideal DCG)."""
    rng = np.random.RandomState(seed)
    group = np.array(list(rng.randint(2, 25, 37)) + [1, 45, 8])
    n = int(group.sum())
    X = rng.randn(n, 6).astype(np.float32)
    y = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] + rng.randn(n) * 0.7
                         + 1.5), 0, 4).astype(np.float32)
    y[:group[0]] = 2.0
    y[n - 8:] = 0.0
    return X, y, group


def _close(got, want, bound=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bound * np.abs(want).max())


def _objectives(params, y, group):
    name = params.get("objective", "lambdarank")
    ref = ref_obj.create_objective(name, ref_config.Config(params))
    ref.init(jnp.asarray(y), None, group)
    got = t_obj.create_objective(name, t_config.Config(params))
    got.init(torch.from_numpy(y), None, group)
    return ref, got


def train_pair(params, X, y, group, rounds=3, **kw):
    ref = lgb.train(params, lgb.Dataset(X, label=y, group=group,
                                        params=params),
                    num_boost_round=rounds, verbose_eval=False, **kw)
    pt = dict(params, **CPU)
    port = lt.train(pt, lt.Dataset(X, label=y, group=group, params=pt),
                    num_boost_round=rounds, verbose_eval=False, **kw)
    return ref, port


@pytest.fixture(scope="module")
def models():
    X, y, group = ranking_data()
    return {case: train_pair(dict(RANK, **extra), X, y, group)
            for case, extra in OBJ_CASES.items()}


def test_objective_init_matches_reference():
    X, y, group = ranking_data()
    for extra in ({}, {"label_gain": [0, 1, 3, 7, 20]}):
        ref, got = _objectives(dict({"objective": "lambdarank",
                                     "lambdarank_truncation_level":
                                     FULL_LEVEL}, **extra), y, group)
        np.testing.assert_array_equal(got._idx.numpy(), np.asarray(ref._idx))
        np.testing.assert_array_equal(got._msk.numpy(), np.asarray(ref._msk))
        np.testing.assert_array_equal(got._label_gain.numpy(),
                                      np.asarray(ref._label_gain))
        np.testing.assert_array_equal(got._inv_max_dcg.numpy(),
                                      np.asarray(ref._inv_max_dcg))
    # the all-0 query has no ideal DCG
    assert float(got._inv_max_dcg[-1]) == 0.0
    assert got.num_model_per_iteration == 1 and not got.is_constant_hessian


@pytest.mark.parametrize("case", list(OBJ_CASES))
def test_gradients_match_reference(models, case):
    X, y, group = ranking_data()
    params = dict({"objective": "lambdarank",
                   "lambdarank_truncation_level": FULL_LEVEL},
                  **OBJ_CASES[case])
    ref, got = _objectives(params, y, group)
    rng = np.random.RandomState(1)
    # iteration 0 (every score 0), a random score, and the reference's
    # train score after 2 iterations
    ref2 = lgb.train(dict(RANK, **OBJ_CASES[case]),
                     lgb.Dataset(X, label=y, group=group,
                                 params=dict(RANK, **OBJ_CASES[case])),
                     num_boost_round=2, verbose_eval=False)
    scores = [np.zeros(len(y), np.float32),
              (rng.randn(len(y)) * 0.8).astype(np.float32),
              np.asarray(ref2._gbdt.train_score)]
    for score in scores:
        rg, rh = ref.get_gradients(jnp.asarray(score))
        g, h = got.get_gradients(torch.from_numpy(score))
        _close(g.numpy(), rg)
        _close(h.numpy(), rh)
        assert float(h.min()) >= np.float32(1e-16)
    if case == "xendcg":
        # at a constant score the softmax is 1 / M exactly: bit for bit
        rg, rh = ref.get_gradients(jnp.asarray(scores[0]))
        g, h = got.get_gradients(torch.from_numpy(scores[0]))
        np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
        np.testing.assert_array_equal(h.numpy(), np.asarray(rh))


@pytest.mark.parametrize("seed", [1, 7, 123])
def test_xendcg_gumbel_draw_changes_nothing(seed):
    # the reference adds its Gumbel draw times 0.0; its key advances each
    # call, yet the gradients stay the same bit for bit, and the port,
    # which leaves the draw out, gives them within the C6 tolerance
    X, y, group = ranking_data()
    params = {"objective": "rank_xendcg", "seed": seed}
    ref, got = _objectives(params, y, group)
    score = (np.random.RandomState(seed).randn(len(y)) * 0.5).astype(
        np.float32)
    first = [np.asarray(a) for a in ref.get_gradients(jnp.asarray(score))]
    for _ in range(3):
        again = ref.get_gradients(jnp.asarray(score))
        for a, b in zip(again, first):
            np.testing.assert_array_equal(np.asarray(a), b)
    g, h = got.get_gradients(torch.from_numpy(score))
    _close(g.numpy(), first[0])
    _close(h.numpy(), first[1])


@pytest.mark.parametrize("norm", [True, False])
def test_chunked_pair_grid_equals_one_chunk(norm):
    X, y, group = ranking_data()
    _, got = _objectives({"objective": "lambdarank"}, y, group)
    score = torch.from_numpy(
        (np.random.RandomState(2).randn(len(y))).astype(np.float32))
    sc = torch.where(got._msk, score[got._idx], float("-inf"))
    lab = (got.label[got._idx] * got._msk).to(torch.int32)
    args = (sc, lab, got._msk, got._label_gain, got._inv_max_dcg, 1.0, 20,
            norm)
    whole = t_obj.lambdarank_grid(*args)
    m = sc.shape[1]
    chunked = t_obj.lambdarank_grid(*args, max_cells=20 * m * 3)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---- the truncation level: the port against LightGBM's definition ----

def _plain(y, group, level):
    """The plain reference's query grid and inverse ideal DCGs at
    ``level``, f64."""
    grid = plain_obj.QueryGrid(group, torch.device("cpu"))
    return grid, plain_obj.max_dcg_inv(torch.from_numpy(y), grid, level)


def _scores(n):
    """Every score 0, and two random scores (the second with ties)."""
    rng = np.random.RandomState(3)
    return [np.zeros(n, np.float32),
            (rng.randn(n) * 0.8).astype(np.float32),
            (np.round(rng.randn(n) * 4) / 4).astype(np.float32)]


@pytest.mark.parametrize("level", [1, 5, 20, FULL_LEVEL])
def test_inverse_ideal_dcg_at_the_level_equals_the_plain_reference(level):
    X, y, group = ranking_data()
    _, got = _objectives({"objective": "lambdarank",
                          "lambdarank_truncation_level": level}, y, group)
    _, inv = _plain(y, group, level)
    np.testing.assert_array_equal(got._inv_max_dcg.numpy(),
                                  inv.to(torch.float32).numpy())
    assert float(got._inv_max_dcg[-1]) == 0.0
    # the 45-doc query is the one whose ideal DCG the level cuts short
    long_q = int(np.flatnonzero(group == 45)[0])
    full = _objectives({"objective": "lambdarank",
                        "lambdarank_truncation_level": FULL_LEVEL},
                       y, group)[1]._inv_max_dcg
    relevant = int((y[group[:long_q].sum():][:45] > 0).sum())
    assert relevant > 20
    assert (float(got._inv_max_dcg[long_q]) > float(full[long_q])) == (
        level < relevant)


def test_a_hand_checked_query_of_25_documents_22_relevant():
    # labels 4, 3, 3, then 2 x 3, 1 x 16, 0 x 3: at level 20 the ideal DCG
    # takes the gains 15, 7, 7, 3, 3, 3 and fourteen 1s at positions 0-19
    labels = [4, 3, 3] + [2] * 3 + [1] * 16 + [0] * 3
    y = np.array(labels[::-1], np.float32)         # any document order
    group = np.array([25])
    gains = [15, 7, 7, 3, 3, 3] + [1] * 14
    want = 1.0 / sum(g / math.log2(i + 2) for i, g in enumerate(gains))
    every = [15, 7, 7, 3, 3, 3] + [1] * 16
    old = 1.0 / sum(g / math.log2(i + 2) for i, g in enumerate(every))
    _, got = _objectives({"objective": "lambdarank"}, y, group)
    assert got.trunc == 20
    assert float(got._inv_max_dcg[0]) == np.float32(want)
    assert np.float32(want) != np.float32(old)
    # the gradients at a random score: the plain reference's, within C6
    score = (np.random.RandomState(9).randn(25) * 0.5).astype(np.float32)
    grid, inv = _plain(y, group, 20)
    pg, ph = plain_obj.lambdarank_gradients(torch.from_numpy(score),
                                            torch.from_numpy(y), grid, inv,
                                            20)
    g, h = got.get_gradients(torch.from_numpy(score))
    _close(g.numpy(), pg.numpy())
    _close(h.numpy(), ph.numpy())


def test_gradients_at_level_20_match_the_plain_reference():
    # LightGBM's LambdaRank (norm on, sigmoid 1, gains 2^l - 1) as the
    # benchmark's plain reference writes it
    X, y, group = ranking_data()
    _, got = _objectives({"objective": "lambdarank"}, y, group)
    assert got.trunc == 20 and got.norm
    grid, inv = _plain(y, group, 20)
    for score in _scores(len(y)):
        pg, ph = plain_obj.lambdarank_gradients(
            torch.from_numpy(score), torch.from_numpy(y), grid, inv, 20)
        g, h = got.get_gradients(torch.from_numpy(score))
        _close(g.numpy(), pg.numpy())
        _close(h.numpy(), ph.numpy())


@pytest.mark.parametrize("norm", [True, False])
def test_gradients_at_level_20_match_the_reference_grid_on_these_normalisers(
        norm):
    # the reference's pair grid at level 20, fed the port's normalisers
    X, y, group = ranking_data()
    params = {"objective": "lambdarank", "lambdarank_norm": norm}
    ref, got = _objectives(params, y, group)
    assert not np.array_equal(np.asarray(ref._inv_max_dcg),
                              got._inv_max_dcg.numpy())
    ref._inv_max_dcg = jnp.asarray(got._inv_max_dcg.numpy())
    for score in _scores(len(y)):
        rg, rh = ref.get_gradients(jnp.asarray(score))
        g, h = got.get_gradients(torch.from_numpy(score))
        _close(g.numpy(), rg)
        _close(h.numpy(), rh)


@pytest.mark.parametrize("k", [1, 5, 10, 20])
def test_ndcg_matches_the_plain_reference(k):
    X, y, group = ranking_data()
    grid = plain_obj.QueryGrid(group, torch.device("cpu"))
    for score in _scores(len(y)):
        got = t_metrics.create_metrics(
            ["ndcg"], t_config.Config({"eval_at": [k]}))[0](
                torch.from_numpy(y), torch.from_numpy(score), None, group)
        want = plain_metrics.ndcg(torch.from_numpy(y),
                                  torch.from_numpy(score), grid, k)
        assert got == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("case", list(OBJ_CASES))
def test_three_iteration_models_match_reference(models, case):
    X, y, group = ranking_data()
    ref, port = models[case]
    rt, pt_ = ref._ensure_host_trees(), port._host_trees()
    assert len(rt) == len(pt_) == 3
    for i, (a, b) in enumerate(zip(rt, pt_)):
        assert a.num_leaves == b.num_leaves > 1
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=f"tree {i} {name}")
    np.testing.assert_allclose(rt[0].leaf_value, pt_[0].leaf_value,
                               rtol=1e-4,
                               atol=1e-4 * np.abs(rt[0].leaf_value).max())
    want = np.asarray(ref.predict(X, raw_score=True))
    np.testing.assert_allclose(port.predict(X, raw_score=True), want,
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # ranking output is the raw score
    np.testing.assert_array_equal(port.predict(X),
                                  port.predict(X, raw_score=True))


@pytest.mark.parametrize("obj", ["lambdarank", "rank_xendcg"])
def test_first_tree_unquantized_matches_reference(obj):
    X, y, group = ranking_data()
    p = dict(RANK, objective=obj, use_quantized_grad="false")
    ref, port = train_pair(p, X, y, group, rounds=1)
    a, b = ref._ensure_host_trees()[0], port._host_trees()[0]
    assert a.num_leaves == b.num_leaves > 1
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                               atol=1e-4 * np.abs(a.leaf_value).max())


@pytest.mark.parametrize("eval_at", [[1, 2, 3, 4, 5], [10], [1, 7, 45, 60]])
@pytest.mark.parametrize("metric", ["ndcg", "map"])
def test_ranking_metrics_match_reference_exactly(eval_at, metric):
    X, y, group = ranking_data()
    rng = np.random.RandomState(4)
    # ties included: scores on a coarse grid
    score = (np.round(rng.randn(len(y)) * 4) / 4).astype(np.float32)
    conf = {"eval_at": eval_at}
    ref = ref_metrics.create_metrics([metric], ref_config.Config(conf))
    got = t_metrics.create_metrics([metric], t_config.Config(conf))
    assert [m.name for m in got] == [m.name for m in ref] == \
        [f"{metric}@{k}" for k in eval_at]
    for a, b in zip(got, ref):
        assert a.greater_is_better and not a.use_prob
        want = b(jnp.asarray(y), jnp.asarray(score), None, group)
        assert a(torch.from_numpy(y), torch.from_numpy(score), None,
                 group) == want


def _edge_case(case, rng):
    """(y, score, group, k) of one edge case of the ranking metrics."""
    group = rng.randint(3, 30, 40)
    k = 10
    if case == "tiny_queries":
        group = np.array([1, 2, 1, 2, 2, 1, 2, 1] * 5)
    elif case == "long_query":
        group[17] = 249
    elif case == "k1":
        k = 1
    elif case == "k_beyond_longest":
        k = int(group.max()) + 7
    n = int(group.sum())
    y = rng.randint(0, 5, n).astype(np.float32)
    if case == "all_zero_query":
        lo = int(group[:5].sum())
        y[lo:lo + group[5]] = 0.0
    # 2-3 distinct scores a query, as early trees give: ties decide DCG
    score = rng.randint(0, 3, n).astype(np.float32) * np.float32(0.25)
    return y, score, group, k


@pytest.mark.parametrize("metric", ["ndcg", "map"])
@pytest.mark.parametrize("case", ["ties", "tiny_queries", "all_zero_query",
                                  "k1", "k_beyond_longest", "long_query"])
def test_ranking_metrics_on_edge_queries_match_reference(case, metric):
    # the port adds in numpy's order: equal to the bit (the bound asked of
    # it is rel 1e-12)
    y, score, group, k = _edge_case(case, np.random.RandomState(11))
    want = (ref_metrics._ndcg if metric == "ndcg" else ref_metrics._map)(
        y, score, None, group, k)
    fn = t_metrics.ndcg if metric == "ndcg" else t_metrics.map_at
    got = fn(torch.from_numpy(y), torch.from_numpy(score), None, group, k)
    assert got.dtype == torch.float64 and float(got) == want
    grid = t_metrics.QueryGrid(group, torch.device("cpu"))
    assert float(fn(torch.from_numpy(y), torch.from_numpy(score), None,
                    grid, k)) == want


@pytest.mark.parametrize("n", [1, 7, 8, 13, 128, 129, 206, 249, 1000,
                               6983, 8192, 8193, 20071, 70001])
def test_sum_plan_adds_in_numpys_order(n):
    rng = np.random.RandomState(n % 10007)
    # magnitudes over 40 binades, so that any other order of additions
    # rounds differently
    x = rng.randn(3, n) * np.exp2(rng.randint(-20, 20, (3, n)))
    plan = t_metrics.SumPlan(n)
    got = plan(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x.sum(axis=1))
    assert float(plan(torch.from_numpy(x[1]))) / n == x[1].mean()
    # rows that are zero from column k on skip the steps that add only 0
    for k in (1, 5, 10, 61, n):
        z = np.where(np.arange(n) < k, x, 0.0)
        np.testing.assert_array_equal(
            plan(torch.from_numpy(z), nonzero=k).numpy(), z.sum(axis=1))


def _grids_built(fn):
    """(fn's result, the metric.query_grid spans it opened, their parents
    among the program's spans)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    grids = [e for e in prof.events() if e.name == "metric.query_grid"]
    parents = set()
    for e in grids:
        up = e.cpu_parent
        while up is not None and up.name not in ("eval", "boosting"):
            up = up.cpu_parent
        parents.add(None if up is None else up.name)
    return out, len(grids), parents


def test_query_grid_is_built_once_for_each_evaluated_dataset():
    X, y, group = ranking_data()
    Xv, yv, gv = ranking_data(seed=5)
    p = dict(RANK, metric=["ndcg", "map"], **CPU)
    ds = lt.Dataset(X, label=y, group=group, params=p)
    vs = lt.Dataset(Xv, label=yv, group=gv, reference=ds, params=p)
    res = {}
    _, built, parents = _grids_built(lambda: lt.train(
        p, ds, num_boost_round=3, valid_sets=[ds, vs],
        valid_names=["train", "valid"], evals_result=res,
        verbose_eval=False))
    assert built == 2 and parents == {"eval"}
    assert len(res["valid"]["ndcg@1"]) == 3
    assert ds._query_grid is not None and vs._query_grid is not None


def test_set_group_drops_the_query_grid(monkeypatch):
    X, y, group = ranking_data()
    Xv, yv, gv = ranking_data(seed=5)
    p = dict(RANK, **CPU)
    ds = lt.Dataset(X, label=y, group=group, params=p)
    vs = lt.Dataset(Xv, label=yv, group=gv, reference=ds, params=p)
    bst = lt.train(p, ds, num_boost_round=2, valid_sets=[vs],
                   verbose_eval=False)
    first, built, _ = _grids_built(bst.eval_valid)
    assert built == 0 and vs._query_grid is not None

    # with the grid kept, an evaluation makes no numpy call and one host
    # read a metric
    class NoNumpy:
        def __getattr__(self, name):
            raise AssertionError(f"numpy.{name} called")
    monkeypatch.setattr(t_metrics, "np", NoNumpy())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert bst.eval_valid() == first
    syncs = [e.name for e in prof.events() if e.name.startswith("sync.")]
    assert syncs == ["sync.metric"] * len(first) == ["sync.metric"] * 3
    monkeypatch.undo()
    vs.set_group(gv)
    assert vs._query_grid is None
    again, built, _ = _grids_built(bst.eval_valid)
    assert built == 1 and again == first
    # new query sizes, a new grid and new values
    vs.set_group(np.concatenate([gv[:-2], [gv[-2:].sum()]]))
    changed, built, _ = _grids_built(bst.eval_valid)
    assert built == 1 and changed != first


def test_training_evaluation_matches_reference(models):
    # evals_result of ndcg@1,3,5 and map@1,3,5 on the training set and a
    # valid set of its own queries; equal wherever the scores are
    X, y, group = ranking_data()
    Xv, yv, gv = ranking_data(seed=5)
    p = dict(RANK, metric=["ndcg", "map"])
    res = {}
    for pkg, extra in ((lgb, {}), (lt, CPU)):
        pp = dict(p, **extra)
        ds = pkg.Dataset(X, label=y, group=group, params=pp)
        vs = pkg.Dataset(Xv, label=yv, group=gv, reference=ds, params=pp)
        r = {}
        pkg.train(pp, ds, num_boost_round=2, valid_sets=[ds, vs],
                  valid_names=["train", "valid"], evals_result=r,
                  verbose_eval=False)
        res[pkg] = r
    for name in ("training", "valid"):
        assert list(res[lt][name]) == list(res[lgb][name]) == [
            "ndcg@1", "ndcg@3", "ndcg@5", "map@1", "map@3", "map@5"]
        for m in res[lt][name]:
            np.testing.assert_allclose(res[lt][name][m], res[lgb][name][m],
                                       rtol=1e-6, err_msg=f"{name} {m}")


def test_default_metric_is_ndcg():
    X, y, group = ranking_data()
    p = dict(BASE, objective="rank_xendcg", eval_at=[2, 4], **CPU)
    ds = lt.Dataset(X, label=y, group=group, params=p)
    bst = lt.train(p, ds, num_boost_round=1, valid_sets=[ds],
                   verbose_eval=False)
    assert [r[1] for r in bst.eval_train()] == ["ndcg@2", "ndcg@4"]


def test_group_accessors_and_checks():
    X, y, group = ranking_data()
    ds = lt.Dataset(X, label=y, group=list(group), params=CPU)
    assert ds.get_group().dtype == np.int64
    np.testing.assert_array_equal(ds.get_group(), group)
    ds.set_group(group[::-1])
    np.testing.assert_array_equal(ds.get_group(), group[::-1])
    bad = lt.Dataset(X, label=y, group=list(group[:-1]), params=CPU)
    with pytest.raises(lt.LightGBMError, match="query sizes"):
        bad.construct()
    p = dict(RANK, **CPU)
    with pytest.raises(lt.LightGBMError, match="group"):
        lt.train(p, lt.Dataset(X, label=y, params=p), num_boost_round=1)


@pytest.mark.parametrize("case", ["default", "xendcg"])
def test_model_text_across_packages_both_ways(models, case, tmp_path):
    X, _, _ = ranking_data()
    ref, port = models[case]
    obj = "lambdarank" if case == "default" else "rank_xendcg"
    # the port's text into the reference and back
    ptext = port.model_to_string()
    assert f"objective={obj}" in ptext
    if case == "default":
        assert f"lambdarank_truncation_level:{FULL_LEVEL}" in ptext
    # (the reference sums the trees' leaf values in f32, the port in f64)
    ref_loaded = lgb.Booster(model_str=ptext)
    np.testing.assert_allclose(np.asarray(ref_loaded.predict(X)),
                               port.predict(X), rtol=1e-6, atol=1e-7)
    # the reference's text into the port
    rtext = ref.model_to_string()
    port_loaded = lt.Booster(model_str=rtext, params=CPU)
    np.testing.assert_allclose(port_loaded.predict(X),
                               np.asarray(ref.predict(X)), rtol=1e-6,
                               atol=1e-7)
    path = str(tmp_path / "m.txt")
    port.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    np.testing.assert_array_equal(loaded.predict(X), port.predict(X))
    assert loaded.model_to_string() == ptext
