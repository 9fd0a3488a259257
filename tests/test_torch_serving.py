"""The serving engine of the PyTorch/CUDA port (lightgbm_tpu_torch/serving.py,
io/pseudo_bins.py) against the JAX reference's (lightgbm_tpu/serving.py) and
against the port's plain walk (ops/predict.predict_raw / predict_leaf), on
the CPU.

Each model is trained by the port, saved as model text and loaded into
both packages, so both engines serve the same trees. The PseudoRouter
tables equal the reference's array for array; the engines' leaf indices are
equal exactly; raw scores agree within rtol 1e-6 (atol 1e-6 of the largest
score): the reference sums its trees' leaf values in f32 on the device, the
port in f64 in tree order. Against the port's own plain walk the engine is
bit for bit at the reference's bucket-edge sizes, chunked and unchunked,
for regression, binary, multiclass and a categorical model.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.io.pseudo_bins import PseudoRouter as RefRouter
from lightgbm_tpu.serving import bucket_rows as ref_bucket_rows
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.io.pseudo_bins import PseudoRouter
from lightgbm_tpu_torch.ops import predict as P
from lightgbm_tpu_torch.serving import PredictEngine, bucket_rows

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}
RTOL = 1e-6
# sizes straddling bucket edges: the n = 1 fast path, the minimum bucket
# (8) +- 1 and a power-of-two edge +- 1 (reference: test_predict_engine.py)
EDGE_SIZES = [1, 2, 7, 8, 9, 31, 32, 33, 100]


def _train(objective, cat=False, seed=7, **extra):
    rng = np.random.RandomState(seed)
    X = rng.rand(400, 8)
    if cat:
        X[:, 2] = rng.randint(0, 9, 400)
    if objective == "multiclass":
        y = rng.randint(0, extra.get("num_class", 3), 400).astype(float)
    elif objective == "binary":
        y = (X[:, 0] + X[:, 1] > 1).astype(float)
    else:
        y = X[:, 0] * 3 + np.sin(X[:, 1] * 6) + rng.randn(400) * 0.05
        if cat:
            y += (X[:, 2] % 3 == 0)
    p = {"objective": objective, "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 5, **CPU, **extra}
    ds = lt.Dataset(X, label=y, params=p,
                    categorical_feature=[2] if cat else "auto")
    b = lt.train(p, ds, num_boost_round=6)
    if cat:
        assert any(t.num_cat > 0 for t in b._host_trees())
    return b, X


def _queries(X, n, seed=3, cat=False):
    rng = np.random.RandomState(seed)
    q = rng.rand(n, X.shape[1]) * 1.2 - 0.1
    if cat:
        q[:, 2] = rng.randint(-1, 11, n)
    q[rng.rand(n, X.shape[1]) < 0.05] = np.nan
    return q


@pytest.fixture(scope="module")
def models():
    return {"regression": _train("regression"),
            "binary": _train("binary"),
            "multiclass": _train("multiclass", num_class=3),
            "categorical": _train("regression", cat=True)}


@pytest.fixture(scope="module")
def ref_boosters(models):
    return {k: lgb.Booster(model_str=b.model_to_string())
            for k, (b, _) in models.items()}


def _plain(b, x, raw_score=False, pred_leaf=False):
    trees = b._host_trees()
    k = b.num_model_per_iteration()
    xt = torch.as_tensor(x, dtype=torch.float64)
    if pred_leaf:
        return P.predict_leaf(trees, xt).numpy()
    raw = P.predict_raw(trees, xt, k)
    if b.average_output() and trees:
        raw = raw / (len(trees) // k)
    if not raw_score and b._objective_for_predict() is not None:
        raw = b._objective_for_predict().convert_output(raw)
    return raw.numpy()


@pytest.mark.parametrize("kind", ["regression", "binary", "multiclass",
                                  "categorical"])
def test_pseudo_router_tables_equal_reference(models, ref_boosters, kind):
    b, X = models[kind]
    mine = PseudoRouter(b._host_trees(), X.shape[1])
    ref = RefRouter(ref_boosters[kind]._ensure_host_trees(), X.shape[1])
    assert set(mine.stack) == set(ref.stack)
    for key in ref.stack:
        assert mine.stack[key].dtype == ref.stack[key].dtype, key
        np.testing.assert_array_equal(mine.stack[key], ref.stack[key])
    for a, r in zip(mine.thr_sorted, ref.thr_sorted):
        np.testing.assert_array_equal(a, r)
    np.testing.assert_array_equal(mine.na_id, ref.na_id)
    np.testing.assert_array_equal(mine.mt, ref.mt)
    assert mine.cat_ids == ref.cat_ids and mine.max_steps == ref.max_steps
    q = _queries(X, 50, cat=kind == "categorical")
    np.testing.assert_array_equal(mine.bin_matrix(q), ref.bin_matrix(q))


@pytest.mark.parametrize("kind", ["regression", "binary", "multiclass",
                                  "categorical"])
def test_engine_matches_reference_engine(models, ref_boosters, kind):
    """Leaf indices exactly; raw scores within rtol 1e-6 (f32 sums in the
    reference, f64 here), transformed outputs likewise."""
    b, X = models[kind]
    rb = ref_boosters[kind]
    q = _queries(X, 33, seed=5, cat=kind == "categorical")
    np.testing.assert_array_equal(b.predict(q, pred_leaf=True),
                                  rb.predict(q, pred_leaf=True))
    for kw in ({"raw_score": True}, {}):
        got, want = b.predict(q, **kw), rb.predict(q, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("kind", ["regression", "binary", "multiclass",
                                  "categorical"])
@pytest.mark.parametrize("chunk_rows", [None, 16])
def test_engine_bit_identical_to_plain_walk(models, kind, chunk_rows):
    """The engine (bucketed, and chunked at 16 rows: whole chunks, +-1 and
    ragged tails) against the plain raw-value walk, bit for bit."""
    b, X = models[kind]
    eng = PredictEngine(b._host_trees(), X.shape[1],
                        b.num_model_per_iteration(), b.average_output(),
                        objective=b._objective_for_predict(),
                        chunk_rows=chunk_rows, device=torch.device("cpu"))
    for n in EDGE_SIZES:
        q = _queries(X, n, seed=n, cat=kind == "categorical")
        for kw in ({}, {"raw_score": True}, {"pred_leaf": True}):
            got = eng.predict(q, **kw)
            want = _plain(b, q, **kw)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), (n, kw)
    if chunk_rows:
        assert eng.stats["chunked_calls"] > 0 and eng.stats["chunks"] > 0
    assert max(eng.stats["buckets_seen"]) <= (chunk_rows or 1 << 17)


def test_booster_predict_goes_through_the_engine(models):
    b, X = models["binary"]
    b._predict_engine = None
    q = _queries(X, 9)
    assert np.array_equal(b.predict(q), _plain(b, q))
    eng = b._predict_engine
    assert eng is not None and 16 in eng.stats["buckets_seen"]


def test_engine_upload_once_and_invalidation(models):
    b, X = models["regression"]
    obs.reset()
    obs.configure(enabled=True)
    try:
        b._predict_engine = None
        b.predict(X[:3])
        eng = b._predict_engine
        b.predict(X[:50])
        assert b._predict_engine is eng      # same tree count, same engine
        b.predict(X[:3], num_iteration=2)    # fewer trees: rebuilt
        assert b._predict_engine is not eng
        assert b._predict_engine.n_trees == 2
        ups = [e["reason"] for e in obs.EVENTS.snapshot()
               if e["type"] == "engine_upload"]
        assert ups == ["new", "invalidated"]
    finally:
        obs.reset()
        obs.configure(enabled=False)


@pytest.mark.parametrize("change", ["rollback_update", "shuffle"])
def test_engine_rebuilt_when_a_tree_changes(change):
    """The same tree count with another tree in the list (a rolled-back
    iteration grown again on other gradients, a shuffle) rebuilds the
    cached engine: predictions stay the plain walk's of the current trees,
    bit for bit."""
    b, X = _train("regression")
    q = _queries(X, 33)
    assert np.array_equal(b.predict(q), _plain(b, q))
    eng = b._predict_engine
    if change == "rollback_update":
        b.rollback_one_iter()
        b.update(fobj=lambda score, ds: (score - 2.0 * ds.get_label(),
                                         np.ones_like(score)))
    else:
        b.shuffle_models()
    assert b.num_trees() == eng.n_trees
    assert np.array_equal(b.predict(q), _plain(b, q))
    assert b._predict_engine is not eng


def test_bucket_rows_as_reference():
    for n in list(range(0, 70)) + [1000, 10 ** 9]:
        assert bucket_rows(n) == ref_bucket_rows(n)
        assert bucket_rows(n, 4, 64) == ref_bucket_rows(n, 4, 64)
    assert bucket_rows(2) == 8 and bucket_rows(9) == 16
    assert bucket_rows(10 ** 9, max_bucket=1 << 17) == 1 << 17


def test_warmup_covers_buckets_and_release(models):
    b, X = models["regression"]
    eng = PredictEngine(b._host_trees(), X.shape[1], 1, False,
                        objective=b._objective_for_predict(),
                        device=torch.device("cpu"))
    eng.warmup(sizes=(1, 5, 100), n_features=X.shape[1])
    assert eng.stats["buckets_seen"] == {1, 8, 128}
    seen = set(eng.stats["buckets_seen"])
    for n in (1, 4, 70, 100):
        eng.predict(X[:n])
    assert eng.stats["buckets_seen"] == seen   # no new bucket table
    eng.release()
    with pytest.raises(RuntimeError, match="release"):
        eng.predict(X[:1])


def test_sklearn_shares_engine():
    rng = np.random.RandomState(7)
    X = rng.rand(300, 5)
    y = (X[:, 0] > 0.5).astype(int)
    clf = lt.LGBMClassifier(n_estimators=5, num_leaves=7, verbose=-1,
                            device_type="cpu")
    clf.fit(X, y)
    p1 = clf.predict_proba(X[:9])
    eng = clf.booster_._predict_engine
    assert eng is not None and 16 in eng.stats["buckets_seen"]
    clf.predict(X[:9])
    assert clf.booster_._predict_engine is eng
    assert np.array_equal(p1[:, 1], _plain(clf.booster_, X[:9]))


def test_device_put_oom_at_the_upload_raises_the_real_type(models):
    from lightgbm_tpu_torch.utils import faults
    b, X = models["regression"]
    faults.configure("device_put_oom:1")
    try:
        with pytest.raises(torch.cuda.OutOfMemoryError, match="injected"):
            b.predict(X[:4])
        assert np.array_equal(b.predict(X[:4]), _plain(b, X[:4]))
    finally:
        faults.reset()


@pytest.mark.parametrize("kind", ["regression", "binary", "multiclass",
                                  "categorical"])
def test_engine_binning_equals_bin_matrix(models, kind, monkeypatch):
    """The engine's threaded host binning (row blocks of 16 here) equals
    PseudoRouter.bin_matrix over the whole batch, on NaN, +-inf, zeros,
    values on the thresholds and an f32 input."""
    from lightgbm_tpu_torch import serving
    monkeypatch.setattr(serving, "_BIN_BLOCK", 16)
    b, X = models[kind]
    eng = PredictEngine(b._host_trees(), X.shape[1],
                        b.num_model_per_iteration(), False,
                        device=torch.device("cpu"))
    q = _queries(X, 300, seed=11, cat=kind == "categorical")
    q[:5] = np.inf
    q[5:10] = -np.inf
    q[10:15] = 0.0
    q[15:20] = -0.0
    for j, thr in enumerate(eng.router.thr_sorted):
        if len(thr):
            q[20:20 + min(len(thr), 50), j] = thr[:50]
    for x in (q, q.astype(np.float32)):
        np.testing.assert_array_equal(eng.bin_rows(x),
                                      eng.router.bin_matrix(
                                          x.astype(np.float64)))
