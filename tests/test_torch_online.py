"""Continuous training of the PyTorch/CUDA port (lightgbm_tpu_torch:
Dataset.append, online.py, the server's !learn), on the CPU: the cases of
the reference's tests/test_online.py on the port, held against the JAX
reference (lightgbm_tpu) on the same seeded inputs.

Exact: appended bins against the reference's Dataset.append and a
``reference=`` construct of the same rows (out-of-range values, NaN,
unseen categories, an EFB-bundled Dataset), bit for bit; failed appends
refused by both packages and changing nothing; merge_boosters of the same
init and delta model texts, tree for tree; continuations within the port
byte for byte (a snapshot-restored init model, the online trainer against
the offline append + train(init_model=) + merge); the !learn replies
against the reference server's. Across the packages: tree structures
exactly, leaf values rtol 1e-4 plus 1e-4 of the largest (C2), on L2 labels
on a 1/8 grid with the reference on its Pallas kernels in interpret mode
(histogram_impl=pallas); binary models are compared within the port only
(the logloss exp's ulp gap, C1). The reference's end-to-end drill also
counts jax lowerings; the port traces nothing, and that assertion has no
counterpart here. The sharded append (test_append_resharded_under_mesh)
runs on ``virtual_devices(8, "cpu")`` against the reference's 8 virtual
devices.
"""
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu import online as ref_online
from lightgbm_tpu import server as ref_server
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.basic import Booster, Dataset
from lightgbm_tpu_torch.io.model_text import parse_model_text
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.online import (OnlineTrainer, last_cycle_stats,
                                       merge_boosters, tail_source)
from lightgbm_tpu_torch.parallel.mesh import virtual_devices
from lightgbm_tpu_torch.server import PredictServer, handle_line

from test_torch_objectives import BASE, CPU, STRUCT
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _lockwatch_zero_inversions():
    """The runtime watchdog conftest installs before any lock exists (its
    prefix also matches the port's files) must record no lock-order
    inversion after this file's real concurrency (ROADMAP A22)."""
    from lightgbm_tpu.analysis import lockwatch
    yield
    lockwatch.WATCH.assert_clean("tests/test_torch_online.py")

RNG = np.random.RandomState(23)
N_FEAT = 8


def _make_data(n=1000, f=N_FEAT, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    y = (X[:, 0] + X[:, 1] - 0.5 * X[:, 2] > 0.7).astype(float)
    return X, y


def _grid(X):
    """An L2 label on a 1/8 grid: exact gradients and init scores."""
    return np.round((X[:, 0] + 0.5 * X[:, 1]) * 8) / 8


def _same_trees(ref_trees, port_trees, rel=1e-4):
    assert len(ref_trees) == len(port_trees)
    for i, (a, b) in enumerate(zip(ref_trees, port_trees)):
        assert a.num_leaves == b.num_leaves, i
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=f"tree {i} {name}")
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=rel,
                                   atol=rel * np.abs(a.leaf_value).max(),
                                   err_msg=f"tree {i}")


def _trees(text):
    return parse_model_text(text)[1]


# ---- (a) appended bins == one-shot frozen construct ----

def test_append_bins_bit_identical():
    """Growing a dataset in uneven chunks gives the binned matrix of a
    reference=-aligned one-shot construct of the concatenation, and the
    reference package's appended matrix, bit for bit — including
    out-of-range values (clip to the edge bins) and NaN (the na bin)."""
    X, y = _make_data(n=400, f=6)
    X = X.copy()
    X[350, 0] *= 100.0          # out of the frozen range: clips to edge bin
    X[351, 1] = np.nan          # missing: lands in the na bin
    X[352, 2] = -50.0           # below range: clips to the low edge
    a = 200
    params = {"verbose": -1, "max_bin": 63}
    ds = Dataset(X[:a], label=y[:a], params={**params, **CPU})
    ds.construct()
    rd = lgb.Dataset(X[:a], label=y[:a], params=params)
    rd.construct()
    before = ds.bins.numpy().copy()
    # uneven chunks, including a single-row append
    for lo, hi in ((200, 340), (340, 341), (341, 400)):
        ds.append(X[lo:hi], label=y[lo:hi])
        rd.append(X[lo:hi], label=y[lo:hi])
        assert ds._bins_T is None or ds.bins_T.shape[1] == hi
    assert ds.num_data == rd.num_data == 400
    ref = Dataset(X, label=y, params={**params, **CPU}, reference=ds)
    ref.construct()
    got = ds.bins.numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, ref.bins.numpy())
    assert np.array_equal(got, np.asarray(rd.bins[:400]))
    # the cached transpose follows the grown bins
    assert np.array_equal(ds.bins_T.numpy(), got.T)
    # the original rows were not touched by the appends
    assert np.array_equal(got[:a], before)
    # labels grew in step, on the host and the device
    assert np.array_equal(ds.get_label(), y.astype(np.float32))
    assert np.array_equal(ds.label.numpy(), ds.get_label())


def test_append_resharded_under_mesh():
    """Appending to a row-sharded Dataset re-plans the shard grid for the
    grown total over the same shard count and re-splits the rows, the
    padding zero; the binned rows equal an unsharded grow of the same
    stream and the reference's sharded append, bit for bit."""
    X, y = _make_data(n=600, f=6, seed=9)
    params = {"verbose": -1, "num_shards": 4}
    with virtual_devices(8, "cpu"):
        ds = Dataset(X[:401], label=y[:401], params={**params, **CPU})
        ds.construct()                                  # non-divisible
        assert ds.shard_plan is not None and ds.shard_plan.num_shards == 4
        assert ds.shard_plan.rows_per_shard == 101
        ds.append(X[401:], label=y[401:])
    plan = ds.shard_plan
    assert plan is not None and plan.num_shards == 4
    assert plan.n_rows == 600 and ds.num_data == 600
    assert plan.rows_per_shard == 150
    assert len(ds.shard_bins) == 4
    assert all(b.shape[0] == plan.rows_per_shard for b in ds.shard_bins)
    flat = Dataset(X[:401], label=y[:401], params={"verbose": -1, **CPU})
    flat.construct()
    flat.append(X[401:], label=y[401:])
    got = np.concatenate([b.numpy() for b in ds.shard_bins])
    assert np.array_equal(got[:600], flat.bins.numpy())
    assert np.array_equal(ds.bins.numpy(), flat.bins.numpy())
    rd = lgb.Dataset(X[:401], label=y[:401], params=params)
    rd.construct()
    rd.append(X[401:], label=y[401:])
    assert rd.shard_plan.rows_per_shard == plan.rows_per_shard
    assert np.array_equal(got, np.asarray(rd.bins))


def _bundled_and_categorical(seed=3):
    """Columns that EFB bundles (mostly-zero one-hot blocks) beside two
    numerical ones, and a categorical column whose appended rows hold
    unseen categories."""
    rng = np.random.RandomState(seed)
    n = 600
    code = rng.randint(0, 6, n)
    onehot = np.zeros((n, 6))
    onehot[np.arange(n), code] = 1.0
    cat = rng.randint(0, 5, n).astype(float)
    cat[500:520] = 7.0          # unseen in the first 400 rows
    X = np.column_stack([rng.rand(n), rng.rand(n), onehot, cat])
    y = np.round((X[:, 0] + 0.25 * code) * 8) / 8
    return X, y


@pytest.mark.parametrize("bundled", [True, False])
def test_append_bundled_and_categorical_bins(bundled):
    """An EFB-bundled Dataset (the frozen plan bundles the appended rows)
    and a categorical column (unseen appended categories bin 0): appended
    bins equal the reference's Dataset.append and a reference= construct,
    bit for bit."""
    X, y = _bundled_and_categorical()
    params = {"verbose": -1, "max_bin": 63, "categorical_feature": [8],
              "enable_bundle": bundled, "min_data_in_bin": 1}
    ds = Dataset(X[:400], label=y[:400], params={**params, **CPU})
    ds.construct()
    rd = lgb.Dataset(X[:400], label=y[:400], params=params,
                     categorical_feature=[8])
    rd.construct()
    assert (ds.bundle_meta is not None) == bundled
    assert ds.num_features == np.asarray(rd.bins).shape[1]
    for lo, hi in ((400, 510), (510, 600)):
        ds.append(X[lo:hi], label=y[lo:hi])
        rd.append(X[lo:hi], label=y[lo:hi])
    ref = Dataset(X, label=y, params={**params, **CPU}, reference=ds)
    ref.construct()
    got = ds.bins.numpy()
    assert np.array_equal(got, ref.bins.numpy())
    assert np.array_equal(got, np.asarray(rd.bins[:600]))
    cat_col = list(ds.feature_map).index(8) if not bundled else None
    if cat_col is not None:
        assert np.all(got[500:520, cat_col] == 0)


APPEND_ERRORS = {
    "no_label": (lambda X, y: ((X[60:],), {}), "label"),
    "width": (lambda X, y: ((X[60:, :3],), {"label": y[60:]}), "features"),
    "label_length": (lambda X, y: ((X[60:],), {"label": y[60:70]}),
                     "label"),
    "weight_on_unweighted": (lambda X, y: ((X[60:],),
                                           {"label": y[60:],
                                            "weight": np.ones(40)}),
                             "weight"),
    "init_score_on_none": (lambda X, y: ((X[60:],),
                                         {"label": y[60:],
                                          "init_score": np.zeros(40)}),
                           "init_score"),
}


@pytest.mark.parametrize("case", list(APPEND_ERRORS))
def test_append_validation(case):
    """Each malformed append is refused by both packages, naming what is
    wrong, and a failed append changes nothing."""
    X, y = _make_data(n=100, f=4)
    make, word = APPEND_ERRORS[case]
    args, kw = make(X, y)
    ds = Dataset(X[:60], label=y[:60], params={"verbose": -1, **CPU})
    ds.construct()
    before = ds.bins.numpy().copy()
    with pytest.raises(LightGBMError, match=word):
        ds.append(*args, **kw)
    assert ds.num_data == 60 and np.array_equal(ds.bins.numpy(), before)
    rd = lgb.Dataset(X[:60], label=y[:60], params={"verbose": -1})
    rd.construct()
    with pytest.raises(Exception, match=word):
        rd.append(*args, **kw)
    assert rd.num_data == 60


def test_append_refuses_sparse_grouped_cap_and_fault():
    """Sparse rows and a FIFO cap on grouped data are refused; the
    dataset_append fault point fires after the rows are binned and before
    anything changes in place, so a retry appends once."""
    import scipy.sparse
    from lightgbm_tpu_torch.utils import faults
    from lightgbm_tpu_torch.utils.faults import FaultInjected
    X, y = _make_data(n=100, f=4)
    ds = Dataset(X[:60], label=y[:60], group=[30, 30],
                 params={"verbose": -1, **CPU})
    ds.construct()
    with pytest.raises(LightGBMError, match="sparse"):
        ds.append(scipy.sparse.csr_matrix(X[60:]), label=y[60:])
    with pytest.raises(LightGBMError, match="grouped"):
        ds.append(X[60:], label=y[60:], group=[40], max_rows=80)
    with pytest.raises(LightGBMError, match="group"):
        ds.append(X[60:], label=y[60:])
    faults.configure("dataset_append:1")
    try:
        with pytest.raises(FaultInjected):
            ds.append(X[60:], label=y[60:], group=[40])
        assert ds.num_data == 60 and list(ds.group) == [30, 30]
        ds.append(X[60:], label=y[60:], group=[40])
    finally:
        faults.reset()
    assert ds.num_data == 100 and list(ds.group) == [30, 30, 40]


def test_append_weight_and_multiclass_init_score():
    """Weights grow on the device beside the labels; a flat multiclass init
    score ([N * K], row-major by row) keeps all K scores of each kept row
    through a FIFO window."""
    X, y = _make_data(n=100, f=4)
    w = np.linspace(0.5, 1.5, 100)
    isc = np.arange(300, dtype=np.float64)
    ds = Dataset(X[:60], label=y[:60], weight=w[:60], init_score=isc[:180],
                 params={"verbose": -1, **CPU})
    ds.construct()
    ds.append(X[60:], label=y[60:], weight=w[60:], init_score=isc[180:],
              max_rows=70)
    assert ds.num_data == 70
    np.testing.assert_array_equal(ds.get_weight(),
                                  w[30:].astype(np.float32))
    np.testing.assert_array_equal(ds.weight.numpy(), ds.get_weight())
    np.testing.assert_array_equal(ds.get_init_score(),
                                  isc[90:].astype(np.float32))
    np.testing.assert_array_equal(ds.init_score.numpy(),
                                  ds.get_init_score())
    with pytest.raises(LightGBMError, match="init_score"):
        ds.append(X[:5], label=y[:5], weight=w[:5], init_score=np.zeros(7))


# ---- (b) refit == CPU reference ----

def _refit_host(booster, X, y, decay):
    """Host mirror of Booster.refit for unit-hessian L2 regression with
    lambda_l1 = lambda_l2 = max_delta_step = 0: per tree, route rows via
    pred_leaf, recompute -sum_g/sum_h in f32, blend with decay, and
    propagate the blended outputs into the score."""
    trees = booster._host_trees()
    leaf_mat = np.asarray(booster.predict(X, pred_leaf=True))
    yf = np.asarray(y, dtype=np.float32)
    score = np.zeros(X.shape[0], dtype=np.float64)
    expected = []
    for ti, t in enumerate(trees):
        g = score.astype(np.float32) - yf
        leaf = leaf_mat[:, ti]
        sg = np.bincount(leaf, weights=g.astype(np.float64),
                         minlength=t.num_leaves)
        sh = np.bincount(leaf, weights=np.ones(len(g)),
                         minlength=t.num_leaves) + 1e-15
        w32 = -(sg.astype(np.float32)) / (sh.astype(np.float32)
                                          + np.float32(1e-38))
        new_out = w32.astype(np.float64) * t.shrinkage
        blended = decay * t.leaf_value + (1.0 - decay) * new_out
        expected.append(blended)
        score = score + blended[leaf]
    return expected


def test_refit_matches_cpu_reference():
    """Booster.refit on new rows: the port's leaves equal the host mirror
    and the reference's refit of the same model text (rtol 1e-5), with the
    same structures and leaf assignments."""
    rng = np.random.RandomState(3)
    X = rng.rand(500, 6)
    y = X[:, 0] * 2.0 + X[:, 1] + 0.1 * RNG.rand(500)
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5, **CPU}
    bst = lt.train(params, Dataset(X, label=y, params=params),
                   num_boost_round=5)
    rng = np.random.RandomState(17)
    X2 = rng.rand(200, 6)
    y2 = X2[:, 0] * 2.0 + X2[:, 1] + 0.1 * rng.rand(200)
    decay = 0.7
    refit = bst.refit(X2, y2, decay_rate=decay)
    want = _refit_host(bst, X2, y2, decay)
    got_trees = refit._host_trees()
    assert len(got_trees) == len(want)
    for t, w in zip(got_trees, want):
        np.testing.assert_allclose(t.leaf_value, w, rtol=1e-5, atol=1e-7)
    ref = lgb.Booster(model_str=bst.model_to_string()).refit(
        X2, y2, decay_rate=decay)
    for a, b in zip(ref._ensure_host_trees(), got_trees):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-7)
    assert np.array_equal(bst.predict(X2, pred_leaf=True),
                          refit.predict(X2, pred_leaf=True))


# ---- merge_boosters: one servable artifact from init + delta ----

@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_merge_boosters_matches_reference(objective):
    """merge_boosters(init, delta): init's trees then delta's; raw
    predictions equal init's plus delta's; the merged text round-trips
    byte for byte; and the reference's merge of the same two model texts
    holds the same trees, leaf values included."""
    rng = np.random.RandomState(2)
    if objective == "binary":
        X, y = _make_data(n=500)
        extra = {}
    else:
        X = rng.rand(400, 5)
        y = (X[:, 0] * 3).astype(int) % 3
        extra = {"num_class": 3}
    params = {"objective": objective, "num_leaves": 15 if extra == {} else 7,
              "verbose": -1, "min_data_in_leaf": 5, **extra, **CPU}
    b1 = lt.train(params, Dataset(X, label=y, params=params),
                  num_boost_round=5 if not extra else 2)
    delta = lt.train(params, Dataset(X, label=y, params=params),
                     num_boost_round=3 if not extra else 2, init_model=b1)
    m = merge_boosters(b1, delta)
    k = 3 if extra else 1
    assert m.num_model_per_iteration() == k
    assert m.num_trees() == b1.num_trees() + delta.num_trees()
    got = m.predict(X[:100], raw_score=True)
    want = b1.predict(X[:100], raw_score=True) + \
        delta.predict(X[:100], raw_score=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # text round-trip of the merged artifact is byte-idempotent
    s = m.model_to_string()
    assert Booster(model_str=s).model_to_string() == s
    rm = ref_online.merge_boosters(
        lgb.Booster(params={k_: v for k_, v in params.items()
                            if k_ != "device_type"},
                    model_str=b1.model_to_string()),
        lgb.Booster(model_str=delta.model_to_string()))
    _same_trees(rm._ensure_host_trees(), _trees(s), rel=0.0)


# ---- (c) snapshot-resumed continuation == uninterrupted continuation ----

def test_snapshot_continued_training_byte_identical(tmp_path):
    """Continuing (append + train(init_model=) + merge) from a snapshot-
    restored model is byte-identical to continuing from the in-memory one;
    the reference's continuation from the same init text has the same
    trees (C2)."""
    from lightgbm_tpu_torch.snapshot import booster_from_latest, write_snapshot
    rng = np.random.RandomState(11)
    X = rng.rand(600, 6)
    y = _grid(X)
    h = 300
    params = {**BASE, "objective": "regression", "num_leaves": 15,
              "verbose": -1}
    pp = {**params, **CPU}

    def _continue(init):
        ds = Dataset(X[:h], label=y[:h], params=pp)
        ds.construct()
        ds.append(X[h:], label=y[h:])
        delta = lt.train(pp, ds, num_boost_round=3, init_model=init)
        return merge_boosters(init, delta).model_to_string()

    b1 = lt.train(pp, Dataset(X[:h], label=y[:h], params=pp),
                  num_boost_round=5)
    text_mem = _continue(b1)
    snap_dir = str(tmp_path / "snaps")
    write_snapshot(b1, snap_dir, iteration=5)
    loaded, it = booster_from_latest(snap_dir)
    assert loaded is not None and it == 5
    text_snap = _continue(loaded)
    assert text_mem == text_snap
    rds = lgb.Dataset(X[:h], label=y[:h], params=params)
    rds.construct()
    rds.append(X[h:], label=y[h:])
    rinit = lgb.Booster(model_str=b1.model_to_string())
    rdelta = lgb.train(params, rds, num_boost_round=3, init_model=rinit)
    ref_text = ref_online.merge_boosters(rinit, rdelta).model_to_string()
    _same_trees(_trees(ref_text), _trees(text_mem))


# ---- sources + triggers ----

def test_tail_source_and_run_flush(tmp_path):
    """tail_source yields the reference's batches; OnlineTrainer.run over
    it trains the initial model, flushes one boost cycle at the end of the
    stream and merges the delta trees, with the reference trainer's trees
    on the same stream (C2)."""
    feed = tmp_path / "feed.csv"
    feed.write_text("# comment line\n"
                    "1.5,0.1,0.2,0.3\n"
                    "2.5,0.4,0.5,0.6   # trailing comment\n"
                    "\n"
                    "3.5 0.7 0.8 0.9\n")   # whitespace-separated also ok
    batches = [b for b in tail_source(str(feed), follow=False)
               if b is not None]
    ref_batches = [b for b in ref_online.tail_source(str(feed), follow=False)
                   if b is not None]
    got_x = np.concatenate([b[0] for b in batches])
    got_y = np.concatenate([b[1] for b in batches])
    assert got_x.shape == (3, 3)
    np.testing.assert_array_equal(got_y, [1.5, 2.5, 3.5])
    np.testing.assert_array_equal(
        got_x, np.concatenate([b[0] for b in ref_batches]))

    rng = np.random.RandomState(4)
    X = rng.rand(120, 3)
    y = np.round((X[:, 0] + X[:, 1]) * 8) / 8
    params = {**BASE, "objective": "regression", "num_iterations": 4,
              "online_refit_rows": 10 ** 6, "online_boost_rounds": 2}
    pp = {**params, **CPU}
    tr = OnlineTrainer(pp, Dataset(X, label=y, params=pp))
    n0 = tr.booster.num_trees()
    assert n0 == 4                     # trainer trained the initial model
    fed = tr.run(tail_source(str(feed), follow=False))
    assert fed == 3
    assert tr.cycles == 1 and tr.version == 1
    assert tr.dataset.num_data == 123
    assert tr.booster.num_trees() == n0 + 2     # merged delta rides along
    st = last_cycle_stats()
    assert st["trigger"] == "flush" and st["mode"] == "boost"
    assert st["rows"] == 3 and st["total_rows"] == 123
    assert min(st[k] for k in ("append_s", "train_s", "merge_s",
                               "publish_s")) >= 0.0
    rt = ref_online.OnlineTrainer(params, lgb.Dataset(X, label=y,
                                                      params=params))
    assert rt.run(ref_online.tail_source(str(feed), follow=False)) == 3
    _same_trees(rt.booster._ensure_host_trees(), tr.booster._host_trees())


def test_drift_trigger_and_events():
    """online_drift_metric_delta: an in-distribution batch records the
    baseline, a drifted one fires the cycle, as in the reference: the same
    cycles, versions and drift_trigger / dataset_append / online_refit
    events."""
    from lightgbm_tpu import obs as ref_obs
    rng = np.random.RandomState(6)
    X = rng.rand(300, 4)

    def lab(X_):
        return np.round((X_[:, 0] + X_[:, 1]) * 8) / 8
    y = lab(X)
    # telemetry must ride in the params: the cycle's engine.train call
    # re-applies the config's telemetry knob (configure_from_config)
    params = {**BASE, "objective": "regression", "metric": "l2",
              "verbose": -1, "num_iterations": 5,
              "telemetry": True, "online_refit_rows": 10 ** 6,
              "online_drift_metric_delta": 0.05, "online_boost_rounds": 1}
    seen = {}
    for name, mk, o in (
            ("port", lambda: OnlineTrainer({**params, **CPU}, Dataset(
                X, label=y, params={**params, **CPU})), obs),
            ("ref", lambda: ref_online.OnlineTrainer(params, lgb.Dataset(
                X, label=y, params=params)), ref_obs)):
        o.EVENTS.clear()
        try:
            tr = mk()
            rng = np.random.RandomState(8)
            Xa = rng.rand(40, 4)
            # in-distribution batch: records the baseline, no trigger
            assert tr.feed(Xa, lab(Xa)) is None
            assert tr.cycles == 0 and tr.pending_rows == 40
            # drifted batch: l2 explodes past the delta -> cycle fires
            Xb = rng.rand(40, 4)
            ver = tr.feed(Xb, lab(Xb) + 10.0)
            assert ver == 1 and tr.cycles == 1
            assert tr.pending_rows == 0 and tr.dataset.num_data == 380
            events = o.EVENTS.snapshot()
            drift = [e for e in events if e["type"] == "drift_trigger"]
            assert drift and drift[-1]["metric"] == "l2"
            assert drift[-1]["delta"] > 0.05
            refits = [e for e in events if e["type"] == "online_refit"]
            assert refits and refits[-1]["trigger"] == "drift"
            assert refits[-1]["mode"] == "boost" and refits[-1]["rows"] == 80
            seen[name] = ([e["type"] for e in events
                           if e["type"] in ("drift_trigger", "dataset_append",
                                            "online_refit")],
                          drift[-1]["baseline"], drift[-1]["current"])
        finally:
            o.configure(enabled=False)
            o.EVENTS.clear()
    assert seen["port"][0] == seen["ref"][0]
    assert "dataset_append" in seen["port"][0]
    np.testing.assert_allclose(seen["port"][1:], seen["ref"][1:], rtol=1e-4)
    assert last_cycle_stats()["trigger"] == "drift"


# ---- the !learn serve-protocol command ----

def test_learn_protocol(tmp_path):
    """!learn lines feed the attached trainer; the replies equal the
    reference server's line for line; the third row fires a refit cycle
    whose hot-swapped version serves the refit model bit for bit."""
    X, y = _make_data(n=200, f=4, seed=12)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 5, "serve_max_batch_rows": 64,
              "online_refit_rows": 3, "online_boost_rounds": 0}
    row = ",".join("%.17g" % v for v in X[0])
    lines = ["!learn", "!learn 1.0", f"!learn 1,{row}", f"!learn 0,{row}",
             f"!learn 1,{row}"]
    replies = {}
    for name, pkg, srv_mod, tr_cls, p in (
            ("port", lt, None, OnlineTrainer, {**params, **CPU}),
            ("ref", lgb, ref_server, ref_online.OnlineTrainer, params)):
        b = pkg.train(p, pkg.Dataset(X, label=y, params=p),
                      num_boost_round=3)
        srv = (PredictServer if srv_mod is None else srv_mod.PredictServer)(
            p, model=b)
        hl = handle_line if srv_mod is None else srv_mod.handle_line
        try:
            out = [hl(srv, f"!learn 1,{row}")]
            ds = pkg.Dataset(X, label=y, params=p)
            tr = tr_cls(p, ds, booster=b, server=srv)
            srv.attach_online(tr)
            assert tr.version == 1            # server already published v1
            out += [hl(srv, ln) for ln in lines]
            assert tr.cycles == 1 and ds.num_data == 203
            if name == "port":
                got = srv.predict(X[:5])
                np.testing.assert_array_equal(got, tr.booster.predict(X[:5]))
        finally:
            srv.close()
        replies[name] = out
    assert replies["port"] == replies["ref"]
    assert replies["port"][0] == "error: no online trainer attached"
    assert replies["port"][3:5] == ["ok pending=1", "ok pending=2"]
    assert "version=2" in replies["port"][5]
    assert "pending=0" in replies["port"][5]


# ---- (d) the acceptance drill: stream the second half, refit + publish
# under concurrent load, bit-exact vs offline, zero drops ----

def test_end_to_end_online_drill():
    """Train on the first half; stream the second half in four chunks into
    a trainer attached to a live PredictServer under 8 concurrent clients:
    the fourth chunk fires one boost cycle whose model text equals the
    offline continuation (append + train(init_model=) + merge) byte for
    byte; two leaf refits publish under load; nothing is shed and every
    answer equals its version's predict bit for bit."""
    X, y = _make_data(n=1000)
    h = 500
    queries = RNG.rand(64, N_FEAT)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5, "serve_max_batch_rows": 256,
              "online_refit_rows": 500, "online_boost_rounds": 4, **CPU}

    # train on the first half; this booster seeds both runs
    ds = Dataset(X[:h], label=y[:h], params=params)
    b1 = lt.train(params, ds, num_boost_round=6)

    # offline continued-training run: one-shot append + warm-started delta
    ds_off = Dataset(X[:h], label=y[:h], params=params)
    ds_off.construct()
    ds_off.append(X[h:], label=y[h:])
    delta_off = lt.train(params, ds_off, num_boost_round=4, init_model=b1)
    b2_off = merge_boosters(b1, delta_off)

    srv = PredictServer(params, model=b1)
    tr = OnlineTrainer(params, ds, booster=b1, server=srv)
    srv.attach_online(tr)
    want = {1: b1.predict(queries), 2: b2_off.predict(queries)}
    errs, results = [], []
    res_lock = threading.Lock()
    stop = threading.Event()

    def worker(t):
        try:
            j = t
            while not stop.is_set():
                i = j % len(queries)
                out, version = srv.predict_versioned(queries[i])
                with res_lock:
                    results.append((i, version, out))
                j += 1
        except Exception as e:                    # pragma: no cover
            errs.append(e)

    def wait_for(n):
        t_end = time.time() + 60
        while len(results) < n and not errs and time.time() < t_end:
            time.sleep(0.005)

    ths = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    try:
        [t.start() for t in ths]
        wait_for(40)
        # stream the second half in four chunks; the last one crosses the
        # online_refit_rows threshold and runs a full cycle inline
        ver = None
        for lo in range(h, 1000, 125):
            v = tr.feed(X[lo:lo + 125], y[lo:lo + 125])
            ver = v if v is not None else ver
        assert ver == 2 and tr.cycles == 1
        assert tr.dataset.num_data == 1000
        st = last_cycle_stats()
        assert st["trigger"] == "rows" and st["mode"] == "boost"
        assert st["rows"] == 500 and st["version"] == 2
        # the online continuation IS the offline continuation, byte for byte
        assert tr.booster.model_to_string() == b2_off.model_to_string()
        assert np.array_equal(tr.dataset.bins.numpy(), ds_off.bins.numpy())
        wait_for(len(results) + 40)
        # leaf refits published under load
        for v_want, lo in ((3, h), (4, h + 125)):
            r = tr.booster.refit(X[lo:lo + 125], y[lo:lo + 125])
            assert srv.publish(r) == v_want
            want[v_want] = r.predict(queries)
            wait_for(len(results) + 40)
    finally:
        stop.set()
        [t.join(60) for t in ths]
        shed = srv.stats()["scheduler"]["shed"]
        srv.close()
    assert not any(t.is_alive() for t in ths)
    assert not errs, errs
    # zero drops: every admitted request was answered, nothing shed
    assert shed == 0
    seen = set()
    for i, version, out in results:
        seen.add(version)
        assert out[0] == want[version][i], (i, version)
    assert {1, 2, 4} <= seen, seen
