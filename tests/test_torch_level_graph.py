"""The serial depthwise level pass at a fixed slot width, and its CUDA graph.

On the CPU: the level pass (``ops/grow_depthwise.py`` ``level_pass``)
measuring one row shard through the data-parallel learner
(``LevelRows`` over a one-shard plan: the front, the exchange and the
leaf sums of the sharded path) grows the serial grower's trees, byte
for byte in the model text, on the benchmark cells' paths (max_bin 63
on the fused front, 255 on the unfused one, bagged with
feature_fraction) under L2 and under ``max_depth`` 4, at 20,000 rows. A
level that selects nothing leaves every live array as it was.
``capture_engages`` takes only the device and the pass's host-fed
inputs.

On the card (marker ``cuda``, no JAX imported, so this file also runs
with ``--noconftest``): the graphed grower gives the model text of the
same grower with capture off, on the three depthwise shapes of
``tests/test_torch_spans.py``; a replayed pass makes one host read, the
count; one ``LevelGraphs`` captures anew for a Dataset of another row
count and grows its trees as the uncaptured grower does;
``hist_kernels.LAUNCHES`` counts the same kernels with or without capture;
and a model trained while another thread uses the card is the uncaptured
one.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import grow_depthwise as gd
from lightgbm_tpu_torch.ops import hist_kernels as K
from lightgbm_tpu_torch.ops.grow import GrowParams, as_sharded
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.parallel.mesh import RowShardPlan, make_mesh

# six pytest workers share the box's cores: each test process keeps one
# intra-op thread
torch.set_num_threads(1)

# the benchmark's HIGGS parameters (gbdt_bench/configs/higgs.json), the
# hessian floor cut in proportion to 20,000 of its 10.5M rows
BASE = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
        "min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 0.2,
        "verbosity": -1}
PATHS = {
    "bin63": {"max_bin": 63},
    "bin255": {"max_bin": 255},
    "bagged": {"max_bin": 63, "bagging_fraction": 0.8, "bagging_freq": 1,
               "feature_fraction": 0.8},
}
SETTINGS = {"l2": {"objective": "regression"}, "depth4": {"max_depth": 4}}


def _higgs_rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 28).astype(np.float32)
    logit = 0.7 * X[:, :8].sum(1) + 0.5 * np.abs(X[:, 8]) * X[:, 9] \
        - 0.4 * X[:, 10] ** 2 + 0.3
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return X, y


def _train(params, X, y, rounds, one_shard=False):
    """A model trained serially, or by the data-parallel learner over a
    one-shard plan of the rows (``grow_tree_dp`` on a one-device mesh)."""
    ds = lt.Dataset(X, label=y, params=params).construct()
    if one_shard:
        n = ds.num_data
        ds._set_shards(RowShardPlan(mesh=make_mesh(1), axis_name="data",
                                    num_shards=1, n_rows=n,
                                    rows_per_shard=n))
    bst = lt.train(params, ds, rounds)
    assert bst._gbdt._dp == one_shard
    return bst


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_one_shard_measurement_is_the_serial_pass(path, setting):
    params = {**BASE, **PATHS[path], **SETTINGS[setting],
              "device_type": "cpu"}
    X, y = _higgs_rows(20_000, 3)
    serial = _train(params, X, y, 2)
    sharded = _train(params, X, y, 2, one_shard=True)
    assert serial.model_to_string() == sharded.model_to_string()
    assert serial._gbdt.hist_passes == sharded._gbdt.hist_passes
    assert sum(serial._gbdt.hist_passes) >= 6


def _full_tree_state():
    """A LevelState whose tree has spent its leaf budget (4 leaves in two
    level passes), so that its last search selected nothing."""
    X, y = _higgs_rows(3000, 7)
    ds = lt.Dataset(X, label=y, params={"max_bin": 63, "verbosity": -1,
                                        "device_type": "cpu"}).construct()
    bins_T, bins = ds.bins_T, ds.bins
    f, n = bins_T.shape
    B = 64
    g = torch.from_numpy(0.5 - y)
    h = torch.full((n,), 0.25)
    c = torch.ones(n)
    gp = GrowParams(num_leaves=4, max_bin=B, quant=True,
                    split=SplitParams(min_data_in_leaf=1))
    widths = gd.level_widths(4, 3)
    rows = gd.LevelRows(as_sharded(None, bins_T, bins, g, h, c),
                        torch.ones(f, dtype=torch.bool), ds.num_bins_dev,
                        ds.na_bin_dev, gp, max(widths))
    rows.front(0)
    st = gd.LevelState(4, f, B, max(widths), bins_T.device)
    io = gd.PassIO(gp, ds.num_bins_dev, ds.na_bin_dev, None, None, None, 0,
                   rows)
    gd.begin_tree(st, io, widths[0])
    count, lvl = int(st.count), 0
    while count:
        count = gd.level_pass(st, io, lvl, widths[lvl], widths[lvl + 1],
                              count)
        lvl += 1
    return st, io, lvl, widths


def _live(st, rows):
    """Every array of the state that a search or the tree reads: the first
    L rows of the per-leaf arrays, the first L - 1 of the per-node ones,
    and the rows' leaf ids."""
    L, m = st.L, st.m
    out = {k: v[:L].clone() for k, v in vars(st).items()
           if isinstance(v, torch.Tensor) and v.dim() >= 1
           and k != "slots"}
    out.update({"leaf_id": rows.leaf_ids[0].clone(),
                "count": st.count.clone(),
                "num_leaves": st.num_leaves.clone()})
    out.update({f"res.{k}": v[:L].clone()
                for k, v in st.res._asdict().items()})
    out.update({f"tree.{k}": v[:L if k in gd._LEAF_FIELDS else m].clone()
                for k, v in st.tree._asdict().items() if k != "num_leaves"})
    return out


@pytest.mark.parametrize("search", [True, False], ids=["search", "last"])
def test_a_level_that_selects_nothing_changes_nothing(search):
    """With and without the next level's search at the pass's end."""
    st, io, lvl, widths = _full_tree_state()
    assert int(st.num_leaves) == 4 and int(st.count) == 0
    before = _live(st, io.rows)
    nxt = widths[-1] if search else None
    assert gd.level_pass(st, io, lvl, widths[-1], nxt, 0) == 0
    after = _live(st, io.rows)
    for k, v in before.items():
        assert torch.equal(v, after[k]), k


def test_capture_engages_only_on_the_card_and_a_pass_of_no_host_input():
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    gp = GrowParams(num_leaves=255, max_bin=64, quant=True)
    assert gd.capture_engages(card, gp, None, None)
    assert not gd.capture_engages(cpu, gp, None, None)
    assert not gd.capture_engages(card, gp, object(), None)
    assert not gd.capture_engages(card, gp, None, object())
    eager = [GrowParams(ff_bynode=0.5)] + [
        GrowParams(split=SplitParams(**kw)) for kw in (
            {"extra_trees": True}, {"cat_features": (3,)},
            {"has_bundles": True}, {"monotone_constraints": (1, 0)},
            {"feature_contri": (0.5, 1.0)})]
    for p in eager:
        assert not gd.capture_engages(card, p, None, None), p


# ---- on the card ----

CARD_SHAPES = {
    "bin63": {"max_bin": 63},
    "bin255": {"max_bin": 255},
    "bagged": {"max_bin": 63, "bagging_fraction": 0.8, "bagging_freq": 1,
               "feature_fraction": 0.8},
}
CARD = {**BASE, "metric": "auc", "min_sum_hessian_in_leaf": 1,
        "use_quantized_grad": "auto", "device_type": "cuda"}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode)")


def _card_run(params, X, y, rounds, capture=True, monkeypatch=None):
    """(model text, LAUNCHES, the trainer) of a run on the card, capture
    on or off."""
    if not capture:
        monkeypatch.setattr(gd, "capture_engages", lambda *a: False)
    K.reset_launches()
    ds = lt.Dataset(X, label=y, params=params)
    bst = lt.train(params, ds, rounds)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if not capture:
        monkeypatch.undo()
    return bst.model_to_string(), launches, bst._gbdt


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_graphed_grower_gives_the_uncaptured_model(shape, monkeypatch):
    """The same model text and the same kernel launches with capture on
    and off."""
    _need_card()
    params = {**CARD, **CARD_SHAPES[shape]}
    X, y = _higgs_rows(100_000, 5)
    text, launches, trainer = _card_run(params, X, y, 4)
    plain, plain_launches, _ = _card_run(params, X, y, 4, capture=False,
                                         monkeypatch=monkeypatch)
    assert text == plain
    assert launches == plain_launches, (launches, plain_launches)
    graphs = trainer._level_graphs
    # the root's start and search, and one a (width, next width)
    assert 3 <= graphs.captures == len(graphs.graphs) <= 5, graphs.graphs


@pytest.mark.cuda
def test_a_replayed_pass_reads_the_host_once():
    """torch's sync debug mode warns once a replayed level pass: the
    count of the next search's selection."""
    import warnings
    _need_card()
    params = {**CARD, "max_bin": 63}
    X, y = _higgs_rows(100_000, 5)
    ds = lt.Dataset(X, label=y, params=params)
    bst = lt.train(params, ds, 2)
    trainer = bst._gbdt
    assert trainer._level_graphs.captures >= 2
    replays = []
    real = gd.LevelGraphs.replay

    def counting(self, key):
        replays.append(key)
        return real(self, key)

    gd.LevelGraphs.replay = counting
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                # one tree's level passes, every one a replay
                tree, _, passes, _ = trainer._grow(
                    trainer.gp, (None, None, None),
                    (trainer.train_score, trainer._aux, trainer._bag), 99)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        gd.LevelGraphs.replay = real
    hits = [w for w in seen
            if "synchronizing CUDA operation" in str(w.message)]
    # the tree's start, then every level pass
    assert replays[0][0] == "root"
    assert passes == len(replays) - 1 > 5
    # the front's count and one a pass but the last, which searches no more
    # when the tree has spent its leaves
    reads = passes + 1 - (tree.num_leaves == params["num_leaves"])
    assert len(hits) == reads, [f"{w.filename}:{w.lineno}" for w in hits]


@pytest.mark.cuda
def test_one_level_graphs_captures_anew_for_another_dataset():
    """One LevelGraphs over two Datasets of different row counts: the
    second captures its own graphs, and each tree equals the uncaptured
    grower's."""
    _need_card()
    graphs = gd.LevelGraphs()
    for n in (60_000, 45_000):
        params = {**CARD, "max_bin": 63}
        X, y = _higgs_rows(n, n)
        ds = lt.Dataset(X, label=y, params=params).construct()
        bst = lt.Booster(params=params, train_set=ds)
        tr = bst._gbdt
        before = graphs.captures
        trees = {}
        for capture in (True, False):
            args = (ds.bins_T, None, None, None, ds.num_bins_dev,
                    ds.na_bin_dev, tr._fmask_ones, tr.gp)
            kw = dict(qseed=3, bins=ds.bins,
                      fused=(tr.train_score, tr._aux, tr._bag))
            for _ in range(2):
                tree, lid, _ = gd.grow_tree_depthwise(
                    *args, graphs=graphs if capture else None, **kw)
            trees[capture] = (tree, lid)
        assert graphs.captures > before
        assert graphs.key[1] == n
        (a, la), (b, lb) = trees[True], trees[False]
        assert a.num_leaves == b.num_leaves > 1
        assert torch.equal(la, lb)
        for k in a._fields[:-1]:
            assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.cuda
def test_capture_beside_a_thread_using_the_card(monkeypatch):
    """A model trained while another thread allocates, computes and reads
    back on the card (a server answering beside training) captures its
    passes and equals the model trained with capture off."""
    import threading
    _need_card()
    params = {**CARD, "max_bin": 63}
    X, y = _higgs_rows(60_000, 11)
    stop, errors = threading.Event(), []

    def busy():
        try:
            while not stop.is_set():
                a = torch.randn(4096, 64, device="cuda")
                float((a @ a.T).sum().item())
        except Exception as e:       # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=busy)
    th.start()
    try:
        text, _, trainer = _card_run(params, X, y, 3)
    finally:
        stop.set()
        th.join()
    assert not errors, errors
    assert trainer._level_graphs.captures >= 3
    plain, _, _ = _card_run(params, X, y, 3, capture=False,
                            monkeypatch=monkeypatch)
    assert text == plain
