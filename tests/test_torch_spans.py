"""The spans of the port's boosting iteration (lightgbm_tpu_torch/obs/
tracing.py), on the CPU.

Small depthwise and leaf-wise models train for 2 iterations under a CPU
``torch.profiler``: every span of the iteration appears, nested as the
program nests them (``grow.pass`` tiled by ``pass.search``, ``pass.apply``
and ``pass.hist``; each host sync in a ``sync.<site>`` span), one
``grow.pass`` a level pass or split step the trainer counts, one
``sync.select`` in each depthwise ``pass.search`` and no other sync in a
depthwise ``grow.pass`` (a replayed pass on the card reads its count in
``grow.pass``, after ``pass.replay``). With no profiler and
telemetry off a span opens no range and reads no clock, and ``TIMER``
holds only the engine's and the Dataset's spans; the timing table
(``verbosity >= 2``) times every span. A LambdaRank model opens one
``obj.pair_grid`` a gradients call, inside ``iter.gradients``. No tracing
setting changes the model text.
"""
import collections

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import tracing
from lightgbm_tpu_torch.utils.timer import TIMER

# six pytest workers share the box's cores: each test process keeps one
# intra-op thread
torch.set_num_threads(1)

CPU = {"device_type": "cpu", "verbosity": -1}
DEPTHWISE = {"objective": "binary", "num_leaves": 15, **CPU}
LEAFWISE = {**DEPTHWISE, "grow_policy": "lossguide"}
RANKING = {**DEPTHWISE, "objective": "lambdarank", "metric": "ndcg",
           "eval_at": [10]}
PHASES = ("iter.sample", "iter.gradients", "obj.pair_grid", "grow.tree",
          "grow.front", "grow.pass", "pass.search", "pass.apply",
          "pass.hist", "pass.replay", "grow.leaf_renew", "iter.score_update")
ENGINE = ("boosting", "eval", "dataset_construct")
# each span's allowed parents: the innermost program span that holds it
PARENTS = {
    "iter.sample": {"boosting"}, "iter.gradients": {"boosting"},
    "obj.pair_grid": {"iter.gradients"},
    "grow.tree": {"boosting"}, "grow.front": {"grow.tree"},
    "grow.pass": {"grow.tree"}, "pass.search": {"grow.pass"},
    "pass.apply": {"grow.pass"}, "pass.hist": {"grow.pass"},
    "pass.replay": {"grow.pass"},
    "grow.leaf_renew": {"grow.tree", "boosting"},
    "iter.score_update": {"boosting"},
    "sync.select": {"pass.search", "grow.front", "grow.pass"},
    "sync.step": {"pass.search", "grow.front"},
    "sync.apply": {"pass.apply"}, "sync.finite": {"boosting"},
    "sync.shrink": {"iter.score_update"},
    "sync.route": {"iter.score_update"}, "sync.metric": {"eval"},
    "sync.init_score": {"boosting"}, "sync.column_mask": {"iter.sample"},
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("LGBMTPU_TELEMETRY", raising=False)
    obs.reset()
    obs.configure(enabled=False, metrics_out="")
    yield
    obs.reset()
    obs.configure(enabled=False, metrics_out="")


def _data(n=1500, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * rng.rand(n) > 0.7).astype(np.float32)
    return X, y


def _query_sizes(n, mean, rng):
    """Query sizes max(2, geometric(1 / mean)) summing to n."""
    sizes = []
    while sum(sizes) < n:
        sizes.append(max(2, int(rng.geometric(1.0 / mean))))
    sizes[-1] -= sum(sizes) - n
    if sizes[-1] < 1:
        sizes[-2] += sizes.pop()
    return np.asarray(sizes, np.int64)


def _ranking_rows(n, f, seed, mean=25):
    """(X, y, group): graded labels 0-4 from a noisy linear score, in
    queries of about ``mean`` documents."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    score = X[:, :4].sum(1) + 0.7 * rng.randn(n)
    y = np.digitize(score, np.quantile(score, [0.55, 0.8, 0.93, 0.985]))
    return X, y.astype(np.float32), _query_sizes(n, mean, rng)


def _train(params, rounds=2, seed=0):
    if params["objective"] == "lambdarank":
        X, y, group = _ranking_rows(1500, 6, seed)
        cut = int(np.searchsorted(np.cumsum(group), 400)) + 1
        kw, vkw = {"group": group}, {"group": group[:cut]}
        n_valid = int(group[:cut].sum())
    else:
        X, y = _data(seed=seed)
        kw, vkw, n_valid = {}, {}, 400
    ds = lt.Dataset(X, label=y, params=params, **kw)
    vs = lt.Dataset(X[:n_valid], label=y[:n_valid], reference=ds,
                    params=params, **vkw)
    return lt.train(params, ds, rounds, valid_sets=[vs], verbose_eval=False)


def _program(name):
    return name in PHASES or name in ENGINE or name.startswith("sync.")


def _profiled(params):
    """(booster, [(name, parent program span's name, event)]) of a run
    under a CPU profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        bst = _train(params)
    out = []
    for e in prof.events():
        if not _program(e.name):
            continue
        up = e.cpu_parent
        while up is not None and not _program(up.name):
            up = up.cpu_parent
        out.append((e.name, None if up is None else up.name, e))
    return bst, out


def _inside(events, outer, inner):
    """How many ``inner`` spans each ``outer`` span holds."""
    counts = []
    for name, _, e in events:
        if name != outer:
            continue
        counts.append(sum(
            n == inner and e.time_range.start <= c.time_range.start
            and c.time_range.end <= e.time_range.end for n, _, c in events))
    return counts


@pytest.mark.parametrize("params", [DEPTHWISE, LEAFWISE],
                         ids=["depthwise", "leafwise"])
def test_spans_nest_as_the_program_nests_them(params):
    bst, events = _profiled(params)
    names = collections.Counter(n for n, _, _ in events)
    for name, parent, _ in events:
        if name in PARENTS:
            assert parent in PARENTS[name], (name, parent)
        elif name.startswith("sync."):
            assert parent is not None, name
    want = {"boosting", "eval", "iter.sample", "grow.tree", "grow.front",
            "grow.pass", "pass.search", "pass.apply", "pass.hist",
            "iter.score_update", "sync.finite", "sync.shrink",
            "sync.route", "sync.metric"}
    want |= ({"grow.leaf_renew", "sync.select"}
             if params is DEPTHWISE else {"iter.gradients", "sync.step"})
    assert want <= set(names), sorted(want - set(names))
    assert names["boosting"] == names["eval"] == 2
    assert names["grow.tree"] == names["sync.finite"] == 2
    # one pass a level pass (depthwise) or split step (leaf-wise)
    assert names["grow.pass"] == sum(bst._gbdt.hist_passes) > 2
    # each pass is tiled by its phases
    for ph in ("pass.apply", "pass.hist"):
        assert min(_inside(events, "grow.pass", ph)) >= 1


def test_each_depthwise_search_holds_one_selection_read():
    _, events = _profiled(DEPTHWISE)
    per_search = _inside(events, "pass.search", "sync.select")
    assert per_search and set(per_search) == {1}
    # the root's selection is the front's, one a tree
    assert _inside(events, "grow.front", "sync.select") == [1, 1]
    # the level pass writes the parents' child pointers and the frontier
    # on the card: no read but the selection's
    assert len(_inside(events, "grow.pass", "pass.hist")) > 2
    for site in ("sync.apply", "sync.frontier"):
        assert set(_inside(events, "grow.pass", site)) == {0}, site
    assert sum(_inside(events, "grow.pass", "sync.select")) == \
        len(_inside(events, "pass.search", "sync.select"))


def test_the_pair_grid_opens_once_a_gradients_call():
    bst, events = _profiled(RANKING)
    names = collections.Counter(n for n, _, _ in events)
    assert names["obj.pair_grid"] == names["iter.gradients"] == 2
    assert {p for n, p, _ in events if n == "obj.pair_grid"} == \
        {"iter.gradients"}
    assert _inside(events, "iter.gradients", "obj.pair_grid") == [1, 1]
    # the grid reads nothing back to the host
    grids = [e.time_range for n, _, e in events if n == "obj.pair_grid"]
    syncs = [e.time_range for n, _, e in events if n.startswith("sync.")]
    assert syncs and not any(g.start <= c.start and c.end <= g.end
                             for g in grids for c in syncs)
    # no other objective opens it
    _, binary = _profiled(DEPTHWISE)
    assert "obj.pair_grid" not in {n for n, _, _ in binary}


def test_spans_cost_no_range_and_no_clock_when_off(monkeypatch):
    ranges, clocks = [], []
    real_rf, real_clock = tracing.record_function, tracing.time.perf_counter

    class Clock:
        @staticmethod
        def perf_counter():
            clocks.append(1)
            return real_clock()

    def counting_rf(name):
        ranges.append(name)
        return real_rf(name)

    monkeypatch.setattr(tracing, "record_function", counting_rf)
    monkeypatch.setattr(tracing, "time", Clock)
    assert tracing.span("pass.search") is tracing.span("sync.select")
    with tracing.span("pass.search"):
        pass
    assert ranges == [] and clocks == []
    TIMER.begin_run()
    _train(DEPTHWISE)
    assert ranges == []
    assert set(TIMER.snapshot()) <= set(ENGINE), TIMER.snapshot()
    # the engine's spans alone read the clock: two reads each
    counts = TIMER.snapshot()
    assert len(clocks) == 2 * sum(v["count"] for v in counts.values())
    # under a profiler every span opens its range
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("sync.select"):
            pass
    assert ranges == ["sync.select"]


def test_telemetry_and_the_timing_table_time_every_span():
    TIMER.begin_run()
    _train({**DEPTHWISE, "telemetry": True})
    snap = TIMER.snapshot()
    assert {"grow.tree", "grow.pass", "pass.search", "sync.select",
            "sync.finite", "boosting"} <= set(snap)
    assert snap["grow.tree"]["count"] == 2
    series = obs.METRICS.to_json()["span_seconds"]["series"]
    assert '{span="pass.hist"}' in series
    TIMER.begin_run()
    _train({**DEPTHWISE, "verbosity": 2})
    assert snap.keys() <= TIMER.snapshot().keys()
    assert "span_seconds" not in obs.METRICS.to_json() or \
        obs.METRICS.to_json()["span_seconds"]["series"] == series
    # the table is asked for by one run only
    TIMER.begin_run()
    _train(DEPTHWISE)
    assert set(TIMER.snapshot()) <= set(ENGINE)


def test_timer_scope_is_an_always_timed_span():
    TIMER.begin_run()
    with TIMER.scope("unit"):
        pass
    with tracing.span("unit", timed=True):
        pass
    with tracing.span("unit"):
        pass
    assert TIMER.snapshot()["unit"]["count"] == 2


@pytest.mark.parametrize("params", [
    {**DEPTHWISE, "objective": "regression"},
    {**LEAFWISE, "objective": "regression"}, RANKING],
    ids=["depthwise", "leafwise", "ranking"])
def test_no_tracing_setting_changes_the_model(params):
    plain = _train(params, 3, seed=1).model_to_string()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = _train(params, 3, seed=1).model_to_string()
    assert profiled == plain
    timed = _train({**params, "telemetry": True}, 3, seed=1)
    table = _train({**params, "verbosity": 2}, 3, seed=1)
    strip = [s.split("\nparameters:\n")[0] for s in
             (plain, timed.model_to_string(), table.model_to_string())]
    assert strip[0] == strip[1] == strip[2]


# ---- on the card: every host sync of the loop sits in a sync.* span ----

CARD_SHAPES = {
    # HIGGS's shape (28 columns, the benchmark's cells' parameters) at
    # 100,000 train and 20,000 valid rows
    "bin63": {"max_bin": 63},
    "bin255": {"max_bin": 255},
    "bagged": {"max_bin": 63, "bagging_fraction": 0.8, "bagging_freq": 1,
               "feature_fraction": 0.8},
    "lossguide": {"max_bin": 255, "grow_policy": "lossguide",
                  "num_leaves": 63},
    # the Yahoo LTR cell's path: LambdaRank's pair grid on the unfused
    # front, NDCG@10 on the host; 20,000 train documents in queries of
    # about 25, 50 columns
    "ranking": {"max_bin": 63, "objective": "lambdarank", "metric": "ndcg",
                "eval_at": [10]},
}


def _higgs_rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 28).astype(np.float32)
    logit = 0.7 * X[:, :8].sum(1) + 0.5 * np.abs(X[:, 8]) * X[:, 9] \
        - 0.4 * X[:, 10] ** 2 + 0.3
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return X, y


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_every_host_sync_on_the_card_has_its_span(shape):
    """With torch's sync debug mode warning on every synchronizing call,
    each iteration (boosting and eval) warns once a ``sync.*`` span, the
    spans counted by the timing table (``verbosity`` 2, telemetry off, so
    that telemetry's own reads stay out)."""
    import warnings
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode)")
    params = {"objective": "binary", "metric": "auc", "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 1,
              "min_sum_hessian_in_leaf": 1, "use_quantized_grad": "auto",
              "device_type": "cuda", "verbosity": 2,
              **CARD_SHAPES[shape]}
    if params["objective"] == "lambdarank":
        X, y, group = _ranking_rows(24_000, 50, 5)
        cut = int(np.searchsorted(np.cumsum(group), 20_000)) + 1
        n = int(group[:cut].sum())
        kw, vkw = {"group": group[:cut]}, {"group": group[cut:]}
    else:
        X, y = _higgs_rows(120_000, 5)
        n, kw, vkw = 100_000, {}, {}
    ds = lt.Dataset(X[:n], label=y[:n], params=params, **kw)
    vs = lt.Dataset(X[n:], label=y[n:], reference=ds, params=params, **vkw)
    ds.construct()
    vs.construct()
    torch.cuda.synchronize()
    marks = []

    def syncs():
        return sum(v["count"] for k, v in TIMER.snapshot().items()
                   if k.startswith("sync."))

    def before(env):
        marks.append((len(seen), syncs()))
    before.before_iteration = True

    def after(env):
        marks.append((len(seen), syncs()))

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            lt.train(params, ds, 4, valid_sets=[vs], verbose_eval=False,
                     callbacks=[before, after])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rows = []
    for (w0, s0), (w1, s1) in zip(marks[0::2], marks[1::2]):
        hits = [w for w in seen[w0:w1]
                if "synchronizing CUDA operation" in str(w.message)]
        where = collections.Counter(
            f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in hits)
        rows.append((len(hits), s1 - s0, dict(where)))
    print(shape, [(h, s) for h, s, _ in rows])
    assert len(rows) == 4
    for hits, spans, where in rows:
        assert hits == spans > 0, (shape, hits, spans, where)
