"""The cold start of the PyTorch/CUDA port (lightgbm_tpu_torch/ingest.py,
prewarm.py) against the JAX reference's (lightgbm_tpu/ingest.py,
prewarm.py), on the CPU; the repair of ROADMAP C14 (``ingest_chunk_rows``,
``encode_threads`` and ``prewarm`` were accepted and read nowhere).

The chunked pipeline's uint8 bins equal the reference Dataset's exactly,
for every chunking and thread count, dense and under an EFB plan, and equal
the column-at-a-time encode (``binning.bin_data``, the pipeline's plain
version). On the CPU the pipeline's stages are host threads and its
"copies" are host copies; the card's pinned buffers, copy stream and
events are held against the plain version by tests/test_torch_cuda.py and
chip_smoke.py. The prewarm's worker runs on the CPU with the kernels'
plain versions (``prewarm.CUDA_ONLY`` off, ``MIN_PREWARM_ROWS`` 0, as the
reference's own tests lower its row gate), so its events and its adoption
are compared with the reference's; the reference's ``compile`` events (its
AOT lowering) are JAX-only and filtered.
"""
import collections
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import ingest as ref_ingest
from lightgbm_tpu import obs as ref_obs
from lightgbm_tpu import prewarm as ref_prewarm
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import ingest, obs, prewarm
from lightgbm_tpu_torch.binning import bin_data
from lightgbm_tpu_torch.utils import faults

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

RNG = np.random.RandomState(7)
N, F = 2000, 9
X = RNG.rand(N, F).astype(np.float32)
# a low-cardinality column and some NaNs exercise the mappers inside the
# threaded encoders (the label is drawn before the NaNs)
X[:, 3] = RNG.randint(0, 5, N)
Y = (X[:, 0] + 0.5 * X[:, 1] + 0.1 * RNG.randn(N)).astype(np.float32)
X[RNG.rand(N, F) < 0.02] = np.nan
# an EFB-bundled layout: 3 dense columns and 12 one-hot-like sparse ones
XS = np.zeros((N, 15))
XS[:, :3] = RNG.rand(N, 3)
XS[np.arange(N), 3 + RNG.randint(0, 12, N)] = 1.0
YS = (XS[:, 0] + XS[:, 4] > 0.8).astype(np.float32)

BASE = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
        "min_data_in_leaf": 5}
CPU = {"device_type": "cpu"}
PALLAS = {"histogram_impl": "pallas", "use_quantized_grad": "true"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("LGBMTPU_TELEMETRY", raising=False)
    monkeypatch.setattr(prewarm, "MIN_PREWARM_ROWS", 0)
    monkeypatch.setattr(prewarm, "CUDA_ONLY", False)
    monkeypatch.setattr(ref_prewarm, "MIN_PREWARM_ROWS", 0)
    for o in (obs, ref_obs):
        o.reset()
        o.configure(enabled=False, metrics_out="")
    faults.reset()
    yield
    for o in (obs, ref_obs):
        o.reset()
        o.configure(enabled=False, metrics_out="")
    faults.reset()


def _port_ds(x=X, y=Y, **extra):
    return lt.Dataset(x, label=y, params={**BASE, **CPU, "prewarm": 0,
                                          **extra})


def _sig(bst):
    """Model text without the parameter echo (prewarm, encode_threads and
    ingest_chunk_rows are echoed; the trees must be identical)."""
    return "\n".join(line for line in bst.model_to_string().splitlines()
                     if not line.startswith("["))


@pytest.fixture(scope="module")
def ref_bins():
    out = {}
    for name, x, y in (("dense", X, Y), ("efb", XS, YS)):
        ds = lgb.Dataset(x.copy(), label=y.copy(),
                         params={**BASE, "prewarm": 0}).construct()
        out[name] = (np.asarray(ds.bins), ds.bundle_meta is not None)
    return out


@pytest.mark.parametrize("layout", ["dense", "efb"])
@pytest.mark.parametrize("chunk", [N, 7, 64])
@pytest.mark.parametrize("threads", [1, 4])
def test_bins_equal_reference_for_every_chunking(ref_bins, layout, chunk,
                                                 threads):
    x, y = (X, Y) if layout == "dense" else (XS, YS)
    want, bundled = ref_bins[layout]
    ds = _port_ds(x, y, ingest_chunk_rows=chunk,
                  encode_threads=threads).construct()
    assert (ds.bundle_meta is not None) == bundled == (layout == "efb")
    got = ds.bins.numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    stats = ingest.last_stats()
    assert stats["chunks"] == -(-N // chunk)
    assert stats["encode_threads"] == min(threads, stats["chunks"])
    # the plain version: the column-at-a-time encode, bundled after
    plain = bin_data(x, ds.mappers, list(ds.feature_map), torch.device("cpu"))
    if ds.bundle_meta is not None:
        from lightgbm_tpu_torch.efb import apply_bundles
        plain = apply_bundles(plain, ds.bundle_meta)
    assert np.array_equal(plain.numpy(), got)


def test_trees_identical_across_chunkings_and_prewarm():
    ref = _sig(lt.train({**BASE, **CPU, "prewarm": 0,
                         "ingest_chunk_rows": 10 ** 9},
                        _port_ds(ingest_chunk_rows=10 ** 9), 3))
    for extra in ({"prewarm": 1, "ingest_chunk_rows": 10 ** 9},
                  {"prewarm": 0, "ingest_chunk_rows": 700,
                   "encode_threads": 4},
                  {"prewarm": 1, "ingest_chunk_rows": 7,
                   "encode_threads": 4}):
        p = {**BASE, **CPU, **extra}
        bst = lt.train(p, lt.Dataset(X, label=Y, params=p), 3)
        assert _sig(bst) == ref, extra
        assert bst._gbdt.prewarm_adopted == bool(extra["prewarm"])


def test_construct_phases_are_disjoint_with_busy_breakdown():
    ds = _port_ds(ingest_chunk_rows=512, encode_threads=2).construct()
    ph = ds.construct_phases
    for key in ("find_bins_s", "efb_plan_s", "stream_s", "stream_busy",
                "overlap_efficiency"):
        assert key in ph, f"missing phase key {key}: {ph}"
    busy = ph["stream_busy"]
    assert set(busy) >= {"encode_s", "h2d_s", "commit_s", "encode_threads",
                         "chunks"}
    assert busy["chunks"] == -(-N // 512)
    assert 0.0 <= ph["overlap_efficiency"] <= 1.0
    # the stages' busy seconds are not wall segments: no top-level key
    assert "encode_s" not in ph and "upload_s" not in ph
    stats = ingest.last_stats()
    assert stats["chunks"] == busy["chunks"]
    assert stats["encode_threads"] == busy["encode_threads"] == 2


@pytest.mark.parametrize("spans,wall,want", [
    ((2.0, 1.0, 1.0), 4.0, 0.0),    # serial
    ((2.0, 1.0, 1.0), 2.0, 1.0),    # perfect
    ((2.0, 1.0, 1.0), 3.0, 0.5),
    ((5.0,), 5.0, 1.0),             # nothing to hide
    ((1.0, 1.0), 9.0, 0.0)])        # clamped
def test_overlap_efficiency_math(spans, wall, want):
    assert ingest.overlap_efficiency(spans, wall) == want
    assert ref_ingest.overlap_efficiency(spans, wall) == want


def _events(o):
    """(type, sorted field names, phase or chunk) of the cold-start events,
    as a multiset: the pipeline's threads order them freely."""
    keep = ("ingest_chunk", "aot_prewarm", "device_fault")
    return collections.Counter(
        (e["type"], tuple(sorted(k for k in e if k not in ("ts", "type"))),
         e.get("phase", e.get("action")))
        for e in o.EVENTS.snapshot() if e["type"] in keep)


def test_cold_start_events_match_reference():
    """Construct (512-row chunks) and train 2 rounds with prewarm and
    telemetry in both packages: the same ingest_chunk and aot_prewarm
    events (started, compiled, adopted) with the same fields."""
    for pkg, o, extra in ((lgb, ref_obs, PALLAS), (lt, obs, CPU)):
        p = {**BASE, **extra, "prewarm": 1, "ingest_chunk_rows": 512,
             "telemetry": 1}
        o.configure(enabled=True)
        pkg.train(p, pkg.Dataset(X.copy(), label=Y.copy(), params=p), 2)
    mine, ref = _events(obs), _events(ref_obs)
    assert mine == ref
    assert sum(v for (t, _, _), v in mine.items()
               if t == "ingest_chunk") == -(-N // 512)
    assert {ph for (t, _, ph) in mine if t == "aot_prewarm"} == \
        {"started", "compiled", "adopted"}


def test_prewarm_skip_reasons_match_reference():
    for pkg, o, extra in ((lgb, ref_obs, PALLAS), (lt, obs, CPU)):
        o.configure(enabled=True)
        pkg.Dataset(X.copy(), label=Y.copy(),
                    params={**BASE, **extra, "prewarm": 0}).construct()
        pkg.Dataset(X.copy(), params={**BASE, **extra}).construct()
    reasons = [[e["reason"] for e in o.EVENTS.snapshot()
                if e["type"] == "aot_prewarm"] for o in (obs, ref_obs)]
    assert reasons[0] == reasons[1] == ["prewarm=0",
                                        "no label (nothing to train)"]


def test_cpu_dataset_skips_the_prewarm(monkeypatch):
    monkeypatch.setattr(prewarm, "CUDA_ONLY", True)
    obs.configure(enabled=True)
    ds = _port_ds(prewarm=1).construct()
    assert ds._prewarm is None
    assert [e["reason"] for e in obs.EVENTS.snapshot()
            if e["type"] == "aot_prewarm"] == [
        "device_type=cpu (no kernel library to load)"]


def test_prewarm_spec_mismatch_is_a_miss():
    """A Dataset constructed for L2 warms the fused path; an L1 trainer on
    it takes the unfused one: a miss, and the same trees as without."""
    obs.configure(enabled=True)
    ds = _port_ds(prewarm=1, max_bin=63).construct()
    assert ds._prewarm is not None
    p = {**BASE, **CPU, "objective": "regression_l1", "telemetry": 1,
         "max_bin": 63}
    bst = lt.train(p, ds, 2)
    assert not bst._gbdt.prewarm_adopted
    assert any(e["type"] == "aot_prewarm" and e.get("phase") == "miss"
               and e.get("reason") == "spec mismatch"
               for e in obs.EVENTS.snapshot())
    want = lt.train(p, _port_ds(max_bin=63), 2)
    assert _sig(bst) == _sig(want)


# configurations whose kernel path differs (the fused front, the custom
# steps of GOSS and RF, the lossguide grower, k > 1, weights, the lean
# feature tile, a pool that extra_trees keeps whole, CEGB, forced splits
# and a forced-split file that forces nothing, too many F * B cells)
_PATH_CASES = {
    "fused": {},
    "weighted": {"_weight": True},
    "goss": {"boosting": "goss"},
    "rf": {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.8},
    "lossguide": {"grow_policy": "lossguide"},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "lean": {"histogram_pool_size": 0.01},
    "pool_extra_trees": {"histogram_pool_size": 0.01, "extra_trees": True},
    "cegb": {"cegb_penalty_split": 0.1},
    "forced": {"_forced": {"feature": 0, "threshold": 0.5}},
    "forced_nothing": {"_forced": {"threshold": 0.5}},
    "wide_bins": {"max_bin": 255},
}


@pytest.mark.parametrize("case", sorted(_PATH_CASES))
def test_prewarm_predicts_the_trainers_path(case, tmp_path):
    """The prewarm's spec and kernels, predicted from the Dataset's
    metadata, are the trainer's own (both from models/gbdt.kernel_path):
    adopted on every path."""
    extra = dict(_PATH_CASES[case])
    weight = RNG.rand(N) + 0.5 if extra.pop("_weight", False) else None
    forced = extra.pop("_forced", None)
    if forced is not None:
        fp = tmp_path / "forced.json"
        fp.write_text(json.dumps(forced))
        extra["forcedsplits_filename"] = str(fp)
    y = (np.digitize(Y, np.quantile(Y, [1 / 3, 2 / 3])).astype(np.float32)
         if extra.get("objective") == "multiclass" else Y)
    p = {**BASE, **CPU, "max_bin": 63, **extra}
    ds = lt.Dataset(X, label=y, weight=weight, params={**p, "prewarm": 1})
    bst = lt.train(p, ds, 1)
    h = ds._prewarm
    assert "error" not in h.result, h.result
    assert h.spec == prewarm.step_spec(bst._gbdt)
    assert h.kernels == bst._gbdt.path.kernels
    assert bst._gbdt.prewarm_adopted


def test_prewarm_compile_fault_is_a_miss_with_the_same_trees():
    obs.configure(enabled=True)
    p = {**BASE, **CPU, "prewarm": 1, "telemetry": 1,
         "faults": "prewarm_compile:1"}
    bst = lt.train(p, lt.Dataset(X, label=Y, params=p), 3)
    assert faults.hits("prewarm_compile") == 1
    ev = obs.EVENTS.snapshot()
    phases = [e.get("phase") for e in ev if e["type"] == "aot_prewarm"]
    assert "error" in phases and "miss" in phases and "adopted" not in phases
    assert not bst._gbdt.prewarm_adopted
    want = lt.train({**BASE, **CPU}, _port_ds(), 3)
    assert _sig(bst) == _sig(want)


def test_prewarm_warms_its_path_counted_apart():
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    ds = _port_ds(prewarm=1, max_bin=63).construct()
    h = ds._prewarm.join()
    assert h.spec["fused"] and h.spec["grower"] == "depthwise"
    assert h.kernels == ("grad_quant_hist0", "hist_routed_fused",
                         "leaf_sums_grad", "take_small")
    # the plain versions launch nothing: no count moves, neither apart
    assert h.result["warmed"] == {} and h.result["load_s"] == 0.0
    assert sum(hk.LAUNCHES.values()) == 0


def test_device_put_oom_halves_the_chunk_once():
    obs.configure(enabled=True)
    want = _port_ds(ingest_chunk_rows=512).construct().bins.numpy()
    faults.configure("device_put_oom:1")
    ds = _port_ds(ingest_chunk_rows=512).construct()
    assert np.array_equal(ds.bins.numpy(), want)
    assert ingest.last_stats()["chunk_rows"] == 256
    assert ingest.last_stats()["chunks"] == -(-N // 256)
    df = [e for e in obs.EVENTS.snapshot() if e["type"] == "device_fault"]
    assert len(df) == 1
    assert (df[0]["point"], df[0]["action"], df[0]["chunk_rows"]) == \
        ("device_put_oom", "halve_chunk", 256)


def test_device_fault_recovery_bounds_and_fatal_policy():
    sleeps = []
    ds = _port_ds()
    ds.construct()
    args = (X, ds.mappers, list(ds.feature_map), None, torch.device("cpu"))
    faults.configure("device_put_oom:-1")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        ingest.stream_with_recovery(*args, chunk_rows=512,
                                    sleep=sleeps.append)
    assert len(sleeps) == ingest.MAX_CHUNK_HALVINGS
    faults.configure("device_put_oom:1")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        ingest.stream_with_recovery(*args, chunk_rows=512, policy="fatal")


@pytest.mark.parametrize("stage", ["encode", "h2d", "commit"])
def test_an_error_in_any_stage_propagates(monkeypatch, stage):
    ds = _port_ds()
    ds.construct()

    def boom(*a, **k):
        raise ValueError("boom")

    class Rows(np.ndarray):
        """Rows whose chunks cannot be read: the encode stage fails."""

        def __getitem__(self, key):
            boom()
    rows = X
    if stage == "encode":
        rows = X.view(Rows)
    elif stage == "commit":
        monkeypatch.setattr(ingest, "bin_rows_device", boom)
    else:
        monkeypatch.setattr(faults, "fault_point", boom)
    with pytest.raises(ValueError, match="boom"):
        ingest.stream_encode_upload(
            rows, ds.mappers, list(ds.feature_map), None,
            torch.device("cpu"), chunk_rows=64, encode_threads=4)


def test_c14_each_knob_takes_effect():
    """ingest_chunk_rows sets the chunk count, encode_threads the encode
    pool, prewarm whether the construct starts a warm-up."""
    _port_ds(ingest_chunk_rows=100, encode_threads=3).construct()
    assert (ingest.last_stats()["chunks"],
            ingest.last_stats()["encode_threads"]) == (20, 3)
    _port_ds(ingest_chunk_rows=1000, encode_threads=1).construct()
    assert (ingest.last_stats()["chunks"],
            ingest.last_stats()["encode_threads"]) == (2, 1)
    assert _port_ds(prewarm=1).construct()._prewarm is not None
    assert _port_ds(prewarm=0).construct()._prewarm is None
    assert ingest.resolve_encode_threads(0) == \
        ref_ingest.resolve_encode_threads(0)
