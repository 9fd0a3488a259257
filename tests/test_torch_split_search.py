"""S1, the numerical split search (``csrc/split_search.cu``,
``hist_kernels.split_search``), against ``best_split``'s planes.

On the CPU: the wrapper's checks, its plain version (the planes), and
that a CPU search launches nothing.

On the card (marker ``cuda``, no JAX imported, so this file also runs with
``--noconftest``): every field of the kernel's ``SplitResult`` equals the
planes' bit for bit on random and near-tie histograms at the cells' shapes
(255 leaves at F 28, B 64 and 256; F 700, B 64), under feature masks per
leaf, ``allow_split`` partly false, a leaf whose every candidate is
masked, empty children, a -0.0 in the first bin, L1/L2, ``max_delta_step``
and ``min_gain_to_split``; the same inside a captured graph's replay; a
bin63, a bin255 and a LambdaRank model's text equals the same run's with
the planes forced, and ``LAUNCHES["split_search"]`` counts the run's
searches (each tree's root search and one a level pass, but the pass that
spends the leaf budget, which searches no more), 0 with the planes and on
the categorical, bundle, monotone, contri, CEGB and extra_trees searches.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import grow_depthwise as gd
from lightgbm_tpu_torch.ops import hist_kernels as K
from lightgbm_tpu_torch.ops import split as S
from lightgbm_tpu_torch.utils import threefry

# six pytest workers share the box's cores: each test process keeps one
# intra-op thread
torch.set_num_threads(1)

# split parameters: the cells' (min_data_in_leaf 1, a hessian floor), the
# L1 / L2 / min_gain_to_split terms, max_delta_step, and no floor at all
# (empty children score 0 / eps)
PARAMS = (
    {"min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 3.0},
    {"min_data_in_leaf": 2, "lambda_l1": 0.5, "lambda_l2": 1.5,
     "min_gain_to_split": 0.1},
    {"min_data_in_leaf": 3, "max_delta_step": 0.4,
     "min_sum_hessian_in_leaf": 2.0},
    {"min_data_in_leaf": 0, "min_sum_hessian_in_leaf": 0.0},
)


def _frontier(L, F, B, seed, kind="random", dev="cpu"):
    """(hist, num_bins, na_bin, pg, ph, pc, allow, [F] mask, [L, F] mask)
    of a random frontier: features below the padded axis, missing bins at
    the top and at bin 0, parents from feature 0's bins (so that other
    features' right sides may be empty or negative)."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(3, B + 1, size=F).astype(np.int32)
    nb[: F // 2] = B
    na = np.full(F, 256, np.int32)
    na[1::5] = nb[1::5] - 1
    na[3::7] = 0
    cnt = rng.integers(0, 12, size=(L, F, B)).astype(np.float32)
    cnt[:, np.arange(B)[None, :] >= nb[:, None]] = 0.0
    g = (rng.normal(size=(L, F, B)) * cnt).astype(np.float32)
    h = (rng.uniform(0.1, 0.3, size=(L, F, B)) * cnt).astype(np.float32)
    hist = np.stack([g, h, cnt], axis=1)
    if kind == "near_ties":
        # exact ties (a duplicated feature) and gains inside the band
        hist[:, :, 3] = hist[:, :, 1]
        hist[:, 0, 4] = hist[:, 0, 1] * np.float32(1 + 3e-7)
        hist[:, 1:, 4] = hist[:, 1:, 1]
    allow = np.ones(L, bool)
    lfm = np.ones((L, F), bool)
    if kind == "edges":
        # -0.0 in the first bin, a leaf whose rows lie low in every feature
        # (empty right children), a leaf of no rows, a leaf with every
        # feature masked; allow_split and a per-leaf mask partly false
        hist[:, :2, :, 0] = -0.0
        hist[min(1, L - 1), :, :, B // 4:] = 0.0
        hist[L - 1] = 0.0
        allow = rng.random(L) < 0.6
        lfm = rng.random((L, F)) < 0.7
        lfm[L // 2] = False
    pg = hist[:, 0, 0].sum(-1).astype(np.float32)
    ph = hist[:, 1, 0].sum(-1).astype(np.float32)
    pc = hist[:, 2, 0].sum(-1).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(hist), t(nb), t(na), t(pg), t(ph), t(pc), t(allow),
            t(np.ones(F, bool)), t(lfm))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(a, b, what=""):
    """Every field of two SplitResults, bit for bit (a -0.0 against +0.0
    fails too)."""
    for name, x, y in zip(S.SplitResult._fields, a, b):
        bad = (_bits(x) != _bits(y)).reshape(x.shape[0], -1).any(1)
        assert not bad.any(), (
            f"{what} {name}: rows {bad.nonzero().flatten()[:5].tolist()}: "
            f"{x[bad][:3].tolist()} against {y[bad][:3].tolist()}")


# ---- on the CPU ----

def test_split_search_on_the_cpu_is_the_planes():
    hist, nb, na, pg, ph, pc, allow, fm, lfm = _frontier(9, 6, 64, 3,
                                                         "edges")
    p = S.SplitParams(min_data_in_leaf=2, lambda_l2=0.5)
    K.reset_launches()
    for mask in (fm, lfm):
        got = S.SplitResult(*K.split_search(hist, nb, na, pg, ph, pc, mask,
                                            allow, p))
        _assert_same(got, S.best_split_planes(hist, nb, na, pg, ph, pc,
                                              mask, p, allow))
        _assert_same(got, S.best_split(hist, nb, na, pg, ph, pc, mask, p,
                                       allow))
    assert K.LAUNCHES["split_search"] == 0


@pytest.mark.parametrize("fault", ["bins16", "i64_bins", "f64_hist",
                                   "mask_rows", "categorical", "monotone"])
def test_split_search_refuses_what_it_does_not_take(fault):
    hist, nb, na, pg, ph, pc, allow, fm, _ = _frontier(4, 6, 64, 1)
    p = S.SplitParams()
    if fault == "bins16":
        hist = hist[..., :16].contiguous()
        nb = torch.clamp(nb, max=16)
    elif fault == "i64_bins":
        nb = nb.long()
    elif fault == "f64_hist":
        hist = hist.double()
    elif fault == "mask_rows":
        fm = torch.ones((3, 6), dtype=torch.bool)
    elif fault == "categorical":
        p = S.SplitParams(cat_features=(2,))
    else:
        p = S.SplitParams(monotone_constraints=(1,))
    with pytest.raises((ValueError, TypeError)):
        K.split_search(hist, nb, na, pg, ph, pc, fm, allow, p)


# ---- on the card ----

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode)")


SHAPES = {"f28_b64": (255, 28, 64), "f28_b256": (255, 28, 256),
          "f700_b64": (255, 700, 64), "f6_b128": (9, 6, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "near_ties", "edges"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_s1_equals_the_planes(shape, kind):
    _need_card()
    L, F, B = SHAPES[shape]
    before = K.LAUNCHES["split_search"]
    calls = 0
    for i, kw in enumerate(PARAMS):
        hist, nb, na, pg, ph, pc, allow, fm, lfm = _frontier(
            L, F, B, 11 * i + B, kind, "cuda")
        p = S.SplitParams(**kw)
        for mask in (fm, lfm):
            got = S.best_split(hist, nb, na, pg, ph, pc, mask, p, allow)
            want = S.best_split_planes(hist, nb, na, pg, ph, pc, mask, p,
                                       allow)
            _assert_same(got, want, f"{shape} {kind} {kw}")
            calls += 1
    assert K.LAUNCHES["split_search"] - before == calls


@pytest.mark.cuda
def test_s1_in_a_captured_graph():
    """Captured once, replayed on new frontiers copied into its inputs."""
    _need_card()
    L, F, B = SHAPES["f28_b256"]
    p = S.SplitParams(**PARAMS[0])
    static = _frontier(L, F, B, 1, "random", "cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        S.best_split(*static[:6], static[8], p, static[6])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = S.best_split(*static[:6], static[8], p, static[6])
    for seed, kind in ((2, "random"), (3, "near_ties"), (4, "edges")):
        new = _frontier(L, F, B, seed, kind, "cuda")
        for dst, src in zip(static, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = S.best_split_planes(*new[:6], new[8], p, new[6])
        _assert_same(out, want, kind)


def _higgs_rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 28).astype(np.float32)
    X[rng.rand(n, 28) < 0.02] = np.nan
    logit = 0.7 * X[:, :8].sum(1) + 0.5 * np.abs(X[:, 8]) * X[:, 9] \
        - 0.4 * X[:, 10] ** 2 + 0.3
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-np.nan_to_num(logit)))).astype(
        np.float32)
    return X, y, None


def _ranking_rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 60).astype(np.float32)
    score = X[:, :6] @ rng.randn(6) + 0.5 * rng.randn(n)
    y = np.digitize(score, np.quantile(score, [0.5, 0.75, 0.9, 0.97]))
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(min(n - sum(sizes), max(2, rng.geometric(1 / 20)))))
    return X, y.astype(np.float32), np.asarray(sizes)


RUNS = {
    "bin63": ({"objective": "binary", "max_bin": 63}, _higgs_rows),
    "bin255": ({"objective": "binary", "max_bin": 255}, _higgs_rows),
    "ranking": ({"objective": "lambdarank", "max_bin": 63,
                 "metric": "ndcg", "eval_at": [10]}, _ranking_rows),
}


def _searches(trainer):
    """Each depthwise tree's searches: the root's, and one a level pass
    but the pass that spends the leaf budget or the last level."""
    L = trainer.gp.num_leaves
    max_levels = (trainer.gp.max_depth if trainer.gp.max_depth > 0
                  else max(1, L - 1))
    levels = len(gd.level_widths(L, max_levels))
    assert len(trainer.models_dev) == len(trainer.hist_passes)
    return sum(1 + p - (p > 0 and (t.num_leaves == L or p == levels))
               for t, p in zip(trainer.models_dev, trainer.hist_passes))


@pytest.mark.cuda
@pytest.mark.parametrize("run", sorted(RUNS))
def test_model_text_equals_the_planes(run, monkeypatch):
    """The same model with S1 and with the planes forced; S1 launched once
    a search, the planes never."""
    _need_card()
    extra, rows = RUNS[run]
    params = {"num_leaves": 255, "learning_rate": 0.1,
              "min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 1.0,
              "verbosity": -1, "device_type": "cuda", **extra}
    X, y, group = rows(60_000, 7)
    out = {}
    for planes in (False, True):
        if planes:
            monkeypatch.setattr(S, "numerical_only", lambda p, f: False)
        K.reset_launches()
        ds = lt.Dataset(X, label=y, group=group, params=params)
        bst = lt.train(params, ds, 4)
        torch.cuda.synchronize()
        out[planes] = (bst.model_to_string(), K.LAUNCHES["split_search"],
                       bst._gbdt)
    (text, n_s1, trainer), (plain, n_planes, _) = out[False], out[True]
    assert text == plain
    assert trainer._level_graphs.captures >= 2
    assert n_s1 == _searches(trainer) > 4, (n_s1, trainer.hist_passes)
    assert n_planes == 0


def _bundle_arrays(F, B, dev):
    z = torch.zeros((F, B), dtype=torch.int64, device=dev)
    return S.BundleArrays(range_start=z, range_end=z + B - 1, prefix_end=z,
                          incl_default=z.bool(), valid=z.bool(),
                          is_bundle=torch.zeros(F, dtype=torch.bool,
                                                device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["categorical", "bundle", "monotone",
                                  "contri", "cegb", "extra_trees"])
def test_s1_reads_zero_where_the_planes_search(kind):
    _need_card()
    L, F, B = 16, 8, 64
    hist, nb, na, pg, ph, pc, allow, fm, _ = _frontier(L, F, B, 5,
                                                       "random", "cuda")
    kw, extra = {}, {}
    if kind == "categorical":
        kw["cat_features"] = (2,)
    elif kind == "bundle":
        kw["has_bundles"] = True
        extra["bundle"] = _bundle_arrays(F, B, "cuda")
    elif kind == "monotone":
        kw["monotone_constraints"] = (1, 0, -1)
    elif kind == "contri":
        kw["feature_contri"] = (0.5,)
    elif kind == "cegb":
        extra["gain_penalty"] = torch.full((L, F), 0.25, device="cuda")
    else:
        kw["extra_trees"] = True
        extra["rand_key"] = threefry.prng_key(3)
    K.reset_launches()
    S.best_split(hist, nb, na, pg, ph, pc, fm, S.SplitParams(**kw), allow,
                 **extra)
    assert K.LAUNCHES["split_search"] == 0
    S.best_split(hist, nb, na, pg, ph, pc, fm, S.SplitParams(), allow)
    assert K.LAUNCHES["split_search"] == 1
