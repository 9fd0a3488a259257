"""On the card: each hand-written CUDA kernel of lightgbm_tpu_torch against
its plain PyTorch version, and a small training run on the GPU against the
same run on the CPU.

Every test needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips with a
reason elsewhere: a CUDA kernel has no CPU mode. This file imports neither
JAX nor the reference package, so it runs on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: exact for the quantized front, the level passes (fused, and
route then slot histogram), the root slot histogram and take_small
(integer sums, order-free); leaf sums within 1e-6 relative (both sum the
same f32 rows in f64, in different atomic orders); the first tree of an
L2 model trained on the GPU, at max_bin=31 (fused path) and at max_bin=255
(unfused path), has the CPU-trained tree's structure and leaf values
within 1e-6 of its largest leaf value (the leaf sums may differ in their
last f32 bit, which a leaf that nearly cancels against the init bias
magnifies relatively; later trees inherit it, so only the first is
compared). The f32 histogram (hist_f32): counts exact, g and h within
2^-15 of the cell's absolute mass (f32 atomics against the plain
version's f64 sums), exact on gradients on a 1/8 grid (every partial sum
is representable); the unquantized depthwise and the leaf-wise growers'
first tree on such exact-sum data equals the CPU-trained tree bit for
bit, leaf values included. The two slot histograms group the kept rows by
slot before they sum them; their edge cases (empty slots, one slot,
dropped slots, ragged N, S = 255 and 7000, B from 2 to 256, two feature
groups, a pass keeping 10 rows) hold hist_q8 exactly and hist_f32 within
the same tolerance.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import hist_kernels as hk

N, F, B, L, S = 5000, 7, 16, 8, 3
LOGLOSS = ("logloss", 1.0, 1.0, 1.0)
FUSED = ("grad_quant_hist0", "hist_routed_fused", "leaf_sums_grad")
UNFUSED = ("hist_q8", "route_level", "leaf_sums")
STRUCT = ("split_feature", "threshold_bin", "default_left", "left_child",
          "right_child")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.fixture
def rows(dev):
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return {
        "bins_T": t(rng.integers(0, B, size=(F, N)).astype(np.uint8)),
        "score": t(rng.normal(size=N).astype(np.float32)),
        "label": t(rng.normal(size=N).astype(np.float32)),
        "label_pos": t((rng.random(N) < 0.5).astype(np.float32)),
        "bag": t((rng.random(N) < 0.8).astype(np.float32)),
        "lid": t(rng.integers(0, L, size=N).astype(np.int32)),
    }


def _front(rows, spec, const_hess):
    aux = rows["label"] if spec[0] == "l2" else rows["label_pos"]
    return (rows["bins_T"], rows["score"], aux, rows["bag"], 9, spec, B,
            const_hess)


@pytest.mark.cuda
@pytest.mark.parametrize("spec,const_hess", [(("l2",), True),
                                             (LOGLOSS, False)])
def test_grad_quant_hist0_kernel_equals_plain(rows, spec, const_hess):
    args = _front(rows, spec, const_hess)
    for a, b in zip(hk.grad_quant_hist0(*args),
                    hk.grad_quant_hist0_plain(*args)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("const_hess", [False, True])
def test_hist_routed_fused_kernel_equals_plain(rows, dev, const_hess):
    spec = ("l2",) if const_hess else LOGLOSS
    gq, hq, cq, _, _ = hk.grad_quant_hist0(*_front(rows, spec, const_hess))
    tab = torch.tensor([[0, 3, 1, 6, 2, -1, -1, -1],
                        [5, 9, 2, 11, 7, 0, 0, 0],
                        [1, 0, 0, 1, 0, 0, 0, 0],
                        list(range(L, 2 * L)),
                        [0, S, 1, S, S, S, S, S],
                        [S, 2, S, 0, S, S, S, S]], dtype=torch.int32,
                       device=dev)
    na_bin = torch.full((F,), 256, dtype=torch.int32, device=dev)
    na_bin[1] = 4
    args = (rows["bins_T"], gq, hq, cq, rows["lid"], tab, na_bin, S, B)
    for a, b in zip(hk.hist_routed_fused(*args),
                    hk.hist_routed_fused_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_leaf_sums_and_take_small_kernels_equal_plain(rows, dev):
    args = (rows["score"], rows["label_pos"], rows["bag"], rows["lid"],
            LOGLOSS, L)
    torch.testing.assert_close(hk.leaf_sums_grad(*args),
                               hk.leaf_sums_grad_plain(*args),
                               rtol=1e-6, atol=1e-6)
    table = torch.randn(L, device=dev)
    idx = torch.randint(-2, L + 2, (N,), device=dev, dtype=torch.int32)
    assert torch.equal(hk.take_small(table, idx),
                       hk.take_small_plain(table, idx))


def _wide(dev, s):
    """B = 256 bins (0 and 255 included), 3 channels and a slot vector with
    dropped slots, and route tables with NA bins and leaves that do not
    split."""
    g = torch.Generator(device=dev).manual_seed(3)
    bins_T = torch.randint(0, 256, (9, N), generator=g, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    gq = torch.randint(-127, 128, (N,), generator=g, device=dev,
                       dtype=torch.int64).to(torch.int8)
    hq = torch.randint(0, 128, (N,), generator=g, device=dev,
                       dtype=torch.int64).to(torch.int8)
    cq = (torch.rand(N, generator=g, device=dev) < 0.9).to(torch.int8)
    slot = torch.randint(-1, s + 3, (N,), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)
    return bins_T, gq, hq, cq, slot


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 5, 127])
@pytest.mark.parametrize("nch", [2, 3])
def test_hist_q8_kernel_equals_plain(dev, s, nch):
    bins_T, gq, hq, cq, slot = _wide(dev, s)
    hq = hq if nch == 3 else None
    for sl in ((None, slot) if s == 1 else (slot,)):
        args = (bins_T, gq, hq, cq, sl, s, 256)
        assert torch.equal(hk.hist_q8(*args, bins=bins_T.t().contiguous()),
                           hk.hist_q8_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("l", [8, 300])
def test_route_level_kernel_equals_plain(dev, l):
    bins_T = _wide(dev, S)[0]
    g = torch.Generator(device=dev).manual_seed(l)
    k = torch.arange(l, device=dev)
    feat = torch.randint(-1, 9, (l,), generator=g, device=dev)
    feat[:3] = -1
    tab = torch.stack([
        feat, torch.randint(0, 256, (l,), generator=g, device=dev),
        torch.randint(0, 2, (l,), generator=g, device=dev), l + k,
        torch.randint(0, S + 1, (l,), generator=g, device=dev),
        torch.randint(0, S + 1, (l,), generator=g, device=dev)]).to(
            torch.int32).contiguous()
    na_bin = torch.full((9,), 256, dtype=torch.int32, device=dev)
    na_bin[1], na_bin[4] = 0, 255
    lid = torch.randint(0, l, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    args = (bins_T, lid, tab, na_bin, S)
    for a, b in zip(hk.route_level(*args), hk.route_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_leaf_sums_kernel_equals_plain(rows, dev):
    g, h = hk.grad_rows(LOGLOSS, rows["score"], rows["label_pos"])
    args = (g * rows["bag"], h * rows["bag"], (rows["bag"] > 0).float(),
            rows["lid"], L)
    got = hk.leaf_sums(*args)
    ref = hk.leaf_sums_plain(*args)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[2], ref[2])


@pytest.mark.cuda
def test_gpu_training_matches_cpu_training(dev):
    rng = np.random.RandomState(0)
    X = rng.rand(3000, 6).astype(np.float32)
    y = (np.round((X[:, 0] * 2 + rng.rand(3000)) * 8) / 8).astype(np.float32)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 31,
              "min_data_in_leaf": 10, "verbosity": -1}
    hk.reset_launches()
    gpu = lt.train(params, lt.Dataset(X, label=y, params=params), 1)
    assert min(hk.LAUNCHES[k] for k in FUSED) > 0
    assert max(hk.LAUNCHES[k] for k in UNFUSED) == 0
    cpu_p = dict(params, device_type="cpu")
    cpu = lt.train(cpu_p, lt.Dataset(X, label=y, params=cpu_p), 1)
    (a,), (b,) = gpu._host_trees(), cpu._host_trees()
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                               atol=1e-6 * np.abs(b.leaf_value).max())


@pytest.mark.cuda
def test_gpu_training_matches_cpu_training_max_bin_255(dev):
    # 3000 rows give 255 bins a feature (B = 256) on 9 features: F * B =
    # 2304 > 2048, the unfused path
    rng = np.random.RandomState(1)
    X = rng.rand(3000, 9).astype(np.float32)
    y = (np.round((X[:, 0] * 2 + rng.rand(3000)) * 8) / 8).astype(np.float32)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 255,
              "min_data_in_leaf": 10, "verbosity": -1}
    hk.reset_launches()
    ds = lt.Dataset(X, label=y, params=params)
    gpu = lt.train(params, ds, 1)
    assert ds.max_num_bins > 128
    assert min(hk.LAUNCHES[k] for k in UNFUSED) > 0
    assert max(hk.LAUNCHES[k] for k in FUSED) == 0
    cpu_p = dict(params, device_type="cpu")
    cpu = lt.train(cpu_p, lt.Dataset(X, label=y, params=cpu_p), 1)
    (a,), (b,) = gpu._host_trees(), cpu._host_trees()
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                               atol=1e-6 * np.abs(b.leaf_value).max())


def _f32_rows(dev, n, f, b, s, grid):
    """bins over [0, B), Gaussian or 1/8-grid (|g| < 4) gradients, uniform
    hessians (1/8 grid too with grid), a 0/1 bag and a slot vector with
    dropped slots (negative and >= S)."""
    gen = torch.Generator(device=dev).manual_seed(11 + s + b)
    bins_T = torch.randint(0, b, (f, n), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    bag = (torch.rand(n, generator=gen, device=dev) < 0.9).float()
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    if grid:
        g = torch.clamp(torch.round(g * 8), -31, 31) / 8
        h = torch.round(h * 8) / 8
    slot = torch.randint(-1, s + 3, (n,), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    return bins_T, g * bag, h * bag, bag, slot


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(256, 1), (256, 32), (256, 127), (64, 127)])
def test_hist_f32_kernel_within_plain(dev, b, s):
    # counts exact; g, h within 2^-15 of the cell's absolute mass (the
    # chip_smoke.py shapes: 10.5M rows, 28 features)
    n, f = 10_500_000, 28
    bins_T, g, h, c, slot = _f32_rows(dev, n, f, b, s, grid=False)
    for sl in ((None, slot) if s == 1 else (slot,)):
        got = hk.hist_f32(bins_T, g, h, c, sl, s, b,
                          bins=bins_T.t().contiguous())
        ref = hk.hist_f32_plain(bins_T, g, h, c, sl, s, b)
        mass = hk.hist_f32_plain(bins_T, g.abs(), h, c, sl, s, b).double()
        assert got.shape == (s, 3, f, b) and got.dtype == torch.float32
        assert torch.equal(got[:, 2], ref[:, 2])
        err = (got.double() - ref.double()).abs()[:, :2]
        assert bool((err <= 2.0 ** -15 * mass[:, :2]).all()), \
            float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(256, 1), (64, 127)])
def test_hist_f32_kernel_exact_on_grid(dev, b, s):
    # exact: 1/8-grid rows make every partial sum representable in f32
    bins_T, g, h, c, slot = _f32_rows(dev, 1_000_000, 28, b, s, grid=True)
    args = (bins_T, g, h, c, slot, s, b)
    assert torch.equal(hk.hist_f32(*args, bins=bins_T.t().contiguous()),
                       hk.hist_f32_plain(*args))


@pytest.mark.cuda
def test_hist_f32_cuda_tensor_never_falls_back(dev, monkeypatch):
    # a CUDA tensor launches the kernel (one count a call) and never
    # reaches the plain version
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    monkeypatch.setattr(hk, "hist_f32_plain", boom)
    bins_T, g, h, c, slot = _f32_rows(dev, 5000, 7, 16, 3, grid=False)
    hk.reset_launches()
    bins = bins_T.t().contiguous()
    hk.hist_f32(bins_T, g, h, c, slot, 3, 16, bins)
    hk.hist_f32(bins_T, g, h, c, None, 1, 16)
    assert hk.LAUNCHES["hist_f32"] == 2
    with pytest.raises(ValueError):
        hk.hist_f32(bins_T, g, h, c, slot, 3, 300, bins)
    with pytest.raises(ValueError):      # the compaction needs bins
        hk.hist_f32(bins_T, g, h, c, slot, 3, 16)


@pytest.mark.cuda
def test_hist_q8_cuda_tensor_never_falls_back(dev, monkeypatch):
    # B5's twin of the test above: one count a call, never the plain version
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    monkeypatch.setattr(hk, "hist_q8_plain", boom)
    bins_T, gq, hq, cq, slot = _wide(dev, 3)
    hk.reset_launches()
    bins = bins_T.t().contiguous()
    hk.hist_q8(bins_T, gq, hq, cq, slot, 3, 256, bins)
    hk.hist_q8(bins_T, gq, None, cq, None, 1, 256)
    assert hk.LAUNCHES["hist_q8"] == 2
    with pytest.raises(ValueError):
        hk.hist_q8(bins_T, gq, hq, cq, slot, 3, 300, bins)
    with pytest.raises(ValueError):      # the compaction needs bins
        hk.hist_q8(bins_T, gq, hq, cq, slot, 3, 256)


def _edge_slots(dev, case, n, s):
    gen = torch.Generator(device=dev).manual_seed(n + s)

    def draw(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64)
    if case == "empty_slots":          # only slots 1 and 5 of 8 hold rows
        slot = torch.where(draw(0, 2) == 0, 1, 5)
    elif case == "one_slot":
        slot = torch.full((n,), s - 1, device=dev, dtype=torch.int64)
    elif case == "dropped":            # mostly -3..-1 and S..S+5
        slot = torch.where(draw(0, 10) == 0, draw(0, s), draw(-3, 0))
        slot = torch.where(draw(0, 2) == 0, slot, draw(s, s + 6))
    elif case == "lossguide10":        # slot 0 keeps 10 rows, 1 drops
        slot = torch.ones(n, device=dev, dtype=torch.int64)
        slot[torch.randperm(n, generator=gen, device=dev)[:10]] = 0
    else:                              # uniform over [-1, S + 3)
        slot = draw(-1, s + 3)
    return slot.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,f,s,b", [
    ("empty_slots", 20_000, 9, 8, 256), ("one_slot", 20_000, 9, 5, 256),
    ("dropped", 20_000, 9, 4, 64), ("ragged", 1024 * 37 + 13, 9, 6, 64),
    ("s255", 200_000, 28, 255, 256), ("b2", 20_000, 9, 7, 2),
    ("b64", 20_000, 9, 7, 64), ("b255", 20_000, 9, 7, 255),
    ("b256", 20_000, 9, 7, 256), ("groups", 50_000, 100, 5, 256),
    ("s7000", 50_000, 9, 7000, 64), ("lossguide10", 1_000_000, 28, 1, 256)])
def test_slot_hists_equal_plain_on_edge_cases(dev, case, n, f, s, b):
    # hist_q8 exact at 3 and 2 channels; hist_f32 counts exact, g and h
    # within 2^-15 of the cell's absolute mass; on empty slots, one slot,
    # slots -1 and >= S, N not a multiple of any range, S = 255, B in
    # {2, 64, 255, 256}, two feature groups (F = 100), more slots than the
    # compaction counts in shared memory (S = 7000) and a lossguide-like
    # pass keeping 10 rows; the root pass (no slot vector) on the first
    gen = torch.Generator(device=dev).manual_seed(b + f)
    bins_T = torch.randint(0, b, (f, n), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    bins = bins_T.t().contiguous()
    gq = torch.randint(-127, 128, (n,), generator=gen, device=dev,
                       dtype=torch.int64).to(torch.int8)
    hq = torch.randint(0, 128, (n,), generator=gen, device=dev,
                       dtype=torch.int64).to(torch.int8)
    cq = (torch.rand(n, generator=gen, device=dev) < 0.9).to(torch.int8)
    slot = _edge_slots(dev, case, n, s)
    c = cq.float()
    g = torch.randn(n, generator=gen, device=dev) * c
    h = torch.rand(n, generator=gen, device=dev) * c
    for sl in ((slot, None) if case == "empty_slots" else (slot,)):
        sv = s if sl is not None else 1
        for hq_ in (hq, None):
            args = (bins_T, gq, hq_, cq, sl, sv, b)
            assert torch.equal(hk.hist_q8(*args, bins=bins),
                               hk.hist_q8_plain(*args))
        args = (bins_T, g, h, c, sl, sv, b)
        got, ref = hk.hist_f32(*args, bins=bins), hk.hist_f32_plain(*args)
        mass = hk.hist_f32_plain(bins_T, g.abs(), h.abs(), c, sl, sv,
                                 b).double()
        assert got.shape == (sv, 3, f, b)
        assert torch.equal(got[:, 2], ref[:, 2])
        err = (got.double() - ref.double()).abs()[:, :2]
        assert bool((err <= 2.0 ** -15 * mass[:, :2]).all()), \
            float(err.max())
        if case == "lossguide10":
            assert int(got[0, 2].sum()) == int(c[slot == 0].sum()) * f


@pytest.mark.cuda
@pytest.mark.parametrize("max_bin", [63, 255])
@pytest.mark.parametrize("extra", [{"use_quantized_grad": "false"},
                                   {"grow_policy": "lossguide"}])
def test_gpu_unquantized_first_tree_equals_cpu(dev, extra, max_bin):
    # exact-sum data (labels on a 1/8 grid in [0, 4), no init score: the
    # first tree's gradients are -label and h = 1): the first tree trained
    # on the card equals the CPU-trained one bit for bit
    rng = np.random.RandomState(2)
    X = rng.rand(4000, 9).astype(np.float32)
    y = np.clip(np.floor((X[:, 0] * 2 + rng.rand(4000)) * 8) / 8, 0,
                3.875).astype(np.float32)
    params = {"objective": "regression", "num_leaves": 31,
              "max_bin": max_bin, "min_data_in_leaf": 20, "verbosity": -1,
              "boost_from_average": False, **extra}
    hk.reset_launches()
    gpu = lt.train(params, lt.Dataset(X, label=y, params=params), 1)
    assert hk.LAUNCHES["hist_f32"] > 1
    assert max(hk.LAUNCHES[k] for k in FUSED + ("hist_q8", "leaf_sums")) == 0
    cpu_p = dict(params, device_type="cpu")
    cpu = lt.train(cpu_p, lt.Dataset(X, label=y, params=cpu_p), 1)
    (a,), (b,) = gpu._host_trees(), cpu._host_trees()
    assert a.num_leaves == b.num_leaves > 4
    for name in STRUCT + ("leaf_value", "leaf_weight", "leaf_count"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
