"""On the card: each hand-written CUDA kernel of lightgbm_tpu_torch against
its plain PyTorch version, and a small training run on the GPU against the
same run on the CPU.

Every test needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips with a
reason elsewhere: a CUDA kernel has no CPU mode. This file imports neither
JAX nor the reference package, so it runs on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: exact for the quantized front (also on N % 4 != 0 rows, on
views that start on neither 16 bytes nor a word, with every row kept in
one bin at |gq| = |hq| = 127 and a block's whole budget of rows, and with
an all-zero bag), the level passes (fused, and route then slot histogram
given route_level's per-slot counts or not; the fused one and the
routing also at a first level, a skewed level, a level that keeps no row,
and with route tables and slot counts too large for shared memory), the
root slot histogram and take_small (on N % 4 != 0 rows and on views that
do not start on 16 bytes too; integer sums, order-free); leaf sums within 1e-6 relative (both sum the
same f32 rows in f64, in different orders), on uniform, skewed and
out-of-range leaf ids, N % 4 != 0 rows, views off 16 bytes, L = 1, 255,
1000 (fewer warps a block) and 9000 (global tables), their counts
exactly, and two calls bit for bit wherever the warp tables run; the first tree of an
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
the same tolerance. Counts handed to hist_q8 that are not its slot
vector's own stop it with a device-side assert.
"""
import os
import subprocess
import sys
import textwrap

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


def _front_case(dev, case, n, spec, const_hess):
    """grad_quant_hist0's arguments for n rows at B = 64 on 28 features:
    random rows; every row in bin 0 of every feature, kept, at the fields'
    worst case (score 0: logloss g = 0.5, h = 0.25 with label 0, L2 g = 1
    with label -1, so gq = hq = 127); or an all-zero bag."""
    gen = torch.Generator(device=dev).manual_seed(n)
    bins_T = torch.randint(0, 64, (28, n), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    score = torch.randn(n, generator=gen, device=dev)
    if spec[0] == "l2":
        aux = torch.randn(n, generator=gen, device=dev)
    else:
        aux = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    bag = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
    if case == "one_bin":
        bins_T.zero_()
        score.zero_()
        aux.fill_(-1.0 if spec[0] == "l2" else 0.0)
        bag.fill_(1.0)
    elif case == "zero_bag":
        bag.zero_()
    return [bins_T, score, aux, bag, 5, spec, 64, const_hess]


@pytest.mark.cuda
@pytest.mark.parametrize("case,n", [
    ("random", 1_000_000), ("random", 1_000_003), ("random", 3),
    ("views", 1_000_002), ("one_bin", 1_000_001), ("one_bin", 3 * 2 ** 15 + 5),
    ("zero_bag", 100_001)])
@pytest.mark.parametrize("spec,const_hess", [(("l2",), True),
                                             (LOGLOSS, False)])
def test_grad_quant_hist0_kernel_on_tails_views_and_one_bin(
        dev, monkeypatch, case, n, spec, const_hess):
    # exact (gq, hq, cq, scales, hist): N % 4 in {0, 1, 2, 3}; score, aux,
    # bag and bins_T as views one to three elements into their storage (not
    # on 16 bytes or on a word: the byte paths); every row kept in bin 0 at
    # |gq| = |hq| = 127, so that each block step fills one packed cell with
    # its whole GQ_STEP_ROWS rows (the count field's wrap), once with one
    # block over all rows (grad_quant_plan replaced); an all-zero bag (no
    # row kept, scales at their floors)
    if case == "one_bin" and n < 2 ** 20:
        monkeypatch.setattr(hk, "grad_quant_plan", lambda n_, sms: (
            hk.GradQuantPlan(8, 1, -(-n_ // 4))))
    if case == "views":
        args = _front_case(dev, "random", n + 3, spec, const_hess)
        args[1:4] = args[1][1:1 + n], args[2][3:3 + n], args[3][2:2 + n]
        flat = torch.empty(28 * n + 3, dtype=torch.uint8, device=dev)
        flat[3:].copy_(args[0][:, :n].reshape(-1))
        args[0] = flat[3:].view(28, n)
    else:
        args = _front_case(dev, case, n, spec, const_hess)
    got = hk.grad_quant_hist0(*args)
    for name, a, b in zip(("gq", "hq", "cq", "scales", "hist"), got,
                          hk.grad_quant_hist0_plain(*args)):
        assert (a is None and b is None) or torch.equal(a, b), name
    if case == "one_bin":
        assert int(got[0].min()) == 127 and int(got[4][0, 0, 0]) == 127 * n
    if case == "zero_bag":
        assert not got[4].any() and not got[2].any()


@pytest.mark.cuda
def test_grad_quant_hist0_cuda_tensor_never_falls_back(dev, monkeypatch):
    # one count a call, never the plain version; a root table over the
    # kernel's shared memory is refused
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    monkeypatch.setattr(hk, "grad_quant_hist0_plain", boom)
    args = _front_case(dev, "random", 5003, LOGLOSS, False)
    hk.reset_launches()
    hk.grad_quant_hist0(*args)
    assert hk.LAUNCHES["grad_quant_hist0"] == 1
    args[6] = 256
    with pytest.raises(ValueError):
        hk.grad_quant_hist0(*args)
    assert hk.LAUNCHES["grad_quant_hist0"] == 1


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
    for a, b in zip(hk.hist_routed_fused(
            *args, bins=rows["bins_T"].t().contiguous()),
                    hk.hist_routed_fused_plain(*args)):
        assert torch.equal(a, b)


def _level(dev, case, n, f, l, s, b=64):
    """bins over [0, B) with NA bins, int8 channels, leaf ids and [6, L]
    route tables of a level: a first level (every row in leaf 0, which
    splits; S = 1), a skewed level (S = 127, leaf ids in [0, 2S), three rows
    in five in leaf 0 with its left child kept), a level where no leaf
    splits, or any other S with leaves < S splitting."""
    gen = torch.Generator(device=dev).manual_seed(n + s + l)

    def draw(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device=dev,
                             dtype=torch.int64)
    bins_T = torch.stack([draw(0, b, n) for _ in range(f)]).to(torch.uint8)
    gq = draw(-127, 128, n).to(torch.int8)
    hq = draw(0, 128, n).to(torch.int8)
    cq = (torch.rand(n, generator=gen, device=dev) < 0.9).to(torch.int8)
    k = torch.arange(l, device=dev)
    split = k < (1 if case == "first_level" else
                 0 if case == "no_split" else s)
    small_left = (torch.rand(l, generator=gen, device=dev) < 0.5) | (k == 0)
    lid = draw(0, max(1, min(l, 2 * s)), n)
    if case == "first_level":
        lid = torch.zeros_like(lid)
    elif case == "skewed":
        lid = torch.where(torch.rand(n, generator=gen, device=dev) < 0.6, 0,
                          lid)
    tab = torch.stack([
        torch.where(split, draw(0, f, l), -1), draw(0, b - 2, l),
        draw(0, 2, l),
        l + k, torch.where(split & small_left, k, s),
        torch.where(split & ~small_left, k, s)]).to(torch.int32).contiguous()
    na_bin = torch.full((f,), 256, dtype=torch.int32, device=dev)
    na_bin[: f // 3] = b - 2
    return bins_T, gq, hq, cq, lid.to(torch.int32), tab, na_bin


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,f,l,s", [
    ("first_level", 200_000, 28, 255, 1), ("skewed", 200_000, 28, 255, 127),
    ("no_split", 200_000, 28, 255, 32), ("ragged", 1024 * 37 + 13, 9, 15, 7),
    ("tables_in_global", 200_000, 9, 10_000, 4000),
    ("counts_in_global", 100_000, 7, 30_000, 13_000)])
def test_hist_routed_fused_level_shapes_equal_plain(dev, case, n, f, l, s):
    # exact, 3 and 2 channels: a first level (S = 1: no scan), a skewed
    # S = 127, a level that keeps no row, ragged N, route tables too large
    # for shared memory (6 x 10,000 ints) and more slots than the count
    # keeps in shared memory (13,000); the last two at B = 16
    b = 16 if l > 255 else 64
    bins_T, gq, hq, cq, lid, tab, na_bin = _level(dev, case, n, f, l, s, b)
    bins = bins_T.t().contiguous()
    for hq_ in (hq, None):
        args = (bins_T, gq, hq_, cq, lid, tab, na_bin, s, b)
        kh, kl = hk.hist_routed_fused(*args, bins=bins)
        ph_, pl_ = hk.hist_routed_fused_plain(*args)
        assert torch.equal(kh, ph_) and torch.equal(kl, pl_)
        if case == "no_split":
            assert not kh.any() and torch.equal(kl, lid)
        else:
            assert kh.any()


@pytest.mark.cuda
def test_hist_routed_fused_needs_bins_and_never_falls_back(dev, monkeypatch):
    # one count a call, never the plain version; without the row-major bins
    # the card refuses the call
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    monkeypatch.setattr(hk, "hist_routed_fused_plain", boom)
    bins_T, gq, hq, cq, lid, tab, na_bin = _level(dev, "skewed", 5000, 7,
                                                  15, 5)
    args = (bins_T, gq, hq, cq, lid, tab, na_bin, 5, 64)
    hk.reset_launches()
    hk.hist_routed_fused(*args, bins=bins_T.t().contiguous())
    assert hk.LAUNCHES["hist_routed_fused"] == 1
    with pytest.raises(ValueError):
        hk.hist_routed_fused(*args)
    assert hk.LAUNCHES["hist_routed_fused"] == 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("l", [0, 8, 255, 5000])
def test_take_small_kernel_on_tails_and_views(dev, l):
    # exact: N % 4 in {0, 1, 2, 3}, idx views starting 1-3 elements into
    # their storage (not on 16 bytes: the scalar path), tables in shared
    # memory and, at L = 5000 (over 16 KB), in global memory
    gen = torch.Generator(device=dev).manual_seed(l)
    table = torch.randn(l, generator=gen, device=dev)
    base = torch.randint(-3, l + 4, (1_000_005,), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    for n in (1_000_000, 1_000_001, 1_000_002, 1, 0):
        for offset in range(4 if n else 1):
            idx = base[offset:offset + n]
            got = hk.take_small(table, idx)
            assert got.shape == (n,)
            assert torch.equal(got, hk.take_small_plain(table, idx))


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
@pytest.mark.parametrize("case,n,f,l,s", [
    ("first_level", 200_000, 28, 255, 1), ("skewed", 200_000, 28, 255, 127),
    ("no_split", 200_000, 28, 255, 32), ("ragged", 1024 * 37 + 13, 9, 15, 7),
    ("tables_in_global", 200_000, 9, 10_000, 4000),
    ("counts_in_global", 100_000, 7, 30_000, 13_000)])
def test_route_level_counts_feed_the_slot_hists(dev, case, n, f, l, s):
    # exact: route_level's slot, lid2 and counts equal route_plain's, and
    # the counts the bincount of its kept slots; hist_q8 (3 and 2
    # channels) and hist_f32 (rows on a 1/16 grid) handed the counts equal
    # the calls without them and the plain versions (on the fused level
    # pass's level shapes, with tables and counts too large for shared
    # memory)
    b = 16 if l > 255 else 64
    bins_T, gq, hq, cq, lid, tab, na_bin = _level(dev, case, n, f, l, s, b)
    bins = bins_T.t().contiguous()
    slot, lid2, counts = hk.route_level(bins_T, lid, tab, na_bin, s)
    for a, b_ in zip((slot, lid2, counts),
                     hk.route_plain(bins_T, lid, tab, na_bin, s)):
        assert torch.equal(a, b_)
    kept = slot[(slot >= 0) & (slot < s)].long()
    assert torch.equal(counts, torch.bincount(kept, minlength=s).int())
    for hq_ in (hq, None):
        args = (bins_T, gq, hq_, cq, slot, s, b)
        got = hk.hist_q8(*args, bins=bins, counts=counts)
        assert torch.equal(got, hk.hist_q8(*args, bins=bins))
        assert torch.equal(got, hk.hist_q8_plain(*args))
    # f32 rows on a 1/16 grid: every partial sum is exact in f32
    c = cq.float()
    args = (bins_T, gq.float() / 16 * c, hq.float().abs() / 16 * c, c, slot,
            s, b)
    got = hk.hist_f32(*args, bins=bins, counts=counts)
    assert torch.equal(got, hk.hist_f32(*args, bins=bins))
    assert torch.equal(got, hk.hist_f32_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["moved", "over", "negative"])
def test_slot_hist_asserts_on_counts_of_another_slot_vector(dev, fault):
    # counts that are not the slot vector's own (a row counted in another
    # slot, one row too many, a negative count) stop hist_q8 with a
    # device-side assert, after the slot vector's own counts have passed;
    # the assert ends the process's CUDA context, so each runs in a process
    # of its own
    code = textwrap.dedent(f"""
        import torch
        from lightgbm_tpu_torch.ops import hist_kernels as hk
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(3)
        n, f, s = 5000, 9, 5
        def ri(lo, hi, dt):
            return torch.randint(lo, hi, (n,), generator=g, device=dev,
                                 dtype=torch.int64).to(dt)
        bins_T = torch.randint(0, 256, (f, n), generator=g, device=dev,
                               dtype=torch.int64).to(torch.uint8)
        slot = ri(-1, s + 3, torch.int32)
        args = (bins_T, ri(-127, 128, torch.int8), ri(0, 128, torch.int8),
                ri(0, 2, torch.int8), slot, s, 256)
        bins = bins_T.t().contiguous()
        counts = torch.bincount(slot[(slot >= 0) & (slot < s)].long(),
                                minlength=s).int()
        assert torch.equal(hk.hist_q8(*args, bins=bins, counts=counts),
                           hk.hist_q8_plain(*args))
        torch.cuda.synchronize()
        print("own counts exact", flush=True)
        bad, full = counts.clone(), int(counts.argmax())
        if "{fault}" == "moved":
            bad[full] -= 1
            bad[(full + 1) % s] += 1
        elif "{fault}" == "over":
            bad[full] += 1
        else:
            bad[full] = -1
        hk.hist_q8(*args, bins=bins, counts=bad)
        torch.cuda.synchronize()
        print("no assert", flush=True)
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert "own counts exact" in run.stdout, run.stderr[-2000:]
    assert run.returncode != 0 and "no assert" not in run.stdout
    assert "device-side assert" in run.stderr, run.stderr[-2000:]


@pytest.mark.cuda
def test_route_level_cuda_tensor_never_falls_back(dev, monkeypatch):
    # one count a call, never the plain version
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    monkeypatch.setattr(hk, "route_plain", boom)
    bins_T, _, _, _, lid, tab, na_bin = _level(dev, "skewed", 5000, 7, 15, 5)
    hk.reset_launches()
    slot, lid2, counts = hk.route_level(bins_T, lid, tab, na_bin, 5)
    assert hk.LAUNCHES["route_level"] == 1 and counts.is_cuda
    with pytest.raises(ValueError):
        hk.route_level(bins_T, lid, tab, na_bin, 0)
    assert hk.LAUNCHES["route_level"] == 1


@pytest.mark.cuda
def test_leaf_sums_kernel_equals_plain(rows, dev):
    g, h = hk.grad_rows(LOGLOSS, rows["score"], rows["label_pos"])
    args = (g * rows["bag"], h * rows["bag"], (rows["bag"] > 0).float(),
            rows["lid"], L)
    got = hk.leaf_sums(*args)
    ref = hk.leaf_sums_plain(*args)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[2], ref[2])


def _leaf_case(dev, kernel, leaves, l, n):
    """Inputs of one leaf-sum kernel, leaf ids uniform over [0, L), skewed
    (leaf k with probability proportional to 1 / (k + 1)) or "dropped"
    (uniform over [-3, L + 3)), and the [3, N] rows it sums."""
    gen = torch.Generator(device=dev).manual_seed(l + n)
    score = torch.randn(n, generator=gen, device=dev) * 0.5
    label = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    bag = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
    bag[: n // 8] = 0.0                     # a run of rows out of the bag
    if leaves == "skewed":
        w = 1.0 / torch.arange(1, l + 1, dtype=torch.float64, device=dev)
        lid = torch.multinomial(w, n, replacement=True, generator=gen)
    else:
        lo, hi = (0, l) if leaves == "uniform" else (-3, l + 3)
        lid = torch.randint(lo, hi, (n,), generator=gen, device=dev)
    lid = lid.to(torch.int32)
    g, h = hk.grad_rows(LOGLOSS, score, label)
    ghc = torch.stack([g * bag, h * bag, (bag > 0).float()])
    if kernel == "leaf_sums_grad":
        return (score, label, bag, lid, LOGLOSS, l), ghc, lid
    return (ghc[0].contiguous(), ghc[1].contiguous(), ghc[2].contiguous(),
            lid, l), ghc, lid


def _assert_leaf_sums(got, ref, ghc, lid, l):
    """Counts exactly; g and h within 1e-6 of the leaf's row mass (both sum
    the same f32 rows in f64, in different orders)."""
    ok = (lid >= 0) & (lid < l)
    mass = torch.zeros(3, l, dtype=torch.float64, device=lid.device)
    mass.index_add_(1, lid[ok].long(), ghc[:, ok].abs().double())
    assert torch.equal(got[2], ref[2])
    err = (got.double() - ref.double()).abs()
    assert bool((err <= 1e-6 * mass).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["leaf_sums_grad", "leaf_sums"])
@pytest.mark.parametrize("leaves", ["uniform", "skewed", "dropped"])
@pytest.mark.parametrize("l", [1, 255, 1000, 9000])
def test_leaf_sums_kernels_on_leaves_tails_and_views(dev, kernel, leaves, l):
    # N % 4 in {0, 1, 2, 3}, and views one element into their storage (not
    # on 16 bytes: scalar loads); L = 1000 takes 8 warps a block, L = 9000
    # global tables (past the shared-memory budget). Two calls give the
    # same bits wherever the warp tables run.
    fn, plain = getattr(hk, kernel), getattr(hk, f"{kernel}_plain")
    args, ghc, lid = _leaf_case(dev, kernel, leaves, l, 200_005)
    warps = hk.leaf_sums_plan(200_000, l, hk._num_sms(dev)).warps
    assert warps == {1: 16, 255: 16, 1000: 8, 9000: 0}[l]
    for n in (200_000, 200_001, 200_002, 200_003):
        for offset in (0, 1):
            sl = slice(offset, offset + n)      # three row vectors, lid
            a = tuple(x[sl] for x in args[:4]) + args[4:]
            got = fn(*a)
            assert got.shape == (3, l) and got.dtype == torch.float32
            _assert_leaf_sums(got, plain(*a), ghc[:, sl], lid[sl], l)
            if warps:
                again = fn(*a)
                assert torch.equal(got.view(torch.int32),
                                   again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["leaf_sums_grad", "leaf_sums"])
def test_leaf_sums_kernels_never_fall_back(dev, kernel, monkeypatch):
    # one count a call, two CUDA launches and no plain version
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    args, _, _ = _leaf_case(dev, kernel, "skewed", 255, 10_001)
    monkeypatch.setattr(hk, f"{kernel}_plain", boom)
    hk.reset_launches()
    out = getattr(hk, kernel)(*args)
    assert out.is_cuda and hk.LAUNCHES[kernel] == 1
    assert sum(hk.LAUNCHES.values()) == 1


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
