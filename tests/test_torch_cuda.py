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
vector's own stop it with a device-side assert. Sampling: the threefry
replica's uniforms on the card equal its CPU draws bit for bit; with
bagging, feature_fraction and feature_fraction_bynode on the fused,
unfused, f32 and lossguide paths, and with GOSS, the card's bag and
feature masks equal the CPU run's and its first tree has the CPU tree's
structure and leaf values within 1e-6 of the largest; an early-stopped run
stops at the same iteration with the same best_iteration on both.
Objectives: each objective's gradients, hessians, init score and converted
output on CUDA tensors equal the CPU's (exact without ``exp``, else within
1e-6 of the largest magnitude); the L1-family leaf renewal at 10.5M rows and
255 skewed leaves equals the CPU's bit for bit; a K = 3 multiclass model's
first three trees have the CPU's structure (leaf values within 1e-6 of the
largest) and it predicts [N, 3] probabilities; with row weights the first
tree of every grower has the CPU's structure (unquantized: bit for bit on
exact-sum data; quantized: leaf values within 1e-6 of the largest).
The multi-level replay (hist_routed_fused_multi) equals its plain version
and D sequential hist_routed_fused launches exactly: a tree's first levels
with their own slot widths, wide levels, one level, eight levels on ragged
N, categorical levels beside numerical ones, route tables too large for
shared memory and more slots than its count keeps there.
Categorical features: hist_routed_fused and route_level with categorical
leaves (an is_cat row and membership bitsets) equal their plain versions
exactly, at F = 8, B = 256 and with tables too large for shared memory;
the first tree of a categorical model on exact-sum labels trained on the
card has the CPU tree's structure and categories (leaf values as with
weights). EFB bundles: route_level with bundle leaves (a member's range
plus the bins outside it in the bitset) and hist_q8 handed its slots and
counts equal their plain versions exactly at F = 16, B = 256; a bundled
model's first tree trained on the card from a CSR matrix and from the
dense array has the CPU tree's structure (leaf values as with weights).
Split constraints: three 4000-row trees under monotone constraints,
feature_contri and extra_trees (fused front), forced splits and bins with
CEGB (unfused front) and monotone constraints, extra_trees and forced
splits on lossguide have the CPU trees' structure (leaf values as with
weights, bit for bit on lossguide's exact-sum labels). histogram_pool_size:
hist_q8 and hist_f32 on a feature tile of the whole row-major bins (a
column offset, aligned or not) equal their plain versions on the tile
(hist_q8 exactly, hist_f32 as above); the lean grower, quantized and not,
and the pooled leaf-wise grower train the CPU's trees (as with weights;
the unquantized first tree bit for bit, later ones within 2^-17).
Cold start and serving: the chunked ingest pipeline on the card (pinned
staging buffers, a copy stream, events) gives the bins of its plain
version (the column-at-a-time encode) and of the CPU pipeline byte for
byte, with chunks that reuse each staging buffer several times, and
after a device_put_oom halving; the prewarm
loads the library and warms the fused path's kernels with its launches
counted apart; the serving engine's walk on the card gives the CPU walk's
leaf indices and scores bit for bit, and a steady-state loop of flushes
through a PredictServer adds no allocator retry
(``torch.cuda.memory_stats()["num_alloc_retries"]``). Continuous learning:
Dataset.append on the card (chunks through the ingest pipeline, a FIFO
window, NaN and out-of-range values) gives the bins of a reference=
construct of the same rows and of the CPU's append byte for byte, labels
and weights on the card beside them; an online boost cycle on the card
launches the fused front (B1-B4, B4 for the init model's replay too) and
its merged model equals the offline append + train(init_model=) + merge
byte for byte. The mesh (parallel/): the shard sum on virtual copies of
the card is the sequential f32 sum bit for bit, on a 2-D mesh too; each
shard's fused front quantizes with its own scale and its local rows'
dither, as the CPU does; (t1) of chip_smoke.py at 100,000 rows, 4 virtual
shards of the card byte for byte the serial card run, each kernel
launched once a shard. Across processes: the gloo transport stages a
card's payloads through the host (counted), and two rank processes on
the card train (t1)'s lattice model byte for byte the one-process run
on the same 4-shard grid.
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

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

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


def _replay(dev, n, f, l, widths, b, cat_levels, seed):
    """bins over [0, B), int8 channels, leaf ids over [0, min(L, 2 S_0))
    and one route table a level of a replay: at level d the leaves < S_d
    split on random features (one child of each kept, the other in the
    dropped slot S_d), their right children take leaf ids inside [0, L), so
    that rows go on being routed; the levels in ``cat_levels`` carry an
    is_cat row and membership bitsets (_cat_tables)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device=dev,
                             dtype=torch.int64)
    bins_T = torch.stack([draw(0, b, n) for _ in range(f)]).to(torch.uint8)
    gq = draw(-127, 128, n).to(torch.int8)
    hq = draw(0, 128, n).to(torch.int8)
    cq = (torch.rand(n, generator=gen, device=dev) < 0.9).to(torch.int8)
    lid = draw(0, max(1, min(l, 2 * widths[0])), n).to(torch.int32)
    na_bin = torch.full((f,), 256, dtype=torch.int32, device=dev)
    na_bin[: f // 3] = b - 2
    k = torch.arange(l, device=dev)
    tables, bits = [], []
    for d, s in enumerate(widths):
        split = k < s
        small_left = torch.rand(l, generator=gen, device=dev) < 0.5
        tab = torch.stack([
            torch.where(split, draw(0, f, l), -1), draw(0, b - 2, l),
            draw(0, 2, l), (k + s) % l,
            torch.where(split & small_left, k, s),
            torch.where(split & ~small_left, k, s)]).to(
                torch.int32).contiguous()
        if d in cat_levels:
            tab, bitset, _ = _cat_tables(dev, tab, l, b, seed + d)
            bits.append(bitset)
        else:
            bits.append(None)
        tables.append(tab)
    return bins_T, gq, hq, cq, lid, tables, bits, na_bin


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,f,l,widths,b,cat", [
    ("tree_start", 200_000, 28, 255, (1, 2, 4), 64, ()),
    ("wide", 200_000, 28, 255, (32, 127, 127), 64, ()),
    ("one_level", 200_000, 28, 255, (127,), 64, ()),
    ("eight_levels", 1024 * 37 + 13, 9, 255, (3, 5, 7, 9, 11, 13, 15, 17),
     64, ()),
    ("categorical", 200_000, 8, 255, (32, 32, 64), 256, (1,)),
    ("all_categorical", 100_000, 8, 255, (1, 2), 256, (0, 1)),
    ("tables_in_global", 100_000, 9, 10_000, (4000, 4000), 16, ()),
    ("counts_in_global", 100_000, 7, 30_000, (13_000, 7000), 16, ())])
def test_hist_routed_fused_multi_kernel_equals_plain(dev, case, n, f, l,
                                                     widths, b, cat):
    # exact, 3 and 2 channels: the D-level replay against its plain
    # version and against D sequential hist_routed_fused launches: a tree's
    # first levels with their own slot widths, wide levels, one level, the
    # most levels a call takes on ragged N, categorical levels beside
    # numerical ones (zero is_cat rows and bitsets for the latter), route
    # tables too large for shared memory, and more slots than the count
    # keeps there
    bins_T, gq, hq, cq, lid, tables, bits, na_bin = _replay(
        dev, n, f, l, list(widths), b, cat, n + l)
    bins = bins_T.t().contiguous()
    for hq_ in (hq, None):
        args = (bins_T, gq, hq_, cq, lid, tables, na_bin, list(widths), b)
        kh, kl = hk.hist_routed_fused_multi(*args, bins=bins, catbits=bits)
        ph_, pl_ = hk.hist_routed_fused_multi_plain(*args, catbits=bits)
        assert torch.equal(kh, ph_) and torch.equal(kl, pl_)
        assert kh.shape == (len(widths), max(widths), 2 if hq_ is None
                            else 3, f, b)
        seq = lid
        for d, (t, c) in enumerate(zip(tables, bits)):
            h, seq = hk.hist_routed_fused(bins_T, gq, hq_, cq, seq, t,
                                          na_bin, widths[d], b, bins=bins,
                                          catbits=c)
            assert torch.equal(kh[d, :widths[d]], h), d
            assert not kh[d, widths[d]:].any()
            assert h.any() or case == "tables_in_global"
        assert torch.equal(kl, seq)


@pytest.mark.cuda
def test_hist_routed_fused_multi_needs_bins_and_never_falls_back(
        dev, monkeypatch):
    # one count a call, never the plain version; without the row-major bins
    # the card refuses the call
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")
    monkeypatch.setattr(hk, "hist_routed_fused_multi_plain", boom)
    bins_T, gq, hq, cq, lid, tables, _, na_bin = _replay(
        dev, 5000, 7, 15, [2, 4, 5], 64, (), 3)
    args = (bins_T, gq, hq, cq, lid, tables, na_bin, [2, 4, 5], 64)
    hk.reset_launches()
    hk.hist_routed_fused_multi(*args, bins=bins_T.t().contiguous())
    assert hk.LAUNCHES["hist_routed_fused_multi"] == 1
    assert hk.LAUNCHES["hist_routed_fused"] == 0
    with pytest.raises(ValueError):
        hk.hist_routed_fused_multi(*args)
    assert hk.LAUNCHES["hist_routed_fused_multi"] == 1


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
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lo,hi", [((100_003,), 0.0, 1.0),
                                         ((255, 28), 0.0, 1.0),
                                         ((65_537,), -2.0, 3.5)])
def test_threefry_uniform_card_equals_cpu(dev, shape, lo, hi):
    # exact: the replica's draws are integer ops and one rounding
    from lightgbm_tpu_torch.utils import threefry
    for key in (threefry.prng_key(0), threefry.fold_in(threefry.prng_key(7),
                                                       3)):
        a = threefry.uniform(key, shape, dev, lo, hi)
        b = threefry.uniform(key, shape, "cpu", lo, hi)
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


SAMPLED = {"bagging_fraction": 0.7, "bagging_freq": 1,
           "feature_fraction": 0.7, "feature_fraction_bynode": 0.7}


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {"max_bin": 31, **SAMPLED},
    {"max_bin": 255, **SAMPLED},
    {"max_bin": 255, "boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
    {"max_bin": 31, "boosting": "goss"},
    {"max_bin": 255, "use_quantized_grad": "false", **SAMPLED},
    {"max_bin": 255, "grow_policy": "lossguide", **SAMPLED}])
def test_gpu_sampled_training_matches_cpu(dev, extra):
    # the bag and feature masks equal, the first tree's structure equal,
    # leaf values within 1e-6 of the largest leaf (exact-sum labels, no
    # init score: a leaf's gradients are -label times its row weight)
    rng = np.random.RandomState(2)
    X = rng.rand(4000, 9).astype(np.float32)
    y = np.clip(np.floor((X[:, 0] * 2 + rng.rand(4000)) * 8) / 8, 0,
                3.875).astype(np.float32)
    params = {"objective": "regression", "num_leaves": 31,
              "min_data_in_leaf": 20, "verbosity": -1,
              "boost_from_average": False, **extra}
    gpu = lt.train(params, lt.Dataset(X, label=y, params=params), 1)
    cpu_p = dict(params, device_type="cpu")
    cpu = lt.train(cpu_p, lt.Dataset(X, label=y, params=cpu_p), 1)
    assert torch.equal(gpu._gbdt._bag.cpu(), cpu._gbdt._bag)
    assert torch.equal(gpu._gbdt._fmask.cpu(), cpu._gbdt._fmask)
    (a,), (b,) = gpu._host_trees(), cpu._host_trees()
    assert a.num_leaves == b.num_leaves > 4
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                               atol=1e-6 * np.abs(b.leaf_value).max())


@pytest.mark.cuda
def test_gpu_early_stopping_matches_cpu(dev):
    # a valid label the model moves away from (the negated target): both
    # devices stop at the same iteration with the same best_iteration
    rng = np.random.RandomState(3)
    X = rng.rand(3000, 6).astype(np.float32)
    y = (X[:, 0] * 2 + rng.rand(3000)).astype(np.float32)
    out = []
    for kw in ({}, {"device_type": "cpu"}):
        params = {"objective": "regression", "num_leaves": 15,
                  "max_bin": 63, "min_data_in_leaf": 10, "verbosity": -1,
                  "metric": "l2", **SAMPLED, **kw}
        ds = lt.Dataset(X, label=y, params=params)
        valid = lt.Dataset(X[:500], label=-y[:500], reference=ds)
        res = {}
        bst = lt.train(params, ds, num_boost_round=20, valid_sets=[valid],
                       evals_result=res, early_stopping_rounds=3,
                       verbose_eval=False)
        out.append((len(res["valid_0"]["l2"]), bst.best_iteration,
                    bst.num_trees()))
    assert out[0] == out[1] and out[0][0] < 20


# ---- objectives, leaf renewal and K trees an iteration on the card ----

OBJECTIVES = ["regression", "regression_l1", "huber", "fair", "poisson",
              "quantile", "mape", "gamma", "tweedie", "binary",
              "cross_entropy", "cross_entropy_lambda", "multiclass",
              "multiclassova"]
NO_EXP = {"regression", "regression_l1", "huber", "fair", "quantile",
          "mape"}


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_objective_gradients_on_the_card_equal_cpu(dev, name, weighted):
    # exact without exp; through exp within 1e-6 of the largest magnitude
    # (CUDA's expf and the CPU's may differ by an ulp), 1e-5 for
    # cross_entropy_lambda
    from lightgbm_tpu_torch import config as t_config
    from lightgbm_tpu_torch import objectives as t_obj
    rng = np.random.RandomState(4)
    n, k = 100_003, (3 if name.startswith("multiclass") else 1)
    if name == "binary" or k > 1:
        y = rng.randint(0, max(k, 2), n).astype(np.float32)
    elif name.startswith("cross_entropy"):
        y = (rng.randint(0, 5, n) / 4).astype(np.float32)
    else:
        y = (rng.randint(1, 40, n) / 8).astype(np.float32)
    w = (rng.rand(n) * 1.5 + 0.5).astype(np.float32) if weighted else None
    score = (rng.randn(*((n,) if k == 1 else (n, k))) * 0.8).astype(
        np.float32)
    out = []
    for d in (dev, torch.device("cpu")):
        obj = t_obj.create_objective(name, t_config.Config(
            {"objective": name, "num_class": k}))
        obj.init(torch.from_numpy(y).to(d),
                 None if w is None else torch.from_numpy(w).to(d))
        g, h = obj.get_gradients(torch.from_numpy(score).to(d))
        out.append((g.cpu().numpy(), h.cpu().numpy(), obj.boost_from_score(),
                    obj.convert_output(torch.from_numpy(score).to(d)).cpu()
                    .numpy()))
    # cross_entropy_lambda subtracts exp and log1p terms: measured 1.3e-6
    # of the largest on the card
    bound = 1e-5 if name == "cross_entropy_lambda" else 1e-6
    for a, b in zip(out[0][:2] + out[0][3:], out[1][:2] + out[1][3:]):
        if name in NO_EXP:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=bound * np.abs(b).max())
    assert out[0][2] == out[1][2]


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_leaf_percentile_on_the_card_equals_cpu_at_full_size(dev, weighted):
    # 10.5M rows, 255 leaves of skewed sizes (leaf k with probability
    # proportional to 1 / (k + 1)), ties in the f32 key: the stable sort
    # and the f64 cumulative weights give the CPU's pick bit for bit
    from lightgbm_tpu_torch.objectives import leaf_percentile
    n, l = 10_500_000, 255
    gen = torch.Generator(device=dev).manual_seed(5)
    r = torch.round(torch.randn(n, generator=gen, device=dev) * 64) / 64
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    p = 1.0 / torch.arange(1, l + 1, dtype=torch.float64, device=dev)
    lid = torch.searchsorted(torch.cumsum(p, 0) / p.sum(), u).clamp_(
        max=l - 1).to(torch.int32)
    w = (torch.rand(n, generator=gen, device=dev) * 1.5 + 0.5
         if weighted else None)
    for alpha in (0.5, 0.9):
        got = leaf_percentile(r, lid, l, alpha, w)
        want = leaf_percentile(r.cpu(), lid.cpu(), l, alpha,
                               None if w is None else w.cpu())
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
def test_multiclass_on_the_card_matches_cpu(dev):
    # K = 3: the first iteration's three trees have the CPU's structure,
    # leaf values within 1e-6 of the largest; predict gives [N, K]
    rng = np.random.RandomState(6)
    X = rng.rand(4000, 9).astype(np.float32)
    s = X[:, 0] + 0.6 * X[:, 1] + 0.5 * rng.rand(4000)
    y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float32)
    runs = []
    for kw in ({}, {"device_type": "cpu"}):
        params = {"objective": "multiclass", "num_class": 3,
                  "num_leaves": 31, "max_bin": 255, "min_data_in_leaf": 20,
                  "verbosity": -1, **kw}
        hk.reset_launches()
        runs.append(lt.train(params, lt.Dataset(X, label=y, params=params),
                             2))
        if not kw:
            assert hk.LAUNCHES["take_small"] == 6
            assert max(hk.LAUNCHES[k] for k in FUSED) == 0
    gpu, cpu = runs
    for a, b in zip(gpu._host_trees()[:3], cpu._host_trees()[:3]):
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-6 * np.abs(b.leaf_value).max())
    prob = gpu.predict(X)
    assert prob.shape == (4000, 3)
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(gpu.predict(X, num_iteration=1),
                               cpu.predict(X, num_iteration=1), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {"max_bin": 63}, {"max_bin": 255},
    {"max_bin": 255, "use_quantized_grad": "false"},
    {"max_bin": 255, "grow_policy": "lossguide"}])
def test_gpu_weighted_training_matches_cpu(dev, extra):
    # row weights on a 1/4 grid, labels on a 1/8 grid, no init score: the
    # first tree's gradients -label * weight sum exactly in any order, so
    # the unquantized growers' first tree equals the CPU's bit for bit and
    # the quantized ones' within 1e-6 of the largest leaf
    rng = np.random.RandomState(7)
    X = rng.rand(4000, 9).astype(np.float32)
    y = np.clip(np.floor((X[:, 0] * 2 + rng.rand(4000)) * 8) / 8, 0,
                3.875).astype(np.float32)
    w = (rng.randint(2, 9, 4000) / 4).astype(np.float32)
    runs = []
    for kw in ({}, {"device_type": "cpu"}):
        params = {"objective": "regression", "num_leaves": 31,
                  "min_data_in_leaf": 20, "verbosity": -1,
                  "boost_from_average": False, **extra, **kw}
        runs.append(lt.train(params, lt.Dataset(X, label=y, weight=w,
                                                params=params), 1))
    (a,), (b,) = runs[0]._host_trees(), runs[1]._host_trees()
    assert a.num_leaves == b.num_leaves > 4
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    if runs[0]._gbdt.gp.quant:
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-6 * np.abs(b.leaf_value).max())
    else:
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def _cat_tables(dev, tab, l, b, seed):
    """[7, L] tables (tab's six rows and an is_cat row: about half the
    splitting leaves categorical) and the membership bitset of each leaf
    ([L, ceil(B / 32)] words; random member bins, bin 0 and the top bin
    among them on some leaves, none on others)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    is_cat = ((torch.rand(l, generator=g, device=dev) < 0.5)
              & (tab[0] >= 0)).to(torch.int32)
    share = torch.rand((l, 1), generator=g, device=dev)
    member = torch.rand((l, b), generator=g, device=dev) < share
    member[::7] = False
    tab7 = torch.cat([tab, is_cat[None]]).contiguous()
    return tab7, hk.member_bitset(member), is_cat


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,f,l,s,b", [
    ("first_level", 200_000, 8, 255, 1, 256),
    ("level", 200_000, 8, 255, 32, 256),
    ("skewed", 200_000, 8, 255, 127, 256),
    ("ragged", 1024 * 37 + 13, 5, 15, 7, 64),
    ("tables_in_global", 200_000, 8, 10_000, 4000, 16)])
def test_categorical_membership_kernels_equal_plain(dev, case, n, f, l, s, b):
    # exact: hist_routed_fused (3 and 2 channels) and route_level route a
    # categorical leaf's rows by its bitset, at F = 8, B = 256 (the
    # airline shape: F * B = 2048, the fused pass's cap) and with tables
    # and bitsets too large for shared memory; a level with categorical
    # leaves routes otherwise than its tables read numerically
    bins_T, gq, hq, cq, lid, tab, na_bin = _level(dev, case, n, f, l, s, b)
    tab7, bits, is_cat = _cat_tables(dev, tab, l, b, n + l)
    if case == "first_level":
        tab7[6, 0] = 1
    bins = bins_T.t().contiguous()
    for hq_ in (hq, None):
        args = (bins_T, gq, hq_, cq, lid, tab7, na_bin, s, b)
        kh, kl = hk.hist_routed_fused(*args, bins=bins, catbits=bits)
        ph_, pl_ = hk.hist_routed_fused_plain(*args, catbits=bits)
        assert torch.equal(kh, ph_) and torch.equal(kl, pl_)
    args = (bins_T, lid, tab7, na_bin, s)
    routed = hk.route_level(*args, catbits=bits)
    for a, p in zip(routed, hk.route_plain(*args, catbits=bits)):
        assert torch.equal(a, p)
    numeric = hk.route_plain(bins_T, lid, tab, na_bin, s)
    assert not torch.equal(routed[1], numeric[1])


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{"use_quantized_grad": "true"},
                                   {"use_quantized_grad": "false"},
                                   {"grow_policy": "lossguide"}])
def test_gpu_categorical_first_tree_equals_cpu(dev, extra):
    # a 4000-row model with four categorical columns (one of 40
    # categories, a subset split) on exact-sum labels: the first tree
    # trained on the card has the CPU tree's structure and categories,
    # its leaf values bit for bit unquantized and within 1e-6 of the
    # largest quantized; the fused path launches its kernels
    rng = np.random.RandomState(3)
    X = rng.rand(4000, 6).astype(np.float32)
    for j, k in ((0, 12), (1, 40), (3, 3), (4, 7)):
        X[:, j] = rng.randint(0, k, 4000)
    eff = rng.normal(size=40)
    y = np.clip(np.floor((eff[X[:, 1].astype(int)] + X[:, 2] * 2
                          + rng.rand(4000)) * 8) / 8, -3, 3.875).astype(
                              np.float32)
    runs = []
    for kw in ({}, {"device_type": "cpu"}):
        params = {"objective": "regression", "num_leaves": 31,
                  "max_bin": 63, "min_data_in_leaf": 20, "verbosity": -1,
                  "boost_from_average": False, "cat_smooth": 5.0,
                  "min_data_per_group": 20, **extra, **kw}
        hk.reset_launches()
        runs.append(lt.train(params, lt.Dataset(
            X, label=y, categorical_feature=[0, 1, 3, 4], params=params), 1))
        if not kw and extra.get("use_quantized_grad") == "true":
            assert hk.LAUNCHES["hist_routed_fused"] > 0
    (a,), (b,) = runs[0]._host_trees(), runs[1]._host_trees()
    assert a.num_leaves == b.num_leaves > 4 and b.is_cat_node.any()
    for name in STRUCT + ("is_cat_node",):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for ca, cb in zip(a.cat_sets, b.cat_sets):
        np.testing.assert_array_equal(ca, cb)
    if runs[0]._gbdt.gp.quant:
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-6 * np.abs(b.leaf_value).max())
    else:
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def _bundle_level(dev, n, s, f=16, singles=6, b=256, seed=12):
    """A level at path (l)'s shape: six single columns (bins uniform) and
    ten bundle columns of 127 one-hot members (bin 0, every member at its
    default, on a third of the rows, else member k's position 2k + 2);
    route tables mixing numerical splits on the single columns with
    bundle splits (the is_cat row) whose bitsets send a member's first
    position and every bin outside its range left, or every bin outside
    it ("t == default")."""
    g = torch.Generator(device=dev).manual_seed(seed)
    l = 255

    def randint(hi, size):
        return torch.randint(0, hi, size, generator=g, device=dev,
                             dtype=torch.int64)

    def rand(size):
        return torch.rand(size, generator=g, device=dev)
    cols = []
    for j in range(f):
        if j < singles:
            cols.append(randint(b, (n,)))
        else:
            cols.append(torch.where(rand(n) < 1 / 3, 0, 2 * randint(127, (n,))
                                    + 2))
    bins_T = torch.stack(cols).to(torch.uint8).contiguous()
    lid = randint(min(l, 2 * s), (n,)).to(torch.int32)
    k = torch.arange(l, device=dev)
    split = k < s
    small_left = (rand(l) < 0.5) | (k == 0)
    feat = torch.where(split, randint(f, (l,)), -1)
    is_cat = split & (feat >= singles)
    off = 1 + 2 * randint(127, (l,))[:, None]
    iota = torch.arange(b, device=dev)[None, :]
    member = ((iota < off) | (iota > off + 1)
              | ((rand(l)[:, None] < 0.5) & (iota == off)))
    tab = torch.stack([feat, randint(b - 1, (l,)), torch.zeros_like(k),
                       s + k, torch.where(split & small_left, k, s),
                       torch.where(split & ~small_left, k, s),
                       is_cat]).to(torch.int32).contiguous()
    chans = (randint(255, (n,)).sub(127).to(torch.int8),
             randint(128, (n,)).to(torch.int8),
             (rand(n) < 0.9).to(torch.int8))
    na = torch.full((f,), 256, dtype=torch.int32, device=dev)
    return bins_T, lid, tab, hk.member_bitset(member), na, chans


@pytest.mark.cuda
@pytest.mark.parametrize("s", [32, 127])
def test_bundle_bitset_routing_and_counted_slot_hist_equal_plain(dev, s):
    # exact: route_level routes bundle leaves by their bitsets (a range
    # plus the bins outside it) at F = 16, B = 256 (path (l): F * B = 4096,
    # the unfused front), and hist_q8 handed route_level's slots and
    # counts equals hist_q8_plain on those slots (3 channels)
    bins_T, lid, tab, bits, na, (gq, hq, cq) = _bundle_level(dev, 200_000, s)
    args = (bins_T, lid, tab, na, s)
    slot, lid2, counts = hk.route_level(*args, catbits=bits)
    for a, p in zip((slot, lid2, counts), hk.route_plain(*args,
                                                         catbits=bits)):
        assert torch.equal(a, p)
    assert not torch.equal(lid2, hk.route_plain(bins_T, lid, tab[:6]
                                                .contiguous(), na, s)[1])
    hist_args = (bins_T, gq, hq, cq, slot, s, 256)
    assert torch.equal(hk.hist_q8(*hist_args, bins=bins_T.t().contiguous(),
                                  counts=counts),
                       hk.hist_q8_plain(*hist_args))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{"use_quantized_grad": "true"},
                                   {"use_quantized_grad": "false"},
                                   {"grow_policy": "lossguide"}])
def test_gpu_bundled_first_tree_equals_cpu(dev, extra):
    # 4000 rows of three one-hot blocks (40, 12 and 6 codes) beside two
    # numeric columns, which bundle, on exact-sum labels: the first tree
    # trained on the card from the CSR matrix and from the dense array
    # has the CPU tree's structure, its leaf values bit for bit
    # unquantized and within 1e-6 of the largest quantized
    import scipy.sparse as sps
    rng = np.random.RandomState(8)
    n, blocks = 4000, (40, 12, 6)
    X = np.zeros((n, 2 + sum(blocks)), np.float32)
    X[:, :2] = rng.rand(n, 2)
    lat = X[:, 0] * 2
    off = 2
    for k in blocks:
        code = rng.randint(0, k, n)
        X[np.arange(n), off + code] = 1.0
        lat += rng.normal(size=k)[code]
        off += k
    y = np.clip(np.floor(lat * 8) / 8, -4, 3.875).astype(np.float32)
    runs = []
    for data, kw in ((sps.csr_matrix(X), {}), (X, {}),
                     (sps.csr_matrix(X), {"device_type": "cpu"})):
        params = {"objective": "regression", "num_leaves": 31,
                  "max_bin": 63, "min_data_in_leaf": 20, "verbosity": -1,
                  "boost_from_average": False, **extra, **kw}
        runs.append(lt.train(params, lt.Dataset(data, label=y,
                                                params=params), 1))
    assert runs[0].train_set.bundle_meta is not None
    assert runs[0].model_to_string() == runs[1].model_to_string()
    (a,), (b,) = runs[0]._host_trees(), runs[2]._host_trees()
    assert a.num_leaves == b.num_leaves > 4
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    if runs[0]._gbdt.gp.quant:
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-6 * np.abs(b.leaf_value).max())
    else:
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def _constrained_params(tmp_path, path):
    """Path (m), (m') or (m'')'s settings on 28 columns: monotone
    constraints on 0-7 (the signs of the label's weights, the forced
    features 0 and 1 among them), feature_contri 0.5 on 11-27 and
    extra_trees; forced bins on 0 and 1, a forced root on 0 with its left
    child on 1, and CEGB (a split penalty, a coupled penalty blocking
    20-27 and a lazy one on 8-10)."""
    sign = [1, -1, 1, 1, -1, 1, -1, 1]
    forced = tmp_path / "forced.json"
    forced.write_text('{"feature": 0, "threshold": 0.0, "left": '
                      '{"feature": 1, "threshold": 0.0}}')
    bins = tmp_path / "bins.json"
    bins.write_text('[{"feature": 0, "bin_upper_bound": [-1, 0, 1]}, '
                    '{"feature": 1, "bin_upper_bound": [0]}]')
    mono = {"monotone_constraints": sign + [0] * 20,
            "feature_contri": [1.0] * 11 + [0.5] * 17, "extra_trees": True}
    if path == "m":
        return mono, {}
    if path == "m'":
        return {"forcedsplits_filename": str(forced),
                "cegb_penalty_split": 1e-4,
                "cegb_penalty_feature_coupled": [0.0] * 20 + [1e9] * 8,
                "cegb_penalty_feature_lazy": [0.0] * 8 + [0.0005] * 3
                + [0.0] * 17}, {"forcedbins_filename": str(bins)}
    return {"grow_policy": "lossguide", "extra_trees": True,
            "monotone_constraints": sign + [0] * 20,
            "forcedsplits_filename": str(forced)}, {}


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["m", "m'", "m''"])
def test_gpu_constrained_trees_equal_cpu(dev, path, tmp_path):
    # 4000 rows on exact-sum labels (a 1/8 grid, no init score): the three
    # trees trained on the card under the split constraints have the CPU
    # trees' structure, leaf values within 1e-6 of the largest; lossguide's
    # first tree bit for bit, its later ones within 2^-17 (off-grid
    # gradients summed by the f32 histogram's atomics in another order on
    # each launch; scripts/torch_constrained_parity.py reads this model's
    # spread and its one-row leaf changes); (m) takes the fused front, (m')
    # the unfused one
    rng = np.random.RandomState(21)
    X = rng.randn(4000, 28).astype(np.float32)
    w = np.array([0.8, -1.1, 0.5, 0.9, -0.4, 1.3, -0.7, 0.6])
    y = np.clip(np.floor((X[:, :8] @ w - 0.4 * X[:, 10] ** 2
                          + 0.5 * rng.rand(4000)) * 8) / 8, -6,
                5.875).astype(np.float32)
    extra, ds_extra = _constrained_params(tmp_path, path)
    runs = []
    for kw in ({}, {"device_type": "cpu"}):
        params = {"objective": "regression", "num_leaves": 31,
                  "max_bin": 63, "min_data_in_leaf": 20, "verbosity": -1,
                  "boost_from_average": False, **extra, **kw}
        hk.reset_launches()
        runs.append(lt.train(params, lt.Dataset(
            X, label=y, params=dict(params, **ds_extra)), 3))
        if not kw:
            own = {"m": FUSED, "m'": ("hist_q8", "hist_routed_fused",
                                      "leaf_sums"),
                   "m''": ("hist_f32",)}[path]
            assert min(hk.LAUNCHES[k] for k in own) > 0
    ta, tb = runs[0]._host_trees(), runs[1]._host_trees()
    assert len(ta) == len(tb) == 3
    for i, (a, b) in enumerate(zip(ta, tb)):
        assert a.num_leaves == b.num_leaves > 4
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        quant = runs[0]._gbdt.gp.quant
        if quant or i:
            np.testing.assert_allclose(
                a.leaf_value, b.leaf_value, rtol=0,
                atol=(1e-6 if quant else 2 ** -17)
                * np.abs(b.leaf_value).max())
        else:
            np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    if path != "m":
        assert all(t.split_feature[0] == 0 for t in ta)


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(0, 12), (12, 24), (5, 17), (37, 40)])
@pytest.mark.parametrize("kernel", ["hist_q8", "hist_f32"])
def test_slot_hists_on_a_feature_tile_equal_plain(dev, kernel, lo, hi):
    # a feature tile read in place: bins_T's rows [lo, hi) (a view), the
    # whole row-major bins [N, 40] and col0 = lo, with a slot vector (and
    # route_level-style counts) and without one; hist_q8 exactly, hist_f32
    # counts exactly and g, h within 2^-15 of the cell's absolute mass; an
    # unaligned tile (col0 % 4 != 0 or an odd width) takes the byte path
    rng = np.random.default_rng(lo)
    n, f, b, s = 7001, 40, 64, 9
    bins = torch.from_numpy(rng.integers(0, b, size=(n, f)).astype(
        np.uint8)).to(dev)
    bins_T = bins.t().contiguous()
    slot = torch.from_numpy(rng.integers(0, s + 3, size=n).astype(
        np.int32)).to(dev)
    counts = torch.bincount(slot[slot < s].long(), minlength=s).to(
        torch.int32)
    if kernel == "hist_q8":
        chans = [torch.from_numpy(rng.integers(-127, 128, n).astype(
                     np.int8)).to(dev),
                 torch.from_numpy(rng.integers(0, 128, n).astype(
                     np.int8)).to(dev),
                 torch.from_numpy((rng.random(n) < 0.9).astype(
                     np.int8)).to(dev)]
    else:
        chans = [torch.from_numpy(rng.normal(size=n).astype(
                     np.float32)).to(dev),
                 torch.from_numpy(rng.random(n).astype(np.float32)).to(dev),
                 torch.from_numpy((rng.random(n) < 0.9).astype(
                     np.float32)).to(dev)]
    tile = bins_T[lo:hi]
    for sl, ns, cnt in ((slot, s, counts), (slot, s, None), (None, 1, None)):
        got = getattr(hk, kernel)(tile, *chans, sl, ns, b, bins, cnt,
                                  col0=lo)
        want = getattr(hk, f"{kernel}_plain")(
            tile.cpu(), *(c.cpu() for c in chans),
            None if sl is None else sl.cpu(), ns, b)
        if kernel == "hist_q8":
            assert torch.equal(got.cpu(), want)
        else:
            mass = hk.hist_f32_plain(
                tile.cpu(), chans[0].abs().cpu(), chans[1].abs().cpu(),
                chans[2].cpu(), None if sl is None else sl.cpu(), ns,
                b).double()
            assert torch.equal(got[:, 2].cpu(), want[:, 2])
            err = (got.cpu().double() - want.double()).abs()
            assert bool((err[:, :2] <= 2.0 ** -15 * mass[:, :2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["lean", "lean_f32", "pooled"])
def test_gpu_lean_and_pooled_trees_equal_cpu(dev, path):
    # 4000 rows on exact-sum labels: the lean grower (tiles of 5 of 23
    # columns, so offsets 5, 10, 15 and 20) quantized and not, and the
    # pooled leaf-wise grower (4 of 31 leaves cached) train on the card
    # the CPU's trees: structure exact, leaf values within 1e-6 of the
    # largest (quantized) or the first tree bit for bit and later ones
    # within 2^-17 (f32 atomics); each path's kernels launched
    rng = np.random.RandomState(5)
    X = rng.randn(4000, 23).astype(np.float32)
    y = np.clip(np.floor((X[:, 0] - 0.7 * X[:, 7] + 0.5 * X[:, 16] ** 2
                          + 0.5 * rng.rand(4000)) * 8) / 8, -6,
                5.875).astype(np.float32)
    L, B = 31, 64
    extra = {"lean": {"histogram_pool_size": (5 * 30 * 3 * B * 4 + 1)
                      / 2.0 ** 20},
             "lean_f32": {"histogram_pool_size": (5 * 30 * 3 * B * 4 + 1)
                          / 2.0 ** 20, "use_quantized_grad": False},
             "pooled": {"histogram_pool_size": (4 * 3 * 23 * B * 4 + 1)
                        / 2.0 ** 20, "grow_policy": "lossguide"}}[path]
    runs = []
    for kw in ({}, {"device_type": "cpu"}):
        params = {"objective": "regression", "num_leaves": L, "max_bin": 63,
                  "min_data_in_leaf": 20, "verbosity": -1,
                  "boost_from_average": False, **extra, **kw}
        hk.reset_launches()
        runs.append(lt.train(params, lt.Dataset(X, label=y, params=params),
                             3))
        if not kw:
            own = {"lean": ("hist_q8", "route_level", "leaf_sums"),
                   "lean_f32": ("hist_f32", "route_level", "leaf_sums"),
                   "pooled": ("hist_f32",)}[path]
            assert min(hk.LAUNCHES[k] for k in own) > 0
            assert hk.LAUNCHES["hist_routed_fused"] == 0
    gp = runs[0]._gbdt.gp
    assert (gp.lean_ft, gp.hist_pool) == ((0, 4) if path == "pooled"
                                          else (5, 0))
    quant = gp.quant
    ta, tb = runs[0]._host_trees(), runs[1]._host_trees()
    for i, (a, b) in enumerate(zip(ta, tb)):
        assert a.num_leaves == b.num_leaves > 4
        for name in STRUCT:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        if quant or i:
            np.testing.assert_allclose(
                a.leaf_value, b.leaf_value, rtol=0,
                atol=(1e-6 if quant else 2 ** -17)
                * np.abs(b.leaf_value).max())
        else:
            np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


# ---- cold start and serving ----

def _ingest_rows(n, f, seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    X[:, 3] = rng.randint(0, 5, n)
    X[rng.rand(n, f) < 0.02] = np.nan
    return X, (X[:, 0] > 0.5).astype(np.float32)


@pytest.mark.cuda
def test_ingest_pipeline_on_the_card_equals_plain(dev):
    from lightgbm_tpu_torch import ingest
    from lightgbm_tpu_torch.binning import bin_data
    X, y = _ingest_rows(200_003, 9, 1)
    ds = lt.Dataset(X, label=y, params={"verbosity": -1,
                                        "ingest_chunk_rows": 10 ** 9})
    ds.construct()
    plain = bin_data(X, ds.mappers, list(ds.feature_map), dev)
    assert torch.equal(ds.bins, plain)
    # 7 threads x many small chunks: each staging buffer is reused
    got = ingest.stream_encode_upload(
        X, ds.mappers, list(ds.feature_map), None, dev, chunk_rows=4097,
        encode_threads=7)
    assert torch.equal(got, plain)
    st = ingest.last_stats()
    assert st["chunks"] == -(-X.shape[0] // 4097)
    assert st["h2d_s"] > 0 and st["commit_s"] > 0
    cpu = ingest.stream_encode_upload(
        X, ds.mappers, list(ds.feature_map), None, torch.device("cpu"),
        chunk_rows=50_000, encode_threads=2)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_ingest_oom_halving_on_the_card(dev):
    from lightgbm_tpu_torch import ingest
    from lightgbm_tpu_torch.utils import faults
    X, y = _ingest_rows(100_000, 6, 2)
    want = lt.Dataset(X, label=y, params={"verbosity": -1}).construct().bins
    faults.configure("device_put_oom:1")
    try:
        ds = lt.Dataset(X, label=y, params={"verbosity": -1,
                                            "ingest_chunk_rows": 30_000})
        ds.construct()
    finally:
        faults.reset()
    assert ingest.last_stats()["chunk_rows"] == 15_000
    assert torch.equal(ds.bins, want)


@pytest.mark.cuda
def test_prewarm_warms_the_fused_path_counted_apart(dev, monkeypatch):
    from lightgbm_tpu_torch import prewarm
    monkeypatch.setattr(prewarm, "MIN_PREWARM_ROWS", 0)
    X, y = _ingest_rows(50_000, 8, 3)
    p = {"objective": "binary", "max_bin": 63, "verbosity": -1}
    ds = lt.Dataset(X, label=y, params=p)
    ds.construct()
    h = ds._prewarm.join()
    assert "error" not in h.result, h.result
    assert h.result["warmed"] == {k: 1 for k in h.kernels}
    hk.reset_launches()
    bst = lt.train(p, ds, 1)
    assert bst._gbdt.prewarm_adopted
    assert hk.LAUNCHES["grad_quant_hist0"] == 1   # the training's own


@pytest.mark.cuda
@pytest.mark.parametrize("cat", [False, True])
def test_engine_walk_on_the_card_equals_cpu(dev, cat):
    from lightgbm_tpu_torch.serving import PredictEngine
    rng = np.random.RandomState(4)
    X = rng.rand(3000, 8)
    if cat:
        X[:, 2] = rng.randint(0, 9, 3000)
    y = X[:, 0] * 3 + (X[:, 2] % 3 == 0) + rng.randn(3000) * 0.05
    p = {"objective": "regression", "num_leaves": 31, "verbosity": -1,
         "device_type": "cpu"}
    b = lt.train(p, lt.Dataset(X, label=y, params=p,
                               categorical_feature=[2] if cat else "auto"),
                 10)
    q = rng.rand(1000, 8)
    if cat:
        q[:, 2] = rng.randint(-1, 11, 1000)
    q[rng.rand(1000, 8) < 0.05] = np.nan
    engines = [PredictEngine(b._host_trees(), 8, 1, False,
                             objective=b._objective_for_predict(),
                             chunk_rows=256, device=d)
               for d in (dev, torch.device("cpu"))]
    for kw in ({"pred_leaf": True}, {"raw_score": True}, {}):
        on_card, on_cpu = (e.predict(q, **kw) for e in engines)
        assert np.array_equal(on_card, on_cpu), kw


@pytest.mark.cuda
def test_serve_flush_loop_adds_no_allocator_retry(dev):
    from lightgbm_tpu_torch.server import PredictServer
    rng = np.random.RandomState(5)
    X = rng.rand(2000, 8)
    y = (X[:, 0] + X[:, 1] > 1).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    b = lt.train(p, lt.Dataset(X, label=y, params=p), 10)
    srv = PredictServer({"verbosity": -1, "serve_max_batch_rows": 64},
                        model=b)
    try:
        for n in (1, 8, 64):
            srv.predict(X[:n])
        retries = torch.cuda.memory_stats()["num_alloc_retries"]
        eng = srv.registry.current().engine
        seen = set(eng.stats["buckets_seen"])
        want = b.predict(X[:64])
        for i in range(200):
            n = (1, 5, 8, 33, 64)[i % 5]
            assert np.array_equal(srv.predict(X[:n]), want[:n])
        assert torch.cuda.memory_stats()["num_alloc_retries"] == retries
        assert eng.stats["buckets_seen"] == seen
    finally:
        srv.close()


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [0, 2500])
def test_dataset_append_on_the_card_equals_construct_and_cpu(dev, cap):
    rng = np.random.RandomState(6)
    X = rng.rand(4000, 8)
    X[3100, 0] = np.nan
    X[3200, 1] = 50.0
    y = (X[:, 0] > 0.5).astype(float)
    w = rng.uniform(0.5, 2.0, 4000)
    p = {"verbosity": -1, "max_bin": 63, "ingest_chunk_rows": 300}
    out = {}
    for d in ("cuda", "cpu"):
        pp = {**p, "device_type": d}
        ds = lt.Dataset(X[:2000], label=y[:2000], weight=w[:2000],
                        params=pp).construct()
        for lo, hi in ((2000, 3001), (3001, 3002), (3002, 4000)):
            ds.append(X[lo:hi], label=y[lo:hi], weight=w[lo:hi],
                      max_rows=cap or None)
        out[d] = ds
    n = cap or 4000
    ds = out["cuda"]
    assert ds.bins.is_cuda and ds.label.is_cuda and ds.weight.is_cuda
    assert ds.num_data == n and ds.bins.shape[0] == n
    ref = lt.Dataset(X[4000 - n:], label=y[4000 - n:], weight=w[4000 - n:],
                     reference=ds, params={**p, "device_type": "cuda"})
    ref.construct()
    assert torch.equal(ds.bins, ref.bins)
    assert torch.equal(ds.bins.cpu(), out["cpu"].bins)
    assert torch.equal(ds.bins_T, ds.bins.t().contiguous())
    assert torch.equal(ds.label, ref.label)
    assert torch.equal(ds.weight, ref.weight)


@pytest.mark.cuda
def test_online_boost_cycle_on_the_card_equals_offline(dev):
    from lightgbm_tpu_torch.online import OnlineTrainer, merge_boosters
    rng = np.random.RandomState(7)
    X = rng.rand(6000, 8)
    y = (X[:, 0] + X[:, 1] > 1).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbosity": -1, "online_refit_rows": 2000,
         "online_boost_rounds": 2, "online_max_rows": 4000}
    b1 = lt.train(p, lt.Dataset(X[:4000], label=y[:4000], params=p), 3)
    ds = lt.Dataset(X[:4000], label=y[:4000], params=p)
    tr = OnlineTrainer(p, ds, booster=b1)
    hk.reset_launches()
    assert tr.feed(X[4000:5000], y[4000:5000]) is None
    assert tr.feed(X[5000:], y[5000:]) == 1
    launches = dict(hk.LAUNCHES)
    tr.close()
    assert ds.num_data == 4000
    off = lt.Dataset(X[2000:], label=y[2000:], reference=ds, params=p)
    delta = lt.train(p, off, 2, init_model=b1)
    assert torch.equal(ds.bins, off.bins)
    assert tr.booster.model_to_string() == \
        merge_boosters(b1, delta).model_to_string()
    passes = sum(delta._gbdt.hist_passes)
    assert launches["grad_quant_hist0"] == 2
    assert launches["leaf_sums_grad"] == 2
    assert launches["hist_routed_fused"] == passes
    assert launches["take_small"] == 2 + b1.num_trees()


# ---- multi-GPU in one process (parallel/): the mesh on cuda:0 copies ----

@pytest.mark.cuda
def test_shard_sum_on_virtual_card_copies(dev):
    """The shard sum (ops/grow._hist_allreduce) of four histograms on
    virtual copies of the card: in shard order, in f32, on the first
    shard's device, bit for bit the sequential sum; the 2-D mesh's feature
    blocks gathered give the same bits."""
    import dataclasses
    from lightgbm_tpu_torch.ops import grow as G
    gen = torch.Generator(device=dev).manual_seed(3)
    parts = [torch.randn((31, 3, 28, 64), generator=gen, device=dev)
             for _ in range(4)]
    gp = G.GrowParams(axis_name="data")
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    got = G._hist_allreduce(parts, gp, 2)
    assert got.device == parts[0].device and torch.equal(got, want)
    gp2 = dataclasses.replace(gp, feature_axis_name="feature",
                              feature_shards=2)
    got2 = G._hist_allreduce(parts, gp2, 2, (dev, dev))
    assert torch.equal(got2, want)


@pytest.mark.cuda
def test_sharded_front_dithers_each_shard_by_its_local_row(dev, rows):
    """Each shard's fused front (grad_quant_hist0) on its own row block
    quantizes with its own max-abs scale and the dither of its local row
    index: shard s's channels equal the front run alone on its rows, on
    the card and on the CPU, and not the whole run's rows of that range."""
    from lightgbm_tpu_torch.parallel.mesh import (plan_row_sharding,
                                                  virtual_devices)
    spec = LOGLOSS
    with virtual_devices(4, dev):
        plan = plan_row_sharding(N, 4, kind=dev.type)
    blocks = plan.split(rows["bins_T"].t().contiguous())
    parts = [plan.split(rows[k]) for k in ("score", "label_pos", "bag")]
    whole = hk.grad_quant_hist0(rows["bins_T"], rows["score"],
                                rows["label_pos"], rows["bag"], 7, spec, B,
                                False)
    for s in range(4):
        bt = blocks[s].t().contiguous()
        got = hk.grad_quant_hist0(bt, parts[0][s], parts[1][s], parts[2][s],
                                  7, spec, B, False)
        cpu = hk.grad_quant_hist0(bt.cpu(), parts[0][s].cpu(),
                                  parts[1][s].cpu(), parts[2][s].cpu(), 7,
                                  spec, B, False)
        for a, b in zip(got, cpu):
            if a is not None:
                assert torch.equal(a.cpu(), b)
        lo, hi = plan.shard_rows_range(s)
        if s:
            assert not torch.equal(got[0][:hi - lo], whole[0][lo:hi])


@pytest.mark.cuda
def test_t1_lattice_four_shards_equal_serial_on_the_card(dev):
    """Path (t1) of chip_smoke.py at 100,000 rows: integer gradients, a
    constant hessian 0.25, unquantized, 3 iterations on 4 virtual shards
    of the card byte for byte the serial card run; each shard launches
    hist_f32, route_level and take_small."""
    from lightgbm_tpu_torch.parallel.mesh import virtual_devices
    rng = np.random.RandomState(8)
    X = rng.standard_normal((100_000, 28)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)

    def fobj(preds, ds):
        g = np.sign(np.round(np.asarray(preds, np.float64) * 4.0)
                    - (2.0 * ds.get_label() - 1.0))
        return g.astype(np.float32), np.full(g.shape, 0.25, np.float32)

    p = {"objective": "none", "num_leaves": 255, "max_bin": 63,
         "use_quantized_grad": False, "verbosity": -1, "prewarm": 0,
         "min_data_in_leaf": 20}
    serial = lt.train(p, lt.Dataset(X, label=y, params=p), 3, fobj=fobj)
    with virtual_devices(4, dev):
        q = {**p, "num_shards": 4}
        hk.reset_launches()
        sharded = lt.train(q, lt.Dataset(X, label=y, params=q), 3,
                           fobj=fobj)
        launches = dict(hk.LAUNCHES)
    assert sharded._gbdt._shard_plan.num_shards == 4
    head = [b.model_to_string().split("\nparameters:\n")[0]
            for b in (serial, sharded)]
    assert head[0] == head[1]
    passes = sum(sharded._gbdt.hist_passes)
    assert launches["hist_f32"] == 4 * (3 + passes)
    assert launches["route_level"] == 4 * passes
    assert launches["take_small"] == 4 * 3


@pytest.mark.cuda
def test_gloo_transport_stages_card_payloads_through_the_host(dev):
    """Ranks that share a card sum over gloo: a card tensor is copied to
    the host, summed there and copied back to its card, the copy counted
    (``multihost.XFER``); the input is left as it was."""
    import torch.distributed as dist
    from lightgbm_tpu_torch.parallel import mesh as M
    from lightgbm_tpu_torch.parallel import multihost as PM
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _mp_util import free_port
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    saved = dict(M.DIST)
    try:
        M.DIST.update(backend="gloo", device=torch.device("cpu"), card=dev)
        PM.reset_xfer()
        t = torch.arange(3 * 28 * 64, dtype=torch.float32,
                         device=dev).reshape(3, 28, 64)
        out = PM.allreduce_sum(t)
        assert out.device == t.device and out is not t
        assert torch.equal(out, t)
        assert PM.XFER["calls"] == 1
        assert PM.XFER["bytes"] == 2 * t.numel() * 4
        (back,) = PM.wire_allgather(np.arange(5, dtype=np.float64))
        assert np.array_equal(back, np.arange(5))
    finally:
        M.DIST.update(saved)
        dist.destroy_process_group()


@pytest.mark.cuda
def test_two_rank_lattice_drill_on_the_card(dev, tmp_path):
    """Two rank processes (scripts/torch_pod_worker.py) share the card over
    gloo, 2 virtual shards each: integer gradients, hessian 0.25,
    unquantized, 3 iterations at 20,000 rows, byte for byte the
    one-process run on 4 virtual shards of the card; each rank launches
    hist_f32, route_level and take_small on its own 2 shards."""
    import json
    from lightgbm_tpu_torch.parallel.mesh import virtual_devices
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _mp_util import free_port
    rng = np.random.RandomState(8)
    X = rng.standard_normal((20_000, 28))
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    p = {"objective": "none", "num_leaves": 31, "max_bin": 63,
         "use_quantized_grad": False, "verbosity": -1,
         "min_data_in_leaf": 20, "num_shards": 4}
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "world": 2, "port": free_port(), "devices": 2,
        "device_type": "cuda", "out": str(tmp_path),
        "jobs": [{"name": "u", "data": str(tmp_path), "params": p,
                  "rounds": 3, "fobj": "int"}]}))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "scripts",
                                      "torch_pod_worker.py"), str(spec)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, RANK=str(r), OMP_NUM_THREADS="1"))
        for r in (0, 1)]
    outs = [q.communicate(timeout=300)[0] for q in procs]
    assert all(q.returncode == 0 for q in procs), outs[0][-2000:]
    res = [json.loads(next(ln for ln in o.splitlines()
                           if ln.startswith("POD_RESULT "))[11:])
           for o in outs]
    assert res[0]["tree"] == res[1]["tree"] and res[0]["ranks_agree"]
    assert res[0]["backend"] == ("gloo" if torch.cuda.device_count() < 2
                                 else "nccl")
    sys.path.insert(0, os.path.join(root, "scripts"))
    from torch_pod_worker import int_fobj, tree_digest
    with virtual_devices(4, dev):
        q = {**p, "device_type": "cuda"}
        one = lt.train(q, lt.Dataset(X, label=y, params=q), 3,
                       fobj=int_fobj)
    assert res[0]["tree"] == tree_digest(one.model_to_string())
    for r in res:
        passes = sum(r["passes"])
        assert r["launches"]["hist_f32"] == 2 * (3 + passes)
        assert r["launches"]["route_level"] == 2 * passes
        assert r["launches"]["take_small"] == 2 * 3
