"""Kernel-level parity of the PyTorch/CUDA port (lightgbm_tpu_torch) against
the JAX reference (lightgbm_tpu), on the CPU.

The reference runs its Pallas kernels in interpret mode, as
tests/test_hist_packed.py does; the port runs each kernel wrapper on CPU
tensors, i.e. through the kernel's plain PyTorch version. Inputs are made
from a seed with numpy and handed to both as the same arrays.

Tolerances (each stated where it is asserted):
- exact: the dither, the L2 quantized channels, scales and root histogram,
  the level pass (histogram and new leaf ids, 2 and 3 channels, packed
  lattice on and off; a first level, a level with no row kept and a skewed
  one), the slot histogram over a slot vector (hist_q8), the
  level routing (route_level), the two-pass level and the unfused root
  histogram at F * B > 2048, and take_small (on N % 4 != 0 rows and offset
  views too); integer sums make them order-free;
- logloss front: torch.exp and XLA's expf differ by at most 1 ulp, which
  moves g by at most 2 ulp; the test measures the gap and bounds the share
  of quantized rows that move by one step;
- leaf sums (leaf_sums_grad, leaf_sums): the reference sums bf16 hi/lo
  halves (16 significant bits per row), the port sums the f32 rows in f64:
  |diff| <= 2^-15 * sum|x|, counts exact; on uniform, skewed and
  out-of-range leaf ids; their launch plan keeps the warp tables within
  the shared-memory budget;
- the f32 slot histogram (hist_f32) and the unquantized root and level
  passes: exact on gradients and hessians on a 1/8 grid (the hi/lo split
  keeps them whole and every partial sum is representable), else the hi/lo
  error against the port's f64 sums: |diff| <= 2^-15 * the cell's sum|x|,
  counts exact;
- the plan of the slot histograms (hist_q8, hist_f32, hist_routed_fused)
  and their plain compaction: every kept row in exactly one segment of its
  own slot per feature group, each block's table within the shared-memory
  budget, the blocks an SM at B = 64 and 256.

The card-side twins of these checks are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import histogram as ref_hist
from lightgbm_tpu.ops import pallas_hist as ph
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops import histogram as th

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

N, F, B, L, S = 220, 7, 16, 8, 3
SEED = 12345
LOGLOSS = ("logloss", 1.0, 1.0, 1.0)
LOGLOSS_W = ("logloss", 0.7, 1.0, 2.0)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    return {
        "bins": rng.integers(0, B, size=(N, F)).astype(np.uint8),
        "score": rng.normal(size=N).astype(np.float32),
        "label": np.round(rng.normal(size=N) * 8).astype(np.float32) / 8,
        "label_pos": (rng.random(N) < 0.5).astype(np.float32),
        "bag": (rng.random(N) < 0.8).astype(np.float32),
        "lid": rng.integers(0, L, size=N).astype(np.int32),
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_front(rows, spec, aux, const_hess, pack_k=0):
    gq, hq, cq, sg, sh, hist0 = ph.grad_quant_hist0_pallas(
        jnp.asarray(rows["bins"].T), jnp.asarray(rows["score"]),
        jnp.asarray(aux), jnp.asarray(rows["bag"]), SEED, spec, B,
        const_hess=const_hess, pack_k=pack_k, interpret=True)
    return {"gq": np.asarray(gq), "hq": None if hq is None else np.asarray(hq),
            "cq": np.asarray(cq), "scale_g": np.asarray(sg),
            "scale_h": np.asarray(sh), "hist0": np.asarray(hist0)}


def _port_front(rows, spec, aux, const_hess):
    quant, hist0 = th.grad_quant_hist0(
        _t(rows["bins"].T), _t(rows["score"]), _t(aux), _t(rows["bag"]),
        SEED, spec, B, const_hess=const_hess)
    return quant, hist0


@pytest.mark.parametrize("salt", [1, 2])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_sr_dither_matches_reference_quantizer(seed, salt):
    # exact: the uint32 counter hash replayed in int64 must give the same
    # f32 uniforms, hence the same quantized rows
    rng = np.random.default_rng(seed % 97)
    x = rng.normal(size=N).astype(np.float32)
    q_ref, s_ref = ref_hist.quantize_sr(jnp.asarray(x), seed, salt)
    q, s = th.quantize_sr(_t(x), seed, salt)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert s.item() == float(s_ref)


@pytest.mark.parametrize("const_hess", [False, True])
def test_make_quant_matches_reference(rows, const_hess):
    # exact: the unfused quantizer on the same (g, h, c) rows gives the same
    # int8 channels and scales (under const-hess: no hq, scale_h = 127 max h)
    rng = np.random.default_rng(3)
    g = rng.normal(size=N).astype(np.float32) * rows["bag"]
    h = (rows["bag"] if const_hess
         else rng.random(N).astype(np.float32) * rows["bag"])
    c = (rows["bag"] > 0).astype(np.float32)
    ref = ref_hist.make_quant(jnp.asarray(g), jnp.asarray(h), jnp.asarray(c),
                              SEED, const_hess=const_hess)
    got = th.make_quant(_t(g), _t(h), _t(c), SEED, const_hess=const_hess)
    for name in ("gq", "hq", "cq"):
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None) == (const_hess and name == "hq")
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.scale_g.item() == float(ref.scale_g)
    assert got.scale_h.item() == float(ref.scale_h)


@pytest.mark.parametrize("n", [1, 220, 1 << 20, 1 << 24])
@pytest.mark.parametrize("const_hess", [False, True])
def test_pack_guard_bits_matches_reference(n, const_hess):
    assert th.pack_guard_bits(n, const_hess) == \
        ref_hist.pack_guard_bits(n, const_hess)


@pytest.mark.parametrize("pack", [False, True])
def test_l2_front_exact(rows, pack):
    # exact: L2 gradients have no transcendental, so the quantized
    # channels, scales and the dequantized root histogram are bit-identical
    # to the reference with its packed lattice on or off
    pk = ref_hist.pack_guard_bits(N, True) if pack else 0
    ref = _ref_front(rows, ("l2",), rows["label"], True, pack_k=pk)
    quant, hist0 = _port_front(rows, ("l2",), rows["label"], True)
    assert quant.hq is None and ref["hq"] is None
    np.testing.assert_array_equal(quant.gq.numpy(), ref["gq"])
    np.testing.assert_array_equal(quant.cq.numpy(), ref["cq"])
    assert quant.scale_g.item() == float(ref["scale_g"])
    assert quant.scale_h.item() == float(ref["scale_h"])
    np.testing.assert_array_equal(hist0.numpy(), ref["hist0"])


def test_l2_gradients_exact(rows):
    # exact: grad = score - label, hess = 1
    g_ref, h_ref = ph._grad_rows(("l2",), jnp.asarray(rows["score"]),
                                 jnp.asarray(rows["label"]))
    g, h = hk.grad_rows(("l2",), _t(rows["score"]), _t(rows["label"]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("spec", [LOGLOSS, LOGLOSS_W])
def test_logloss_gradients_ulp_gap(rows, spec):
    # measured: torch.exp (CPU) and XLA's expf differ by at most 1 ulp on
    # about a tenth of these rows; through resp the gradient moves by at
    # most 2 ulp, and the hessian resp * (1 - resp) by a few ulp more where
    # 1 - resp cancels (8 ulp bound here)
    g_ref, h_ref = ph._grad_rows(spec, jnp.asarray(rows["score"]),
                                 jnp.asarray(rows["label_pos"]))
    g, h = hk.grad_rows(spec, _t(rows["score"]), _t(rows["label_pos"]))
    assert _ulps(g.numpy(), np.asarray(g_ref)).max() <= 2
    assert _ulps(h.numpy(), np.asarray(h_ref)).max() <= 8


@pytest.mark.parametrize("spec", [LOGLOSS, LOGLOSS_W])
def test_logloss_front_within_exp_gap(rows, spec):
    # tolerance: the exp gap above can move a quantized row by one step
    # (measured: none of these rows moves); bounded at 1% of rows, |step| 1;
    # the scales are within 4 ulp and the count channel is exact
    ref = _ref_front(rows, spec, rows["label_pos"], False)
    quant, hist0 = _port_front(rows, spec, rows["label_pos"], False)
    for name, got in (("gq", quant.gq), ("hq", quant.hq)):
        d = np.abs(got.numpy().astype(np.int32) - ref[name].astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, name
    np.testing.assert_array_equal(quant.cq.numpy(), ref["cq"])
    for name in ("scale_g", "scale_h"):
        got = np.float32(getattr(quant, name).item())
        assert _ulps(np.array([got]), np.array([ref[name]],
                                               np.float32)).max() <= 4
    np.testing.assert_array_equal(hist0[2].numpy(), ref["hist0"][2])
    np.testing.assert_allclose(hist0[:2].numpy(), ref["hist0"][:2],
                               rtol=1e-6, atol=0.02 * float(ref["scale_g"]))


def _tables(rows):
    """Route tables with non-splitting leaves (feat -1), NA bins and a
    dropped slot: leaves 0..4 split, 5..7 do not; leaf 4 routes both
    children to the sentinel slot S."""
    feat = np.array([0, 3, 1, 6, 2, -1, -1, -1], np.int32)
    thr = np.array([5, 9, 2, 11, 7, 0, 0, 0], np.int32)
    dleft = np.array([1, 0, 0, 1, 0, 0, 0, 0], np.int32)
    new_leaf = np.arange(L, 2 * L, dtype=np.int32)
    slot_left = np.array([0, S, 1, S, S, S, S, S], np.int32)
    slot_right = np.array([S, 2, S, 0, S, S, S, S], np.int32)
    na_bin = np.full(F, 256, np.int32)
    na_bin[1] = 4
    na_bin[3] = 0
    return (feat, thr, dleft, new_leaf, slot_left, slot_right), na_bin


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("const_hess", [False, True])
def test_hist_routed_fused_exact(rows, const_hess, pack):
    # exact: the level pass's dequantized slot histogram and new leaf ids,
    # 3 channels (g, h, count) or 2 (g, count under const-hessian), against
    # the reference kernel with its packed lattice on and off
    spec, aux = (("l2",), rows["label"]) if const_hess \
        else (LOGLOSS, rows["label_pos"])
    quant, _ = _port_front(rows, spec, aux, const_hess)
    cols, na_bin = _tables(rows)
    ref_tabs = ref_hist.RouteTables(*[jnp.asarray(c) for c in cols])
    pk = ref_hist.pack_guard_bits(N, const_hess) if pack else 0
    hq_ref = quant.cq if const_hess else quant.hq
    ref_h, ref_lid = ph.hist_routed_fused_q8(
        jnp.asarray(rows["bins"].T), jnp.asarray(quant.gq.numpy()),
        jnp.asarray(hq_ref.numpy()), jnp.asarray(quant.cq.numpy()),
        jnp.asarray(rows["lid"]), ref_tabs, jnp.asarray(na_bin), S, B,
        jnp.float32(quant.scale_g.item()), jnp.float32(quant.scale_h.item()),
        L, const_hess=const_hess, pack_k=pk, interpret=True)
    tabs = th.RouteTables(*[_t(c) for c in cols])
    hist, lid2 = th.hist_routed(_t(rows["bins"].T), _t(rows["lid"]), tabs,
                                _t(na_bin), S, B, quant)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(lid2.numpy(), np.asarray(ref_lid))


def _level_case(case):
    """(leaf ids [N], route-table columns, S) of three level shapes: a
    first level (every row in leaf 0, which splits; S = 1, the smaller
    child kept), a level where no leaf splits (no row kept), and a skewed
    level (S = 3; four rows in five in leaf 0, whose kept left child then
    holds most kept rows)."""
    rng = np.random.default_rng(41)
    feat = np.full(L, -1, np.int32)
    thr = np.zeros(L, np.int32)
    dleft = np.zeros(L, np.int32)
    new_leaf = np.arange(L, 2 * L, dtype=np.int32)
    if case == "first_level":
        s = 1
        lid = np.zeros(N, np.int32)
        feat[0], thr[0], dleft[0] = 3, 9, 1
        slot_left = np.where(np.arange(L) == 0, 0, s).astype(np.int32)
        slot_right = np.full(L, s, np.int32)
    elif case == "no_split":
        s = S
        lid = rng.integers(0, L, size=N).astype(np.int32)
        slot_left = slot_right = np.full(L, s, np.int32)
    else:
        s = S
        lid = np.where(rng.random(N) < 0.8, 0,
                       rng.integers(1, 3, size=N)).astype(np.int32)
        feat[:3], thr[:3], dleft[:3] = (1, 4, 6), (B - 2, 5, 8), (0, 1, 0)
        slot_left = np.array([0, s, 2] + [s] * (L - 3), np.int32)
        slot_right = np.array([s, 1, s] + [s] * (L - 3), np.int32)
    return lid, (feat, thr, dleft, new_leaf, slot_left, slot_right), s


@pytest.mark.parametrize("const_hess", [False, True])
@pytest.mark.parametrize("case", ["first_level", "no_split", "skewed"])
def test_hist_routed_level_shapes_exact(rows, case, const_hess):
    # exact: the fused level pass through ops/histogram.hist_routed, given
    # the row-major bins as the growers give it, at a first level (S = 1),
    # a level where no leaf splits (a zero histogram, leaf ids unchanged)
    # and a skewed level (one slot holds most kept rows), 3 channels
    # (g, h, count) and 2 (g, count under const-hessian), against the
    # reference kernel
    spec, aux = (("l2",), rows["label"]) if const_hess \
        else (LOGLOSS, rows["label_pos"])
    quant, _ = _port_front(rows, spec, aux, const_hess)
    lid, cols, s = _level_case(case)
    _, na_bin = _tables(rows)
    hq_ref = quant.cq if const_hess else quant.hq
    ref_h, ref_lid = ph.hist_routed_fused_q8(
        jnp.asarray(rows["bins"].T), jnp.asarray(quant.gq.numpy()),
        jnp.asarray(hq_ref.numpy()), jnp.asarray(quant.cq.numpy()),
        jnp.asarray(lid), ref_hist.RouteTables(*[jnp.asarray(c)
                                                  for c in cols]),
        jnp.asarray(na_bin), s, B, jnp.float32(quant.scale_g.item()),
        jnp.float32(quant.scale_h.item()), L, const_hess=const_hess,
        interpret=True)
    hist, lid2 = th.hist_routed(_t(rows["bins"].T), _t(lid),
                                th.RouteTables(*[_t(c) for c in cols]),
                                _t(na_bin), s, B, quant,
                                bins=_t(rows["bins"]))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(lid2.numpy(), np.asarray(ref_lid))
    counts = hist[:, 2].sum(axis=(1, 2)).numpy() / F
    if case == "no_split":
        assert not hist.any() and (lid2.numpy() == lid).all()
    elif case == "skewed":
        assert counts[0] > counts[1:].sum() > 0


@pytest.mark.parametrize("spec,aux", [(("l2",), "label"),
                                      (LOGLOSS, "label_pos")])
def test_leaf_sums_grad_within_hi_lo_error(rows, spec, aux):
    # tolerance |diff| <= 2^-15 * sum|x| per leaf and channel: the
    # reference keeps 16 significant bits of each row (bf16 hi + lo), the
    # port sums the f32 rows in f64; counts are exact
    ref = np.asarray(ph.leaf_sums_grad_pallas(
        jnp.asarray(rows["score"]), jnp.asarray(rows[aux]),
        jnp.asarray(rows["bag"]), jnp.asarray(rows["lid"]), spec, L,
        interpret=True))
    got = hk.leaf_sums_grad(_t(rows["score"]), _t(rows[aux]),
                            _t(rows["bag"]), _t(rows["lid"]), spec, L).numpy()
    g, h = hk.grad_rows(spec, _t(rows["score"]), _t(rows[aux]))
    ghc = torch.stack([g * _t(rows["bag"]), h * _t(rows["bag"]),
                       (_t(rows["bag"]) > 0).float()]).double()
    mass = torch.zeros(3, L, dtype=torch.float64).index_add_(
        1, _t(rows["lid"]).long(), ghc.abs()).numpy()
    np.testing.assert_array_equal(got[2], ref[2])
    assert (np.abs(got - ref) <= 2.0 ** -15 * mass).all()


def _leaf_ids(kind, n, l, seed):
    """[n] int32 leaf ids: "skewed" draws leaf k with probability
    proportional to 1 / (k + 1) (chip_smoke.py's skewed leaves); "dropped"
    is uniform over [-3, L + 3), so some ids lie outside [0, L)."""
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        p = 1.0 / np.arange(1, l + 1)
        return rng.choice(l, size=n, p=p / p.sum()).astype(np.int32)
    return rng.integers(-3, l + 3, size=n).astype(np.int32)


def _assert_within_hi_lo(got, ref, ghc, lid):
    """Counts exact; g and h within 2^-15 * sum|x| of the leaf's rows (the
    reference keeps 16 significant bits of each row, bf16 hi + lo; the
    port sums the f32 rows in f64). Ids outside [0, L) add to no leaf."""
    ok = (lid >= 0) & (lid < L)
    mass = np.zeros((3, L))
    for k, x in enumerate(ghc):
        np.add.at(mass[k], lid[ok], np.abs(x[ok].astype(np.float64)))
    np.testing.assert_array_equal(got[2], ref[2])
    assert (np.abs(got - ref) <= 2.0 ** -15 * mass).all()


@pytest.mark.parametrize("leaves", ["skewed", "dropped"])
@pytest.mark.parametrize("spec,aux", [(("l2",), "label"),
                                      (LOGLOSS, "label_pos")])
def test_leaf_sums_grad_on_skewed_and_dropped_leaves(rows, spec, aux,
                                                     leaves):
    # test_leaf_sums_grad_within_hi_lo_error's tolerance on skewed leaf ids
    # and on ids outside [0, L), the reference's grid over chunks of 64
    # rows (N = 220: a ragged last chunk)
    lid = _leaf_ids(leaves, N, L, 7)
    ref = np.asarray(ph.leaf_sums_grad_pallas(
        jnp.asarray(rows["score"]), jnp.asarray(rows[aux]),
        jnp.asarray(rows["bag"]), jnp.asarray(lid), spec, L, chunk=64,
        interpret=True))
    got = hk.leaf_sums_grad(_t(rows["score"]), _t(rows[aux]),
                            _t(rows["bag"]), _t(lid), spec, L).numpy()
    g, h = hk.grad_rows(spec, _t(rows["score"]), _t(rows[aux]))
    bag = rows["bag"]
    _assert_within_hi_lo(got, ref, (g.numpy() * bag, h.numpy() * bag,
                                    (bag > 0).astype(np.float32)), lid)


@pytest.mark.parametrize("l", [1, 255, 1000, 8533, 8534])
def test_leaf_sums_plan_fits_shared_memory(l):
    # as many warp tables (3 * L f64 each, in 16-byte cells) as LEAF_WARPS
    # and the budget allow, none past 8533 leaves (global tables); at most
    # two blocks an SM, and no block without rows
    table = hk.leaf_table_bytes(l)
    assert 24 * l <= table <= 24 * l + 8 and table % 16 == 0
    for n in (0, 1, 5000, 1_000_001, 10_500_000):
        warps, grid = hk.leaf_sums_plan(n, l, 132)
        assert 0 <= warps <= hk.LEAF_WARPS
        assert warps * table <= hk.SMEM_BUDGET
        assert warps == hk.LEAF_WARPS or (warps + 1) * table > \
            hk.SMEM_BUDGET
        assert (warps == 0) == (l > 8533)
        threads = 32 * (warps or hk.LEAF_WARPS)
        assert 1 <= grid <= 2 * 132
        assert (grid - 1) * threads * 4 < max(n, 1)


def test_leaf_sums_refuse_no_leaves():
    z = torch.zeros(4)
    lid = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_leaves"):
        hk.leaf_sums(z, z, z, lid, 0)
    with pytest.raises(ValueError, match="num_leaves"):
        hk.leaf_sums_grad(z, z, z, lid, ("l2",), 0)


# ---- the unfused path's kernels (hist_q8, route_level, leaf_sums) at
# B = 256, F * B > 2048: the reference's hist_leaf / hist_routed leave the
# fused kernels there ----

NW, FW, BW, SW = 300, 9, 256, 5


@pytest.fixture(scope="module")
def wide():
    """Rows over the full uint8 bin range (0 and 255 included), quantized
    channels with and without const-hessian elision, and a slot vector with
    dropped slots (>= S and negative)."""
    rng = np.random.default_rng(21)
    bins = rng.integers(0, BW, size=(NW, FW)).astype(np.uint8)
    bins[:3] = 0
    bins[3:6] = BW - 1
    # a quarter of the rows in the missing bin of features 1, 4 and 6
    for j, na in zip((1, 4, 6), _wide_na_bin()[[1, 4, 6]]):
        bins[rng.random(NW) < 0.25, j] = na
    bag = (rng.random(NW) < 0.85).astype(np.float32)
    g = rng.normal(size=NW).astype(np.float32) * bag
    h = rng.random(NW).astype(np.float32) * bag
    c = (bag > 0).astype(np.float32)
    slot = rng.integers(0, SW + 3, size=NW).astype(np.int32)
    slot[::17] = -1
    quants = {ch: th.make_quant(_t(g), _t(bag if ch else h), _t(c), SEED,
                                const_hess=ch) for ch in (False, True)}
    return {"bins": bins, "g": g, "h": h, "c": c, "slot": slot,
            "quants": quants}


def _ref_q8_args(quant):
    """(gq, hq-or-cq, cq, scale_g, scale_h) as the reference's q8 kernels
    take them (_q8_h_arg: const-hessian passes cq in hq's place)."""
    hq = quant.cq if quant.hq is None else quant.hq
    return (jnp.asarray(quant.gq.numpy()), jnp.asarray(hq.numpy()),
            jnp.asarray(quant.cq.numpy()), jnp.float32(quant.scale_g.item()),
            jnp.float32(quant.scale_h.item()))


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("const_hess", [False, True])
@pytest.mark.parametrize("s", [1, SW])
def test_hist_q8_exact(wide, s, const_hess, pack):
    # exact: the dequantized slot histogram over a slot vector, one slot
    # (every row; the port reads no slot vector) or S slots with dropped
    # rows, 3 or 2 channels, against the reference with its packed lattice
    # on and off
    quant = wide["quants"][const_hess]
    gq, hq, cq, sg, sh = _ref_q8_args(quant)
    slot = np.zeros(NW, np.int32) if s == 1 else wide["slot"]
    pk = ref_hist.pack_guard_bits(NW, const_hess) if pack else 0
    ref = ph.hist_pallas_q8(jnp.asarray(wide["bins"].T), gq, hq, cq,
                            jnp.asarray(slot), s, BW, sg, sh,
                            const_hess=const_hess, pack_k=pk, interpret=True)
    acc = hk.hist_q8(_t(wide["bins"].T), quant.gq, quant.hq, quant.cq,
                     None if s == 1 else _t(slot), s, BW)
    assert acc.dtype == torch.int32
    assert tuple(acc.shape) == (s, 2 if const_hess else 3, FW, BW)
    got = th.dequant(acc, const_hess, quant.scale_g, quant.scale_h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _wide_tables(rng, l, s):
    """[L] route-table columns with non-splitting leaves (feat -1), new
    leaf ids past bf16's exact integer range (> 256), thresholds over the
    whole bin axis and sentinel slots."""
    feat = rng.integers(-1, FW, size=l).astype(np.int32)
    feat[:4] = -1
    thr = rng.integers(0, BW, size=l).astype(np.int32)
    dleft = rng.integers(0, 2, size=l).astype(np.int32)
    # leaves that split on the features with missing bins, missing rows
    # sent both ways
    feat[4:7] = (1, 4, 6)
    dleft[4:7] = (0, 1, 0)
    new_leaf = (l + np.arange(l)).astype(np.int32)
    slot_left = rng.integers(0, s + 1, size=l).astype(np.int32)
    slot_right = rng.integers(0, s + 1, size=l).astype(np.int32)
    return feat, thr, dleft, new_leaf, slot_left, slot_right


def _wide_na_bin():
    na_bin = np.full(FW, 256, np.int32)
    na_bin[1] = 0
    na_bin[4] = BW - 1
    na_bin[6] = 17
    return na_bin


@pytest.mark.parametrize("l", [8, 300])
def test_route_level_exact(wide, l):
    # exact (slot, new leaf id) per row, with NA bins (bins 0, 255 and 17
    # missing for three features), leaves that do not split and L = 300,
    # whose leaf ids the reference decodes at HIGHEST precision; leaf ids
    # stay in [0, L) as real rows' do
    rng = np.random.default_rng(l)
    cols = _wide_tables(rng, l, SW)
    na_bin = _wide_na_bin()
    lid = rng.integers(0, l, size=NW).astype(np.int32)
    ref_slot, ref_lid = ph.route_level_pallas(
        jnp.asarray(wide["bins"].T), jnp.asarray(lid),
        ref_hist.RouteTables(*[jnp.asarray(c) for c in cols]),
        jnp.asarray(na_bin), SW, l, interpret=True)
    slot, lid2, _ = hk.route_level(_t(wide["bins"].T), _t(lid),
                                   _t(np.stack(cols)), _t(na_bin), SW)
    assert slot.dtype == lid2.dtype == torch.int32
    np.testing.assert_array_equal(slot.numpy(), np.asarray(ref_slot))
    np.testing.assert_array_equal(lid2.numpy(), np.asarray(ref_lid))
    assert (lid2.numpy() >= l).any() and (slot.numpy() == SW).any()


@pytest.mark.parametrize("s", [1, SW, 40])
def test_route_level_counts_equal_reference_slots(wide, s):
    # exact: route_level's per-slot counts (which hist_q8 and hist_f32
    # take in place of their count pass) equal the bincount of the kept
    # slots ([0, S)) that route_level_pallas gives; S = 40 leaves slots
    # empty
    rng = np.random.default_rng(100 + s)
    l = 12
    cols = _wide_tables(rng, l, s)
    lid = rng.integers(0, l, size=NW).astype(np.int32)
    ref_slot, _ = ph.route_level_pallas(
        jnp.asarray(wide["bins"].T), jnp.asarray(lid),
        ref_hist.RouteTables(*[jnp.asarray(c) for c in cols]),
        jnp.asarray(_wide_na_bin()), s, l, interpret=True)
    ref_slot = np.asarray(ref_slot)
    *_, counts = hk.route_level(_t(wide["bins"].T), _t(lid),
                                _t(np.stack(cols)), _t(_wide_na_bin()), s)
    assert counts.dtype == torch.int32 and tuple(counts.shape) == (s,)
    kept = ref_slot[(ref_slot >= 0) & (ref_slot < s)]
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(kept, minlength=s))
    assert 0 < counts.sum() < NW


def test_slot_hists_take_route_counts(wide):
    # exact: handed route_level's counts, hist_q8 and hist_f32 return what
    # they return without them (the CPU's plain versions need none); counts
    # of another shape, or without a slot vector, are refused
    q = wide["quants"][False]
    bins_T = _t(wide["bins"].T)
    cols = _wide_tables(np.random.default_rng(3), 8, SW)
    lid = _t(np.arange(NW, dtype=np.int32) % 8)
    slot, _, counts = hk.route_level(bins_T, lid, _t(np.stack(cols)),
                                     _t(_wide_na_bin()), SW)
    rows = (_t(wide["g"]), _t(wide["h"]), _t(wide["c"]))
    for fn, chans in ((hk.hist_q8, (q.gq, q.hq, q.cq)), (hk.hist_f32, rows)):
        np.testing.assert_array_equal(
            fn(bins_T, *chans, slot, SW, BW, None, counts).numpy(),
            fn(bins_T, *chans, slot, SW, BW).numpy())
        with pytest.raises(ValueError):
            fn(bins_T, *chans, slot, SW, BW, None, counts[:-1].contiguous())
        with pytest.raises(ValueError):
            fn(bins_T, *chans, None, SW, BW, None, counts)


@pytest.mark.parametrize("fault", ["moved", "over", "negative"])
@pytest.mark.parametrize("kernel", ["hist_q8", "hist_f32"])
def test_slot_hists_refuse_counts_of_another_slot_vector(wide, kernel, fault):
    # counts that are not the slot vector's own (a row counted in another
    # slot, one row too many, a negative count) raise before any sum; on
    # the card the kernel asserts instead (tests/test_torch_cuda.py)
    q = wide["quants"][False]
    bins_T = _t(wide["bins"].T)
    cols = _wide_tables(np.random.default_rng(3), 8, SW)
    lid = _t(np.arange(NW, dtype=np.int32) % 8)
    slot, _, counts = hk.route_level(bins_T, lid, _t(np.stack(cols)),
                                     _t(_wide_na_bin()), SW)
    bad = counts.clone()
    full = int(torch.argmax(counts))
    if fault == "moved":
        bad[full] -= 1
        bad[(full + 1) % SW] += 1
    elif fault == "over":
        bad[full] += 1
    else:
        bad[full] = -1
    chans = ((q.gq, q.hq, q.cq) if kernel == "hist_q8" else
             (_t(wide["g"]), _t(wide["h"]), _t(wide["c"])))
    with pytest.raises(ValueError, match="kept rows of each slot"):
        getattr(hk, kernel)(bins_T, *chans, slot, SW, BW, None, bad)


def test_leaf_sums_within_hi_lo_error(wide):
    # tolerance |diff| <= 2^-15 * sum|x| per leaf and channel (bf16 hi/lo
    # on the reference side, f64 sums on the port's); counts exact
    rng = np.random.default_rng(5)
    lid = rng.integers(0, L, size=NW).astype(np.int32)
    g, h, c = wide["g"], wide["h"], wide["c"]
    ref = np.asarray(ph.leaf_sums_pallas(jnp.asarray(g), jnp.asarray(h),
                                         jnp.asarray(c), jnp.asarray(lid), L,
                                         interpret=True))
    got = hk.leaf_sums(_t(g), _t(h), _t(c), _t(lid), L).numpy()
    mass = np.zeros((3, L))
    for k, x in enumerate((g, h, c)):
        np.add.at(mass[k], lid, np.abs(x.astype(np.float64)))
    np.testing.assert_array_equal(got[2], ref[2])
    assert (np.abs(got - ref) <= 2.0 ** -15 * mass).all()


@pytest.mark.parametrize("leaves", ["skewed", "dropped"])
def test_leaf_sums_on_skewed_and_dropped_leaves(wide, leaves):
    # test_leaf_sums_within_hi_lo_error's tolerance on skewed leaf ids and
    # on ids outside [0, L), the reference's grid over chunks of 64 rows
    # (NW = 300: a ragged last chunk)
    lid = _leaf_ids(leaves, NW, L, 8)
    g, h, c = wide["g"], wide["h"], wide["c"]
    ref = np.asarray(ph.leaf_sums_pallas(jnp.asarray(g), jnp.asarray(h),
                                         jnp.asarray(c), jnp.asarray(lid), L,
                                         chunk=64, interpret=True))
    got = hk.leaf_sums(_t(g), _t(h), _t(c), _t(lid), L).numpy()
    _assert_within_hi_lo(got, ref, (g, h, c), lid)


@pytest.mark.parametrize("const_hess", [False, True])
def test_two_pass_level_and_root_exact(wide, const_hess):
    # exact: at F * B = 9 * 256 > 2048 the port's hist_routed routes, then
    # histograms (route_level + hist_q8), and hist_leaf builds the root
    # from the quantized channels, against the reference's hist_routed and
    # hist_leaf on their Pallas path (route_level_pallas + hist_pallas_q8)
    assert FW * BW > th.ACC_ROWS_MAX
    quant = wide["quants"][const_hess]
    rng = np.random.default_rng(9)
    l = 8
    cols = _wide_tables(rng, l, SW)
    na_bin = _wide_na_bin()
    lid = rng.integers(0, l, size=NW).astype(np.int32)
    ref_q = ref_hist.QuantChannels(
        jnp.asarray(quant.gq.numpy()),
        None if quant.hq is None else jnp.asarray(quant.hq.numpy()),
        jnp.asarray(quant.cq.numpy()), jnp.float32(quant.scale_g.item()),
        jnp.float32(quant.scale_h.item()))
    bins = jnp.asarray(wide["bins"])
    dummy = jnp.zeros(NW, jnp.float32)
    ref_h, ref_lid = ref_hist.hist_routed(
        bins, dummy, dummy, dummy, jnp.asarray(lid),
        ref_hist.RouteTables(*[jnp.asarray(c) for c in cols]),
        jnp.asarray(na_bin), SW, BW, impl="pallas", quant=ref_q)
    hist, lid2 = th.hist_routed(_t(wide["bins"].T), _t(lid),
                                th.RouteTables(*[_t(c) for c in cols]),
                                _t(na_bin), SW, BW, quant)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(lid2.numpy(), np.asarray(ref_lid))
    ref_root = ref_hist.hist_leaf(bins, dummy, dummy, dummy, BW,
                                  impl="pallas", quant=ref_q)
    root = th.hist_leaf(_t(wide["bins"].T), BW, quant)
    np.testing.assert_array_equal(root.numpy(), np.asarray(ref_root))


# ---- the unquantized histogram (hist_f32) against hist_pallas ----

def _f32_case(b, s, grid):
    """Rows over [0, B) on 9 features (bins 0 and B - 1 included), 0/1 bag,
    gradients and hessians either on a 1/8 grid (|g| < 4) or Gaussian and
    uniform, and a slot vector with dropped slots (-1 and >= S)."""
    rng = np.random.default_rng(31 + b + s)
    bins = rng.integers(0, b, size=(NW, FW)).astype(np.uint8)
    bins[:3] = 0
    bins[3:6] = b - 1
    bag = (rng.random(NW) < 0.85).astype(np.float32)
    g = rng.normal(size=NW).astype(np.float32)
    h = rng.random(NW).astype(np.float32)
    if grid:
        g = (np.clip(np.round(g * 8), -31, 31) / 8).astype(np.float32)
        h = (np.round(h * 8) / 8).astype(np.float32)
    slot = rng.integers(0, s + 2, size=NW).astype(np.int32)
    slot[::13] = -1
    return bins, g * bag, h * bag, bag, slot


def _f32_mass(bins, g, h, c, slot, s, b):
    """f64 [S, 3, F, B] sums of |g|, |h| and c: each cell's absolute mass."""
    return hk.hist_f32(_t(bins.T), _t(np.abs(g)), _t(np.abs(h)), _t(c),
                       None if slot is None else _t(slot), s, b).numpy()


def _assert_f32_close(got, ref, mass, grid):
    if grid:
        np.testing.assert_array_equal(got, ref)
        return
    np.testing.assert_array_equal(got[..., 2, :, :], ref[..., 2, :, :])
    assert (np.abs(got.astype(np.float64) - ref) <= 2.0 ** -15 * mass).all()


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("b", [64, BW])
@pytest.mark.parametrize("s", [1, SW])
def test_hist_f32_matches_hist_pallas(s, b, grid):
    # exact on 1/8-grid rows; Gaussian rows within 2^-15 of the cell's
    # absolute mass (hi/lo on the reference's side), counts exact. S = 1
    # is held against hist_leaf_pallas (every row, no slot vector) and
    # hist_pallas over a slot vector that drops rows; S > 1 against
    # hist_pallas with dropped slots
    bins, g, h, c, slot = _f32_case(b, s, grid)
    jb, jg, jh, jc = (jnp.asarray(a) for a in (bins.T, g, h, c))
    got = hk.hist_f32(_t(bins.T), _t(g), _t(h), _t(c), _t(slot), s, b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, 3, FW, b)
    ref = np.asarray(ph.hist_pallas(jb, jg, jh, jc, jnp.asarray(slot), s, b,
                                    interpret=True))
    _assert_f32_close(got.numpy(), ref, _f32_mass(bins, g, h, c, slot, s, b),
                      grid)
    if s == 1:
        root = hk.hist_f32(_t(bins.T), _t(g), _t(h), _t(c), None, 1, b)[0]
        ref0 = np.asarray(ph.hist_leaf_pallas(jb, jg, jh, jc, b,
                                              interpret=True))
        _assert_f32_close(root.numpy(), ref0,
                          _f32_mass(bins, g, h, c, None, 1, b)[0], grid)


@pytest.mark.parametrize("b", [64, BW])
def test_unquantized_level_and_root_exact(b):
    # exact on 1/8-grid rows: the port's hist_routed without quantized
    # channels (route_level, then hist_f32, at every F * B) and hist_leaf
    # from f32 rows against the reference's on its Pallas path
    # (route_level_pallas + hist_pallas, hist_leaf_pallas)
    bins, g, h, c, _ = _f32_case(b, SW, grid=True)
    rng = np.random.default_rng(b)
    l = 8
    feat, thr, dleft, new_leaf, slot_left, slot_right = _wide_tables(rng, l,
                                                                     SW)
    thr = thr % b
    cols = (feat, thr, dleft, new_leaf, slot_left, slot_right)
    na_bin = _wide_na_bin()
    na_bin[4] = b - 1                  # a missing bin inside [0, B)
    lid = rng.integers(0, l, size=NW).astype(np.int32)
    jb = jnp.asarray(bins)
    jg, jh, jc = (jnp.asarray(a) for a in (g, h, c))
    ref_h, ref_lid = ref_hist.hist_routed(
        jb, jg, jh, jc, jnp.asarray(lid),
        ref_hist.RouteTables(*[jnp.asarray(x) for x in cols]),
        jnp.asarray(na_bin), SW, b, impl="pallas")
    rows = (_t(g), _t(h), _t(c))
    hist, lid2 = th.hist_routed(_t(bins.T), _t(lid),
                                th.RouteTables(*[_t(x) for x in cols]),
                                _t(na_bin), SW, b, rows=rows)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(lid2.numpy(), np.asarray(ref_lid))
    ref_root = ref_hist.hist_leaf(jb, jg, jh, jc, b, impl="pallas")
    root = th.hist_leaf(_t(bins.T), b, rows=rows)
    np.testing.assert_array_equal(root.numpy(), np.asarray(ref_root))


def test_take_small_exact_with_out_of_range():
    # exact, out-of-range indices (negative, == L, > L) give 0.0
    rng = np.random.default_rng(3)
    table = rng.normal(size=L).astype(np.float32)
    idx = rng.integers(-3, L + 4, size=N).astype(np.int32)
    ref = np.asarray(ph.take_small_pallas(jnp.asarray(table),
                                          jnp.asarray(idx), interpret=True))
    got = hk.take_small(_t(table), _t(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[(idx < 0) | (idx >= L)] == 0.0).all()


@pytest.mark.parametrize("n,offset", [(N + 1, 0), (N + 2, 0), (N + 3, 0),
                                      (N, 1), (N + 1, 2), (N, 3), (3, 1)])
def test_take_small_tails_and_offset_views(n, offset):
    # exact: N % 4 != 0 rows, and idx as a view that starts 1-3 elements
    # into its storage (on the card, not on 16 bytes: the kernel's scalar
    # path), out-of-range indices giving 0.0
    rng = np.random.default_rng(7 * n + offset)
    table = rng.normal(size=L).astype(np.float32)
    base = rng.integers(-3, L + 4, size=n + offset).astype(np.int32)
    view = _t(base)[offset:]
    assert view.is_contiguous() and view.storage_offset() == offset
    ref = np.asarray(ph.take_small_pallas(jnp.asarray(table),
                                          jnp.asarray(base[offset:]),
                                          interpret=True))
    got = hk.take_small(_t(table), view).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cpu_wrappers_count_no_launches(rows, wide):
    hk.reset_launches()
    hk.take_small(_t(np.ones(L, np.float32)), _t(rows["lid"]))
    q = wide["quants"][False]
    bins_T = _t(wide["bins"].T)
    hk.hist_q8(bins_T, q.gq, q.hq, q.cq, None, 1, BW)
    cols = _wide_tables(np.random.default_rng(0), 8, SW)
    hk.route_level(bins_T, _t(np.zeros(NW, np.int32)), _t(np.stack(cols)),
                   _t(_wide_na_bin()), SW)
    hk.leaf_sums(_t(wide["g"]), _t(wide["h"]), _t(wide["c"]),
                 _t(np.zeros(NW, np.int32)), L)
    hk.hist_f32(bins_T, _t(wide["g"]), _t(wide["h"]), _t(wide["c"]),
                _t(wide["slot"]), SW, BW)
    assert hk.LAUNCHES == {k: 0 for k in hk.KERNELS}


# ---- the plan of the slot histograms (hist_q8, hist_f32) ----
# The CUDA kernels (csrc/slot_hist.cuh) group the kept rows by slot and cut
# the slot-ordered list into ranges, one per block; the card tests hold
# their sums against the plain versions. Here, without a card: every kept
# row falls in exactly one segment per feature group, in its own slot's
# segment; each block's shared table fits the budget; a slot holding most
# rows spreads over many blocks; and the plain compaction keeps each kept
# row once, grouped by slot, dropping slots < 0 and >= S.

PLAN_SMS = 132       # an H100's streaming multiprocessors
PLAN_N = 40_000


def _plan_slots(s, kind, seed):
    """[PLAN_N] i32 slots: uniform over [-1, S + 2) (dropped rows both
    sides), skewed (about half the kept rows in slot 0 when S > 1), or
    sparse (most slots empty, a fifth of the rows kept)."""
    rng = np.random.default_rng(seed)
    slot = rng.integers(-1, s + 2, size=PLAN_N)
    if kind == "skewed":
        slot[rng.random(PLAN_N) < 0.4] = 0
    elif kind == "sparse":
        used = rng.choice(s, size=min(s, 3), replace=False)
        slot = np.where(rng.random(PLAN_N) < 0.2,
                        rng.choice(used, size=PLAN_N), s)
    return torch.from_numpy(slot.astype(np.int32))


def _check_tiles(plan, f, slot, s):
    off, rows = hk.slot_compact_plain(slot, s)
    counts = (off[1:] - off[:-1]).tolist()
    tiles = hk.slot_hist_tiles(plan, f, counts)
    kept = int(off[-1])
    per = max(plan.min_rows, -(-kept // plan.blocks))
    groups = -(-f // plan.fg)
    sl_of = slot.numpy()[rows.numpy()]
    for grp in range(groups):
        segs = [t for t in tiles if t[0] == grp]
        hits = np.zeros(kept, np.int64)
        for _, blk, sl, a, e in segs:
            assert 0 <= blk < plan.blocks and blk * per <= a < e
            assert e <= min(kept, (blk + 1) * per)
            assert off[sl] <= a and e <= off[sl + 1]
            assert (sl_of[a:e] == sl).all()
            hits[a:e] += 1
        assert (hits == 1).all()
    assert {t[0] for t in tiles} == (set(range(groups)) if kept else set())
    return tiles, counts


@pytest.mark.parametrize("s", [1, 2, 127, 255])
@pytest.mark.parametrize("nch", [2, 3])
@pytest.mark.parametrize("b", [2, 64, 256])
@pytest.mark.parametrize("f", [1, 28, 100])
def test_plan_covers_every_kept_row_once(f, b, nch, s):
    plan = hk.slot_hist_plan(f, PLAN_N, nch, b, PLAN_SMS)
    assert plan.smem == nch * plan.fg * b * 4 <= hk.SMEM_BUDGET
    assert 1 <= plan.fg <= f and -(-f // plan.fg) * plan.fg - f < plan.fg
    assert plan.pass_blocks <= 8 * PLAN_SMS
    for i, kind in enumerate(("uniform", "skewed", "sparse")):
        tiles, counts = _check_tiles(plan, f, _plan_slots(s, kind, 7 * s + i),
                                     s)
        if kind == "skewed" and s > 1:
            # the big slot spreads over as many blocks as its share allows
            big = {t[1] for t in tiles if t[0] == 0 and t[2] == 0}
            per = max(plan.min_rows, -(-sum(counts) // plan.blocks))
            assert len(big) >= counts[0] // per
    # the root pass: every row, in natural order, slot 0
    root = hk.slot_hist_tiles(plan, f, [PLAN_N])
    assert {t[2] for t in root} == {0}
    assert sum(t[4] - t[3] for t in root) == PLAN_N * -(-f // plan.fg)


def test_plan_at_the_main_path_shapes():
    # F = 28, B = 256 (max_bin=255): one slot's whole table a block, two
    # blocks an SM, 528 blocks; F = 100 splits into two even feature groups
    # of 150 KB tables, one block an SM, 132 blocks a group
    for nch, smem in ((3, 86_016), (2, 57_344)):
        plan = hk.slot_hist_plan(28, 10_500_000, nch, 256, PLAN_SMS)
        assert (plan.fg, plan.blocks, plan.min_rows, plan.smem) == \
            (28, 528, 1024, smem)
    plan = hk.slot_hist_plan(100, 10_500_000, 3, 256, PLAN_SMS)
    assert (plan.fg, plan.blocks) == (50, 132)
    # a lossguide pass keeping 0.5% of 10.5M rows takes 52 blocks
    tiles = hk.slot_hist_tiles(hk.slot_hist_plan(28, 10_500_000, 3, 256,
                                                 PLAN_SMS), 28, [52_500])
    assert len({t[1] for t in tiles}) == 52


@pytest.mark.parametrize("nch", [2, 3])
@pytest.mark.parametrize("b", [64, 256])
def test_plan_blocks_an_sm_at_both_bin_widths(b, nch):
    # B = 64 (the fused level pass; a 21,504 B or 14,336 B table) and
    # B = 256 (86,016 B or 57,344 B) both run two blocks an SM, their
    # tables within the budget; every kept row of a first
    # level (S = 1), of a level that keeps none and of a skewed S = 127
    # falls in exactly one segment of its slot
    plan = hk.slot_hist_plan(28, PLAN_N, nch, b, PLAN_SMS)
    assert plan.blocks == 2 * PLAN_SMS * 2 and plan.fg == 28
    assert 2 * plan.smem <= hk.SMEM_BUDGET
    assert plan.smem == nch * 28 * b * 4
    first = torch.from_numpy(np.where(
        np.random.default_rng(b).random(PLAN_N) < 0.5, 0, 1).astype(np.int32))
    for slot, s in ((first, 1), (torch.full((PLAN_N,), 127, dtype=torch.int32),
                                 127), (_plan_slots(127, "skewed", b), 127)):
        tiles, counts = _check_tiles(plan, 28, slot, s)
        per = max(plan.min_rows, -(-sum(counts) // plan.blocks))
        assert len({t[1] for t in tiles}) == -(-sum(counts) // per)


def test_plan_with_no_kept_rows():
    plan = hk.slot_hist_plan(28, PLAN_N, 3, 256, PLAN_SMS)
    assert hk.slot_hist_tiles(plan, 28, [0] * 5) == []
    slot = torch.full((PLAN_N,), 7, dtype=torch.int32)
    off, rows = hk.slot_compact_plain(slot, 5)
    assert off.tolist() == [0] * 6 and rows.numel() == 0


@pytest.mark.parametrize("s", [1, 5, 255])
def test_compaction_plain(s):
    # offsets are the per-slot counts' prefix sums; each kept row appears
    # once, grouped by slot; slots < 0 and >= S are dropped
    slot = _plan_slots(s, "uniform", s)
    off, rows = hk.slot_compact_plain(slot, s)
    sl = slot.numpy().astype(np.int64)
    keep = (sl >= 0) & (sl < s)
    np.testing.assert_array_equal(np.diff(off.numpy()),
                                  np.bincount(sl[keep], minlength=s))
    assert off[0] == 0 and off[-1] == keep.sum() == rows.numel()
    np.testing.assert_array_equal(np.sort(rows.numpy()),
                                  np.nonzero(keep)[0])
    for k in range(s):
        assert (sl[rows[off[k]:off[k + 1]].numpy()] == k).all()


# ---- the plan and the packed root histogram of grad_quant_hist0 ----
# csrc/grad_quant_hist0.cu adds each kept row's g and count into one packed
# 32-bit shared cell a (feature, bin): the count modulo 2^12 and
# sum(gq + 127) in the fields GQ_FIELDS, GQ_STEP_ROWS rows a block step,
# after which the block drains its cells. Here, without a card: the plan
# covers every row once, the fields hold a step's worst case without
# ambiguity, and the packed sums over the steps unpack to the plain
# version's histogram.


@pytest.mark.parametrize("n", [0, 1, 5, 4096, 1_000_003, 10_500_000,
                               300_000_001])
def test_grad_quant_plan_covers_every_row_once(n):
    plan = hk.grad_quant_plan(n, PLAN_SMS)
    nq = -(-n // 4)
    assert plan.blocks * plan.quads >= nq
    assert (plan.blocks - 1) * plan.quads < max(nq, 1)    # no empty block
    assert plan.quads >= 256                 # at least 1024 rows a block
    assert 1 <= plan.max_grid <= 8 * PLAN_SMS
    if n == 10_500_000:   # two 1024-thread blocks an SM, the card twice
        assert plan.blocks == 4 * PLAN_SMS


def _packed_word(gq):
    """The packed (g, count) word of one kept row (int64 arrays)."""
    f = {nm: lo for nm, lo, _ in hk.GQ_FIELDS}
    return (1 << f["count"]) + ((gq + 127) << f["g"])


def _unpack(v):
    """(g sum, count) of packed cells holding at most GQ_STEP_ROWS rows: a
    count field of 0 in a non-empty cell is 2^12 rows (the kernel's
    unpack)."""
    (_, lo_c, bits_c), (_, lo_g, _) = hk.GQ_FIELDS
    c = (v >> lo_c) & ((1 << bits_c) - 1)
    c = np.where((v != 0) & (c == 0), 1 << bits_c, c)
    return ((v - c) >> lo_g) - 127 * c, c


@pytest.mark.parametrize("gq", [127, -127, 0, 5])
@pytest.mark.parametrize("rows", [1, hk.GQ_STEP_ROWS - 1, hk.GQ_STEP_ROWS])
def test_grad_quant_packed_cell_worst_case(rows, gq):
    # exact: up to a block step's rows (GQ_STEP_ROWS, the most a cell takes
    # between drains, whether the channels are 2 or 3: h keeps its own
    # int32 cell), all in one cell at |gq| = 127 (or less), fit the 32-bit
    # word and unpack to the channel sums
    (_, lo_c, bits_c), (_, lo_g, bits_g) = hk.GQ_FIELDS
    assert lo_c == 0 and lo_g == bits_c and lo_g + bits_g == 32
    assert hk.GQ_STEP_ROWS == 1 << bits_c
    assert 254 * hk.GQ_STEP_ROWS < 1 << bits_g
    total = rows * int(_packed_word(np.int64(gq)))
    assert total < 1 << 32
    g, c = _unpack(np.int64(total))
    assert (int(g), int(c)) == (rows * gq, rows)


@pytest.mark.parametrize("const_hess", [False, True])
def test_grad_quant_packed_sums_equal_plain(rows, const_hess):
    # exact: the kernel's arithmetic replayed with numpy over steps of 16
    # rows: each kept row (cq = 1; rows with cq = 0 quantize to 0 and are
    # skipped) adds one packed (g, count) word into its (feature, bin)
    # cell and its hq into an int32 h cell; each step's cells unpack, and
    # the sums equal the plain version's root histogram
    spec = ("l2",) if const_hess else LOGLOSS
    aux = rows["label"] if const_hess else rows["label_pos"]
    gq, hq, cq, _, hist = hk.grad_quant_hist0_plain(
        _t(rows["bins"].T), _t(rows["score"]), _t(aux), _t(rows["bag"]),
        SEED, spec, B, const_hess)
    gq, cq = gq.numpy().astype(np.int64), cq.numpy().astype(bool)
    hq = np.zeros_like(gq) if hq is None else hq.numpy().astype(np.int64)
    assert not gq[~cq].any() and not hq[~cq].any()
    word = _packed_word(gq)
    got = np.zeros((3, F, B), np.int64)
    for r0 in range(0, N, 16):
        cell = np.zeros((F, B), np.int64)
        for r in range(r0, min(N, r0 + 16)):
            if cq[r]:
                cell[np.arange(F), rows["bins"][r]] += word[r]
                got[1, np.arange(F), rows["bins"][r]] += hq[r]
        assert (cell < 1 << 32).all()
        g, c = _unpack(cell)
        got[0] += g
        got[2] += c
    want = hist.numpy()
    np.testing.assert_array_equal(got[[0, 2]] if const_hess else got, want)
