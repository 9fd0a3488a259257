"""Kernel-level parity of the PyTorch/CUDA port (lightgbm_tpu_torch) against
the JAX reference (lightgbm_tpu), on the CPU.

The reference runs its Pallas kernels in interpret mode, as
tests/test_hist_packed.py does; the port runs each kernel wrapper on CPU
tensors, i.e. through the kernel's plain PyTorch version. Inputs are made
from a seed with numpy and handed to both as the same arrays.

Tolerances (each stated where it is asserted):
- exact: the dither, the L2 quantized channels, scales and root histogram,
  the level pass (histogram and new leaf ids, 2 and 3 channels, packed
  lattice on and off), the slot histogram over a slot vector (hist_q8), the
  level routing (route_level), the two-pass level and the unfused root
  histogram at F * B > 2048, and take_small; integer sums make them
  order-free;
- logloss front: torch.exp and XLA's expf differ by at most 1 ulp, which
  moves g by at most 2 ulp; the test measures the gap and bounds the share
  of quantized rows that move by one step;
- leaf sums (leaf_sums_grad, leaf_sums): the reference sums bf16 hi/lo
  halves (16 significant bits per row), the port sums the f32 rows in f64:
  |diff| <= 2^-15 * sum|x|, counts exact;
- the f32 slot histogram (hist_f32) and the unquantized root and level
  passes: exact on gradients and hessians on a 1/8 grid (the hi/lo split
  keeps them whole and every partial sum is representable), else the hi/lo
  error against the port's f64 sums: |diff| <= 2^-15 * the cell's sum|x|,
  counts exact;
- the plan of the slot histograms (hist_q8, hist_f32) and their plain
  compaction: every kept row in exactly one segment of its own slot per
  feature group, each block's table within the shared-memory budget.

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
    slot, lid2 = hk.route_level(_t(wide["bins"].T), _t(lid),
                                _t(np.stack(cols)), _t(na_bin), SW)
    assert slot.dtype == lid2.dtype == torch.int32
    np.testing.assert_array_equal(slot.numpy(), np.asarray(ref_slot))
    np.testing.assert_array_equal(lid2.numpy(), np.asarray(ref_lid))
    assert (lid2.numpy() >= l).any() and (slot.numpy() == SW).any()


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
