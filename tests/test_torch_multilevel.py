"""B2's multi-level replay in the PyTorch/CUDA port (lightgbm_tpu_torch)
against the JAX reference (lightgbm_tpu): ``hist_routed_fused_multi``, the
counterpart of ``ph.hist_routed_fused_multi_q8`` at D > 1, which routes
every row through D known levels' route tables in one call and builds each
level's slot histogram in its own band.

At the reference's own size (tests/test_megapass.py: N = 1000, F = 7,
B = 16, L = 8, S = 4, three random table sets from default_rng(1), (2),
(3)), the port's plain version, dequantized by ``ops/histogram.py``, equals
the reference's kernel in interpret mode bit for bit, histograms and final
leaf ids, with 3 channels, with 2 (const-hessian elision) and with one
level's tables categorical; and the one call equals D sequential
``hist_routed_fused`` calls of the port. The replay of a live tree's
levels, each with its own slot width, equals the grower's own level
passes (the count-sized passes of its sharded loop on one shard: the
serial grower runs every pass at the schedule's width).
``scripts/torch_profile_level.py`` reports bit-identity against
the sequential passes on the CPU. The kernel itself needs the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import histogram as hg
from lightgbm_tpu.ops import pallas_hist as ph
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models import gbdt as gbdt_mod
from lightgbm_tpu_torch.ops import grow_depthwise as gd
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops.grow import RowShard, ShardedRows

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F, B, L, S = 1000, 7, 16, 8, 4
SEED = 12345


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    bins = rng.integers(0, B, size=(N, F)).astype(np.uint8)
    score = rng.normal(size=N).astype(np.float32)
    rng.normal(size=N)                       # test_megapass's L2 label
    label_pos = (rng.random(N) < 0.5).astype(np.float32)
    bag = (rng.random(N) < 0.8).astype(np.float32)
    lid = rng.integers(0, L, size=N).astype(np.int32)
    t = 2.0 * label_pos - 1.0
    resp = 1.0 / (1.0 + np.exp(t * score))
    grad, hess = -t * resp, resp * (1.0 - resp)
    c = (bag > 0).astype(np.float32)
    return {"bins": bins, "lid": lid, "na_bin": np.full(F, -1, np.int32),
            "g": (grad * bag).astype(np.float32),
            "h": (hess * bag).astype(np.float32), "c": c}


def _quant(rows, const_hess):
    """The reference's quantized channels, and the same int8 rows and
    scales as the port's QuantChannels."""
    q = hg.make_quant(jnp.asarray(rows["g"]), jnp.asarray(rows["h"]),
                      jnp.asarray(rows["c"]), SEED, const_hess=const_hess)

    def t(a):
        return torch.from_numpy(np.array(a))
    port = H.QuantChannels(t(q.gq), None if q.hq is None else t(q.hq),
                           t(q.cq), t(q.scale_g), t(q.scale_h))
    return q, port


def _tables(cat_level=None):
    """test_megapass's three random table sets, each [L] row drawn in its
    order; at ``cat_level`` an is_cat row and a membership matrix follow
    (drawn from the same generator)."""
    ref, port = [], []
    for d, key in enumerate((1, 2, 3)):
        r = np.random.default_rng(key)
        cols = [r.integers(lo, hi, size=L).astype(np.int32)
                for lo, hi in ((0, F), (1, B - 1), (0, 2), (0, L), (0, S),
                               (0, S))]
        is_cat = member = None
        if d == cat_level:
            is_cat = r.integers(0, 2, size=L).astype(np.int32)
            member = r.random((L, B)) < 0.5
        ref.append(hg.RouteTables(
            *[jnp.asarray(c) for c in cols],
            is_cat=None if is_cat is None else jnp.asarray(is_cat),
            member=None if member is None else jnp.asarray(member)))
        port.append(H.RouteTables(
            *[torch.from_numpy(c) for c in cols],
            is_cat=None if is_cat is None else torch.from_numpy(is_cat),
            member=None if member is None else torch.from_numpy(member)))
    return ref, port


def _reference(rows, q, tabs):
    hq = q.cq if q.hq is None else q.hq
    hist, lid = ph.hist_routed_fused_multi_q8(
        jnp.asarray(rows["bins"].T), q.gq, hq, q.cq,
        jnp.asarray(rows["lid"]), tuple(tabs), jnp.asarray(rows["na_bin"]),
        S, B, q.scale_g, q.scale_h, L, const_hess=q.hq is None,
        interpret=True)
    return np.asarray(hist), np.asarray(lid)


@pytest.mark.parametrize("case", ["3ch", "2ch", "categorical"])
def test_plain_equals_reference_interpret(rows, case):
    """Histograms [D, S, 3, F, B] (one scale pair for every band) and the
    final leaf ids, bit for bit."""
    q, port_q = _quant(rows, const_hess=case == "2ch")
    ref_tabs, port_tabs = _tables(1 if case == "categorical" else None)
    want_hist, want_lid = _reference(rows, q, ref_tabs)
    bins_T = torch.from_numpy(np.ascontiguousarray(rows["bins"].T))
    hist, lid = H.hist_routed_multi(
        bins_T, torch.from_numpy(rows["lid"]), port_tabs,
        torch.from_numpy(rows["na_bin"]), S, B, port_q)
    assert hist.shape == (3, S, 3, F, B) == want_hist.shape
    assert np.array_equal(lid.numpy(), want_lid)
    assert np.array_equal(hist.numpy().view(np.int32),
                          want_hist.view(np.int32))
    if case == "categorical":
        # the categorical level routed some rows by membership
        assert port_tabs[1].is_cat.any()


@pytest.mark.parametrize("case", ["3ch", "2ch", "categorical"])
def test_one_call_equals_sequential_level_passes(rows, case):
    """The multi-level call (the wrapper on CPU tensors) equals three
    sequential hist_routed_fused calls of the port, int32 sums and leaf
    ids bit for bit."""
    _, port_q = _quant(rows, const_hess=case == "2ch")
    _, tabs = _tables(0 if case == "categorical" else None)
    bins_T = torch.from_numpy(np.ascontiguousarray(rows["bins"].T))
    na = torch.from_numpy(rows["na_bin"])
    lid0 = torch.from_numpy(rows["lid"])
    args = (port_q.gq, port_q.hq, port_q.cq)
    multi, lid_m = hk.hist_routed_fused_multi(
        bins_T, *args, lid0, [t.stacked() for t in tabs], na, S, B,
        catbits=[t.bitset() for t in tabs])
    lid = lid0
    for d, t in enumerate(tabs):
        h, lid = hk.hist_routed_fused(bins_T, *args, lid, t.stacked(), na,
                                      S, B, catbits=t.bitset())
        assert torch.equal(multi[d], h), d
    assert torch.equal(lid_m, lid)


def test_replay_of_a_live_tree_with_its_own_slot_widths(rows):
    """The route tables of a grown tree's first three level passes,
    recorded from the grower's count-sized passes (its sharded loop on one
    shard), replayed in one call from the root's leaf
    ids with each level's own slot width: each band's first S_d slots
    equal the live pass's histogram, the rest are zero (a level drops the
    slots past its own width: the larger children's sentinel), and the
    final leaf ids equal the third pass's."""
    X = rows["bins"].astype(np.float64) + 0.5
    y = rows["g"].astype(np.float64)
    p = {"objective": "regression", "num_leaves": 31, "max_bin": B,
         "min_data_in_leaf": 5, "verbosity": -1, "device_type": "cpu"}
    ds = lt.Dataset(X, label=y, params=p).construct()
    live = []
    seen = {}
    orig_routed, orig_front = hk.hist_routed_fused, hk.grad_quant_hist0

    def front(*a, **kw):
        out = orig_front(*a, **kw)
        seen.setdefault("quant", out)
        return out

    def routed(bins_T, gq, hq, cq, leaf_id, tables, na_bin, num_slots,
               num_bins, bins=None, catbits=None):
        out = orig_routed(bins_T, gq, hq, cq, leaf_id, tables, na_bin,
                          num_slots, num_bins, bins, catbits)
        live.append((leaf_id.clone(), tables.clone(), num_slots, out))
        seen["num_bins"] = num_bins
        return out
    def count_sized(bins_T, g, h, c, num_bins, na_bin, fmask, gp, qseed=0,
                    fused=None, bins=None, **kw):
        tree, lids, passes = gd.grow_tree_depthwise(
            bins_T, None, None, None, num_bins, na_bin, fmask, gp,
            qseed=qseed, shards=ShardedRows([RowShard(bins_T, bins, g, h, c,
                                                      fused)]))
        return tree, lids[0], passes
    mp = pytest.MonkeyPatch()
    mp.setattr(hk, "hist_routed_fused", routed)
    mp.setattr(hk, "grad_quant_hist0", front)
    mp.setattr(gbdt_mod, "grow_tree_depthwise", count_sized)
    try:
        bst = lt.Booster(params=p, train_set=ds)
        bst.update()
    finally:
        mp.undo()
    assert len(live) >= 3 and bool((live[0][0] == 0).all())
    gq, hq, cq = seen["quant"][:3]
    widths = [s for _, _, s, _ in live[:3]]
    hist, lid = hk.hist_routed_fused_multi(
        ds.bins_T, gq, hq, cq, live[0][0], [t for _, t, _, _ in live[:3]],
        ds.na_bin_dev, widths, seen["num_bins"], bins=ds.bins)
    assert hist.shape[1] == max(widths) and len(set(widths)) > 1
    for d, (_, _, s, (h, _)) in enumerate(live[:3]):
        assert torch.equal(hist[d, :s], h), d
        assert not hist[d, s:].any()
    assert torch.equal(lid, live[2][3][1])


def test_wrapper_checks_levels():
    bins_T = torch.zeros((F, 10), dtype=torch.uint8)
    i8 = torch.zeros(10, dtype=torch.int8)
    lid = torch.zeros(10, dtype=torch.int32)
    tab = torch.zeros((6, L), dtype=torch.int32)
    na = torch.zeros(F, dtype=torch.int32)
    with pytest.raises(ValueError, match="levels"):
        hk.hist_routed_fused_multi(bins_T, i8, None, i8, lid, [], na, S, B)
    with pytest.raises(ValueError, match="levels"):
        hk.hist_routed_fused_multi(bins_T, i8, None, i8, lid,
                                   [tab] * (hk.MAX_LEVELS + 1), na, S, B)
    with pytest.raises(ValueError, match="slot widths"):
        hk.hist_routed_fused_multi(bins_T, i8, None, i8, lid, [tab, tab], na,
                                   [S], B)
    with pytest.raises(ValueError, match="leaf counts"):
        hk.hist_routed_fused_multi(bins_T, i8, None, i8, lid,
                                   [tab, tab[:, :3].contiguous()], na, S, B)


def test_profile_level_script_bit_identical_on_cpu():
    """scripts/torch_profile_level.py --json at --rows 2000 --leaves 8 on
    the CPU's plain versions: levels 1..D in two launches of the
    wrappers, bit-identical to D sequential level passes."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_profile_level.py"),
         "--json", "--rows", "2000", "--leaves", "8", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    sh = out["shallow"]
    assert sh["bit_identical_vs_sequential"] is True
    # the plain versions launch no kernel
    assert sh["cuda_launches"] == 0 and out["device"] == "cpu"
    assert sh["levels"] == [0, 1, 2, 3] and sh["slot_width"] == 4
    assert sh["megapass_ms"] is None and sh["sequential_levels_ms"] is None
    assert out["rows"] == 2000 and out["num_leaves"] == 8
