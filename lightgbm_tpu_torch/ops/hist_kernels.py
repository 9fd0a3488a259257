"""The training path's Hopper kernels: wrappers, plain versions, counts.

Each TPU kernel of ``lightgbm_tpu/ops/pallas_hist.py`` has a hand-written
CUDA counterpart in ``lightgbm_tpu_torch/csrc/`` and a plain PyTorch
version of the same function here:

====================  =============================================  ====================
wrapper               TPU kernel replaced                            CUDA source
====================  =============================================  ====================
grad_quant_hist0      grad_quant_hist0_pallas (:918)                 grad_quant_hist0.cu
hist_routed_fused     hist_routed_fused_q8 (:676), D = 1             hist_routed_fused.cu
leaf_sums_grad        leaf_sums_grad_pallas (:1036)                  leaf_sums_grad.cu
take_small            take_small_pallas (:1213)                      take_small.cu
hist_q8               hist_pallas_q8 (:372)                          hist_q8.cu
route_level           route_level_pallas (:1138), numerical          route_level.cu
leaf_sums             leaf_sums_pallas (:718)                        leaf_sums.cu
hist_f32              hist_pallas (:114), hist_leaf_pallas (:175)    hist_f32.cu
====================  =============================================  ====================

The first four carry the fused quantized path (F * B <= 2048);
``hist_q8``, ``route_level`` and ``leaf_sums`` carry the unfused one (the
root pass, the two-pass level, where route_level hands hist_q8 its per-slot
counts, and leaf renewal from materialized rows),
which wider data takes, such as the default max_bin=255 (B = 256) on 28
features. ``hist_f32`` carries unquantized training: the root and, after
``route_level``, every level of the depthwise grower, and the root and the
smaller child of every split of the leaf-wise (lossguide) grower.

A wrapper checks device, dtype, shape and contiguity, allocates its outputs,
and then launches the CUDA kernel when its tensors lie on a CUDA device, or
runs the plain version when they lie on the CPU. A CUDA tensor never falls
back to the plain version: the kernel launches or the wrapper raises.
``LAUNCHES`` counts kernel launches, one per wrapper call on the CUDA path
and nowhere else. A call can issue several CUDA launches: grad_quant_hist0
two (max, quantize + histogram); hist_q8 and hist_f32 four with a slot
vector over S > 1 slots (count, scan, scatter, histogram;
``csrc/slot_hist.cuh``), three when handed route_level's per-slot counts
(as the two-pass level hands them), two over one slot (scatter, histogram)
and one without a slot vector; hist_routed_fused four over S > 1 slots
(route and count, scan, scatter, histogram) and three over one;
leaf_sums_grad and leaf_sums two (rows into warp tables, then a final sum
that writes the f32 output; ``csrc/leaf_sums.cuh``).

The quantized histograms come back as int32 channel sums ([S, nch, F, B],
nch = 3 for (g, h, count) or 2 for (g, count) under const-hessian elision);
``ops/histogram.py`` dequantizes them. Integer sums make every accumulation
order exact, so kernel and plain version agree bit for bit on every output
except the f64 sums of ``leaf_sums_grad`` and ``leaf_sums``, whose order
differs from the plain version's below f64 resolution before the final f32
rounding (fixed for a given grid: two calls give the same bits), and the
f32 sums of ``hist_f32``, whose plain version sums in f64 and rounds once
(counts, and values on a coarse grid, are exact in any order).
"""
from __future__ import annotations

import bisect
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import cuda_lib

KERNELS = ("grad_quant_hist0", "hist_routed_fused", "leaf_sums_grad",
           "take_small", "hist_q8", "route_level", "leaf_sums", "hist_f32")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

# shared-memory budget of one block's private histogram (the H100 allows
# 227 KB a block; the rest is headroom for the runtime's reservation);
# csrc/lgbt_common.cuh kSmemBudget is the same number
SMEM_BUDGET = 200 * 1024
# warps a leaf-sum block at most (csrc/leaf_sums.cuh kLeafWarps)
LEAF_WARPS = 16


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Sequence[int]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    """The current stream's handle. torch's raw query builds no
    torch.cuda.Stream object: 0.12 us a call against 4.06 for
    current_stream(dev).cuda_stream on an H100 host
    (scripts/torch_take_small_split.py)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


@functools.lru_cache(maxsize=None)
def _num_sms(dev: torch.device) -> int:
    """SMs of the card, read once a device (a 4 us query each launch)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def spec_args(spec) -> Tuple[int, float, float, float, float]:
    """(kind, sigmoid, sigmoid*sigmoid, lw_pos, lw_neg) for the C entries.

    ``spec`` is an objective's fused_grad_spec tuple: ("l2",) or
    ("logloss", sigmoid, lw_pos, lw_neg)."""
    if spec[0] == "l2":
        return 0, 1.0, 1.0, 1.0, 1.0
    if spec[0] == "logloss":
        s = float(spec[1])
        return 1, s, s * s, float(spec[2]), float(spec[3])
    raise ValueError(f"unsupported fused gradient spec: {spec!r}")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card-side reference)
# ---------------------------------------------------------------------------

def grad_rows(spec, score: torch.Tensor, aux: torch.Tensor):
    """The built-in objectives' gradients in the reference's f32 op order
    (lightgbm_tpu/ops/pallas_hist.py _grad_rows): ("l2",) or
    ("logloss", sigmoid, lw_pos, lw_neg). Python-float factors are rounded
    to f32 where they meet a row, as JAX's weak types do."""
    kind, sigmoid, sig2, lw_pos, lw_neg = spec_args(spec)
    if kind == 0:
        return score - aux, torch.ones_like(score)
    t = 2.0 * aux - 1.0
    lw = torch.where(aux > 0, torch.tensor(lw_pos, dtype=torch.float32,
                                           device=aux.device),
                     torch.tensor(lw_neg, dtype=torch.float32,
                                  device=aux.device))
    one = torch.ones((), dtype=torch.float32, device=score.device)
    resp = torch.div(one, 1.0 + torch.exp(t * sigmoid * score))
    grad = -t * resp * sigmoid * lw
    hess = sig2 * resp * (1.0 - resp) * lw
    return grad, hess


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def sr_dither(n: int, seed: int, salt: int,
              device: torch.device) -> torch.Tensor:
    """quantize_sr's counter-hash dither (lightgbm_tpu/ops/histogram.py
    :353-358) as uint32 arithmetic carried in int64: [n] f32 in [0, 1)."""
    i = (torch.arange(n, dtype=torch.int64, device=device)
         + ((salt * 0x632BE59B) & _M32)) & _M32
    k = (int(seed) * 0x9E3779B9) & _M32
    z = _mul32(i ^ k, 2654435761)
    z = _mul32(z ^ (z >> 15), 2246822519)
    z = z ^ (z >> 13)
    return (z >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize_rows(x: torch.Tensor, scale: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """clip(floor(x * (127 / scale) + u), -127, 127) as int8, each f32 op
    rounded separately (127 / scale is a true division, not 127 * (1/scale))."""
    mul = torch.div(torch.full_like(scale, 127.0), scale)
    q = torch.floor(x * mul + u)
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def slot_hist_plain(bins_T: torch.Tensor, chans: Sequence[torch.Tensor],
                    slot: Optional[torch.Tensor], num_slots: int,
                    num_bins: int, acc: torch.dtype = torch.int64,
                    out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """[S, nch, F, B] sums of row channels by (slot, feature, bin), taken in
    ``acc`` and cast to ``out_dtype`` once: int32 sums of int8 channels, or
    f32 roundings of the f64 sums of f32 channels. Rows whose slot is
    outside [0, S) and bins >= B are dropped; slot None puts every row in
    slot 0."""
    f, n = bins_T.shape
    dev = bins_T.device
    s, b = num_slots, num_bins
    out = torch.zeros((s, len(chans), f, b), dtype=acc, device=dev)
    if slot is None:
        keep = torch.ones(n, dtype=torch.bool, device=dev)
        slot = torch.zeros(n, dtype=torch.int64, device=dev)
    else:
        slot = slot.to(torch.int64)
        keep = (slot >= 0) & (slot < s)
    for j in range(f):
        bj = bins_T[j].to(torch.int64)
        ok = keep & (bj < b)
        key = (slot[ok] * b + bj[ok])
        for c, ch in enumerate(chans):
            cell = torch.zeros(s * b, dtype=acc, device=dev)
            cell.index_add_(0, key, ch[ok].to(acc))
            out[:, c, j, :] = cell.view(s, b)
    return out.to(out_dtype)


def hist_q8_plain(bins_T, gq, hq, cq, slot, num_slots: int,
                  num_bins: int) -> torch.Tensor:
    """Plain version of hist_q8 (same returns)."""
    chans = [gq, cq] if hq is None else [gq, hq, cq]
    return slot_hist_plain(bins_T, chans, slot, num_slots, num_bins)


def hist_f32_plain(bins_T, g, h, c, slot, num_slots: int,
                   num_bins: int) -> torch.Tensor:
    """Plain version of hist_f32 (same returns): f64 sums rounded to f32
    once, the yardstick of the kernel's accuracy."""
    return slot_hist_plain(bins_T, [g, h, c], slot, num_slots, num_bins,
                           torch.float64, torch.float32)


def grad_quant_hist0_plain(bins_T, score, aux, bag, seed: int, spec,
                           num_bins: int, const_hess: bool):
    """Plain version of grad_quant_hist0 (same returns)."""
    f, n = bins_T.shape
    dev = score.device
    grad, hess = grad_rows(spec, score, aux)
    g = grad * bag
    h = hess * bag
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mg = torch.maximum(g.abs().max(), zero) if n else zero
    hv = h if const_hess else h.abs()
    mh = torch.maximum(hv.max(), zero) if n else zero
    floor = torch.tensor(1e-20, dtype=torch.float32, device=dev)
    scale_g = torch.maximum(mg, floor)
    scale_h = mh * 127.0 if const_hess else torch.maximum(mh, floor)
    gq = quantize_rows(g, scale_g, sr_dither(n, seed, 1, dev))
    cq = (bag > 0).to(torch.int8)
    if const_hess:
        hq = None
        chans = [gq, cq]
    else:
        hq = quantize_rows(h, scale_h, sr_dither(n, seed, 2, dev))
        chans = [gq, hq, cq]
    hist = slot_hist_plain(bins_T, chans, None, 1, num_bins)[0]
    return gq, hq, cq, torch.stack([scale_g, scale_h]), hist


def route_plain(bins_T, leaf_id, tables, na_bin, num_slots: int):
    """Per-row (slot, new leaf id) through one level's [6, L] route tables
    (rows: feat, thr, dleft, new_leaf, slot_left, slot_right), and the kept
    rows of each slot (slot in [0, S)): (slot [N] i32, lid2 [N] i32, counts
    [S] i32). Rows of leaves that do not split (feat < 0) or of no leaf keep
    their id and get the dropped slot S."""
    f, n = bins_T.shape
    l = tables.shape[1]
    lid = leaf_id.to(torch.int64)
    valid = (lid >= 0) & (lid < l)
    lc = lid.clamp(0, max(l - 1, 0))
    tab = tables.to(torch.int64)
    feat = torch.where(valid, tab[0][lc], torch.full_like(lc, -1))
    has = (feat >= 0) & (feat < f)
    fs = feat.clamp(0, f - 1)
    rows = torch.arange(n, device=bins_T.device)
    colv = bins_T[fs, rows].to(torch.int64)
    is_na = colv == na_bin.to(torch.int64)[fs]
    go_right = torch.where(is_na, tab[2][lc] == 0, colv > tab[1][lc])
    lid2 = torch.where(has & go_right, tab[3][lc], lid).to(torch.int32)
    slot = torch.where(has, torch.where(go_right, tab[5][lc], tab[4][lc]),
                       torch.full_like(lc, num_slots))
    keep = (slot >= 0) & (slot < num_slots)
    counts = torch.bincount(slot[keep], minlength=num_slots)
    return slot.to(torch.int32), lid2, counts.to(torch.int32)


def hist_routed_fused_plain(bins_T, gq, hq, cq, leaf_id, tables, na_bin,
                            num_slots: int, num_bins: int):
    """Plain version of hist_routed_fused (same returns)."""
    slot, lid2, _ = route_plain(bins_T, leaf_id, tables, na_bin, num_slots)
    return hist_q8_plain(bins_T, gq, hq, cq, slot, num_slots, num_bins), lid2


def leaf_sums_plain(g, h, c, leaf_id, num_leaves: int):
    """Plain version of leaf_sums: [3, L] f32 from f64 sums; leaf ids
    outside [0, L) are dropped."""
    ghc = torch.stack([g, h, c]).to(torch.float64)
    lid = leaf_id.to(torch.int64)
    ok = (lid >= 0) & (lid < num_leaves)
    out = torch.zeros((3, num_leaves), dtype=torch.float64, device=g.device)
    out.index_add_(1, lid[ok], ghc[:, ok])
    return out.to(torch.float32)


def leaf_sums_grad_plain(score, aux, bag, leaf_id, spec, num_leaves: int):
    """Plain version of leaf_sums_grad: [3, L] f32 from f64 sums."""
    grad, hess = grad_rows(spec, score, aux)
    return leaf_sums_plain(grad * bag, hess * bag,
                           (bag > 0).to(torch.float32), leaf_id, num_leaves)


def take_small_plain(table, idx):
    """Plain version of take_small."""
    l = table.shape[0]
    i = idx.to(torch.int64)
    ok = (i >= 0) & (i < l)
    if l == 0:
        return torch.zeros(i.shape, dtype=torch.float32, device=table.device)
    val = table[i.clamp(0, l - 1)]
    return torch.where(ok, val, torch.zeros_like(val))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def grad_quant_hist0(bins_T: torch.Tensor, score: torch.Tensor,
                     aux: torch.Tensor, bag: torch.Tensor, seed: int, spec,
                     num_bins: int, const_hess: bool):
    """Fused objective gradient + int8 SR quantization + root histogram.

    bins_T [F, N] u8; score/aux/bag [N] f32 (aux: label for "l2", label_pos
    for "logloss"). Returns (gq [N] i8, hq [N] i8 or None under const_hess,
    cq [N] i8, scales [2] f32 = (scale_g, scale_h), hist [nch, F, B] i32)."""
    dev = _device_of(bins_T, score, aux, bag)
    f, n = bins_T.shape
    _check(bins_T, "bins_T", torch.uint8, (f, n))
    for name, t in (("score", score), ("aux", aux), ("bag", bag)):
        _check(t, name, torch.float32, (n,))
    if dev.type == "cpu":
        return grad_quant_hist0_plain(bins_T, score, aux, bag, seed, spec,
                                      num_bins, const_hess)
    nch = 2 if const_hess else 3
    if (nch + 1) * f * num_bins * 4 > 48 * 1024:
        raise ValueError(f"grad_quant_hist0: F * B = {f * num_bins} exceeds "
                         f"the kernel's {12288 // (nch + 1)}-cell root "
                         "histogram")
    lib = cuda_lib.load()
    gq = torch.empty(n, dtype=torch.int8, device=dev)
    hq = None if const_hess else torch.empty(n, dtype=torch.int8, device=dev)
    cq = torch.empty(n, dtype=torch.int8, device=dev)
    scales = torch.empty(2, dtype=torch.float32, device=dev)
    mx = torch.zeros(2, dtype=torch.int32, device=dev)
    hist = torch.zeros((nch, f, num_bins), dtype=torch.int32, device=dev)
    kind, sig, sig2, lwp, lwn = spec_args(spec)
    plan = grad_quant_plan(n, _num_sms(dev))
    rc = lib.lgbt_grad_quant_hist0(
        bins_T.data_ptr(), score.data_ptr(), aux.data_ptr(), bag.data_ptr(),
        n, f, num_bins, kind, sig, sig2, lwp, lwn, int(const_hess),
        int(seed) & 0xFFFFFFFF, mx.data_ptr(), gq.data_ptr(), _ptr(hq),
        cq.data_ptr(), scales.data_ptr(), hist.data_ptr(), plan.max_grid,
        plan.blocks, plan.quads, _stream(dev))
    cuda_lib.check(rc, "grad_quant_hist0")
    LAUNCHES["grad_quant_hist0"] += 1
    return gq, hq, cq, scales, hist


def hist_routed_fused(bins_T: torch.Tensor, gq: torch.Tensor,
                      hq: Optional[torch.Tensor], cq: torch.Tensor,
                      leaf_id: torch.Tensor, tables: torch.Tensor,
                      na_bin: torch.Tensor, num_slots: int, num_bins: int,
                      bins: Optional[torch.Tensor] = None):
    """Route each row through its leaf's split and build the slot histogram.

    tables [6, L] i32 rows (feat, thr, dleft, new_leaf, slot_left,
    slot_right); na_bin [F] i32 (a value >= B means no missing bin). bins
    [N, F] u8 is the row-major copy of bins_T (basic.Dataset.bins), needed
    on the card (the kept rows' bins are copied from it). Returns (hist
    [S, nch, F, B] i32, lid2 [N] i32); nch = 2 when hq is None
    (const-hessian: channels g, count)."""
    dev = _device_of(bins_T, gq, cq, leaf_id, tables, na_bin)
    f, n = bins_T.shape
    l = tables.shape[1]
    _check(bins_T, "bins_T", torch.uint8, (f, n))
    _check(gq, "gq", torch.int8, (n,))
    _check(cq, "cq", torch.int8, (n,))
    if hq is not None:
        _device_of(bins_T, hq)
        _check(hq, "hq", torch.int8, (n,))
    _check(leaf_id, "leaf_id", torch.int32, (n,))
    _check(tables, "tables", torch.int32, (6, l))
    _check(na_bin, "na_bin", torch.int32, (f,))
    if num_slots < 1:
        raise ValueError("hist_routed_fused: num_slots must be >= 1")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"hist_routed_fused: num_bins {num_bins} outside "
                         "[1, 256] (uint8 bins)")
    _check_bins("hist_routed_fused", bins_T, bins, True)
    if dev.type == "cpu":
        return hist_routed_fused_plain(bins_T, gq, hq, cq, leaf_id, tables,
                                       na_bin, num_slots, num_bins)
    nch = 2 if hq is None else 3
    plan = slot_hist_plan(f, n, nch, num_bins, _num_sms(dev))
    hist = torch.zeros((num_slots, nch, f, num_bins), dtype=torch.int32,
                       device=dev)
    lid2 = torch.empty(n, dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    idx, rec, rec_words = _slot_scratch(n, f, num_slots, 1, dev)
    rc = cuda_lib.load().lgbt_hist_routed_fused(
        bins_T.data_ptr(), bins.data_ptr(), gq.data_ptr(), _ptr(hq),
        cq.data_ptr(), leaf_id.data_ptr(), tables.data_ptr(),
        na_bin.data_ptr(), n, f, num_bins, l, num_slots, nch, plan.fg,
        plan.blocks, plan.min_rows, plan.pass_blocks,
        slot.data_ptr(), idx.data_ptr(), rec.data_ptr(), rec_words,
        hist.data_ptr(), lid2.data_ptr(), _stream(dev))
    cuda_lib.check(rc, "hist_routed_fused")
    LAUNCHES["hist_routed_fused"] += 1
    return hist, lid2


class LeafSumsPlan(NamedTuple):
    """Launch plan of the leaf sums (csrc/leaf_sums.cuh)."""
    warps: int    # warps a block, each with a private f64 leaf table;
    #               0: too large for shared memory, global atomics
    grid: int     # row blocks: the rows of the [grid, 3, L] f64 scratch


def leaf_table_bytes(num_leaves: int) -> int:
    """Shared bytes of one warp's leaf table: 3 * L f64 rounded up to 16
    bytes (csrc/leaf_sums.cuh leaf_table_words)."""
    return 8 * ((3 * num_leaves + 1) & ~1)


def leaf_sums_plan(n: int, num_leaves: int, num_sms: int) -> LeafSumsPlan:
    """As many warps a block as LEAF_WARPS and the shared-memory budget
    allow (leaf_table_bytes a warp), two blocks an SM, fewer when the rows
    (four a thread) do not fill them. The grid fixes the leaf sums' order
    of addition: a card with another SM count may round them otherwise."""
    warps = min(LEAF_WARPS, SMEM_BUDGET // leaf_table_bytes(num_leaves))
    quads = -(-n // 4)
    blocks = -(-quads // (32 * (warps or LEAF_WARPS)))
    return LeafSumsPlan(warps, max(1, min(2 * num_sms, blocks)))


def _check_leaves(name: str, num_leaves: int) -> None:
    if num_leaves < 1:
        raise ValueError(f"{name}: num_leaves must be >= 1")


def _leaf_sums_launch(name: str, fn, args, n: int, num_leaves: int,
                      dev: torch.device) -> torch.Tensor:
    """Run a leaf-sum C entry (row pass + final pass) into a new [3, L]
    f32 output; one count a call."""
    plan = leaf_sums_plan(n, num_leaves, _num_sms(dev))
    part = torch.empty((plan.grid if plan.warps else 1) * 3 * num_leaves,
                       dtype=torch.float64, device=dev)
    out = torch.empty((3, num_leaves), dtype=torch.float32, device=dev)
    rc = fn(*args, plan.warps, plan.grid, part.data_ptr(), out.data_ptr(),
            _stream(dev))
    cuda_lib.check(rc, name)
    LAUNCHES[name] += 1
    return out


def leaf_sums_grad(score: torch.Tensor, aux: torch.Tensor, bag: torch.Tensor,
                   leaf_id: torch.Tensor, spec, num_leaves: int) -> torch.Tensor:
    """Exact per-leaf (grad, hess, count) sums [3, L] f32 with g/h
    recomputed from (score, aux, bag); leaf ids outside [0, L) are dropped."""
    dev = _device_of(score, aux, bag, leaf_id)
    n = score.shape[0]
    for name, t in (("score", score), ("aux", aux), ("bag", bag)):
        _check(t, name, torch.float32, (n,))
    _check(leaf_id, "leaf_id", torch.int32, (n,))
    _check_leaves("leaf_sums_grad", num_leaves)
    if dev.type == "cpu":
        return leaf_sums_grad_plain(score, aux, bag, leaf_id, spec,
                                    num_leaves)
    kind, sig, sig2, lwp, lwn = spec_args(spec)
    return _leaf_sums_launch(
        "leaf_sums_grad", cuda_lib.load().lgbt_leaf_sums_grad,
        (score.data_ptr(), aux.data_ptr(), bag.data_ptr(),
         leaf_id.data_ptr(), n, num_leaves, kind, sig, sig2, lwp, lwn),
        n, num_leaves, dev)


def take_small(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [L] f32, idx [N] i32 -> [N] f32; out-of-range idx -> 0."""
    dev = _device_of(table, idx)
    l, n = table.shape[0], idx.shape[0]
    _check(table, "table", torch.float32, (l,))
    _check(idx, "idx", torch.int32, (n,))
    if dev.type == "cpu":
        return take_small_plain(table, idx)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    # 256-thread blocks of four rows a thread, at most eight an SM: the
    # card once over
    grid = max(1, min(8 * _num_sms(dev), -(-n // 1024)))
    rc = cuda_lib.load().lgbt_take_small(table.data_ptr(), idx.data_ptr(), n,
                                         l, out.data_ptr(), grid,
                                         _stream(dev))
    cuda_lib.check(rc, "take_small")
    LAUNCHES["take_small"] += 1
    return out


# grad_quant_hist0's root histogram (csrc/grad_quant_hist0.cu): one packed
# 32-bit shared cell a (feature, bin), fields (name, first bit, bits) of
# the count (modulo 2^12) and sum(gq + 127), and the rows a block adds
# between two drains of its cells (1024 threads, four rows each)
GQ_FIELDS = (("count", 0, 12), ("g", 12, 20))
GQ_STEP_ROWS = 4 * 1024


class GradQuantPlan(NamedTuple):
    """Grid of grad_quant_hist0's two launches."""
    max_grid: int   # 256-thread blocks of the max pass, four rows a thread
    blocks: int     # 1024-thread blocks of the quantize + histogram pass
    quads: int      # groups of four rows a block takes (the last fewer)


def grad_quant_plan(n: int, num_sms: int) -> GradQuantPlan:
    """Grid of grad_quant_hist0: the quantize + histogram pass cuts the N
    rows into equal ranges of consecutive rows, one a block, as the root
    pass of the slot histograms does (slot_hist_plan: two 1024-thread blocks
    an SM, the card covered twice, at least 1024 rows a block); the max pass
    takes four rows a thread in at most eight 256-thread blocks an SM."""
    nq = -(-n // 4)
    quads = max(256, -(-nq // (4 * num_sms)))
    blocks = max(1, -(-nq // quads))
    max_grid = max(1, min(8 * num_sms, -(-nq // 256)))
    return GradQuantPlan(max_grid, blocks, quads)


def pass_blocks(n: int, num_sms: int) -> int:
    """Blocks of the slot histograms' count and scatter passes (4096 rows a
    block and step) and of the level routing (256 threads, one row a thread
    and step): one block a 4096 rows, at most 8 an SM."""
    return max(1, min(8 * num_sms, -(-n // 4096)))


class SlotHistPlan(NamedTuple):
    """Grid, block and range sizes of hist_q8, hist_f32 and
    hist_routed_fused (csrc/slot_hist.cuh)."""
    fg: int           # features a histogram block (grid.y = ceil(F / fg))
    blocks: int       # histogram blocks a feature group (grid.x)
    min_rows: int     # least list entries (or rows) a histogram block takes
    pass_blocks: int  # blocks of the count and scatter passes
    smem: int         # bytes of one block's [nch, fg, B] shared table


def slot_hist_plan(f: int, n: int, nch: int, num_bins: int,
                   num_sms: int) -> SlotHistPlan:
    """Plan of the slot histograms, whose cells are 4 bytes (int32 or f32).

    A block holds one slot's table for as many features as fit the
    shared-memory budget (all 28 at B = 256; even groups where they do not
    fit), in blocks of 1024 threads (csrc/slot_hist.cuh kSlotThreads), two
    an SM where two tables fit the budget (F = 28 at B = 64 and 256), else
    one: at B = 64, where eight tables fit, two blocks of 1024 beat four of
    512 and eight of 256 on an H100 (slot_hist.cuh, "Design"). 2 x SMs x
    blocks-an-SM blocks cover the card twice; each takes at least 1024
    entries, so that its flush (at most nch * fg * B global atomics a slot
    segment) stays within a quarter of its row atomics (rows * fg * nch) at
    B = 256 when few rows are kept. The count pass takes 4096 rows a block
    and step, at most 8 blocks an SM; the scatter pass four times as many
    blocks of a quarter the size."""
    per_feature = nch * num_bins * 4
    groups = -(-f // max(1, SMEM_BUDGET // per_feature))
    fg = -(-f // groups)
    smem = fg * per_feature
    blocks_per_sm = max(1, min(2, SMEM_BUDGET // smem))
    blocks = -(-(2 * num_sms * blocks_per_sm) // groups)
    return SlotHistPlan(fg, blocks, 1024, pass_blocks(n, num_sms), smem)


def slot_hist_tiles(plan: SlotHistPlan, f: int,
                    counts: Sequence[int]) -> List[Tuple[int, int, int, int,
                                                         int]]:
    """(feature group, block, slot, first entry, end) of every segment that
    the histogram blocks take from the slot-ordered list of kept rows, as
    csrc/slot_hist.cuh slot_hist computes them on the card from the per-slot
    counts (one count, n, for the root pass in natural order)."""
    off = [0]
    for k in counts:
        off.append(off[-1] + int(k))
    kept = off[-1]
    per = max(plan.min_rows, -(-kept // plan.blocks))
    out = []
    for grp in range(-(-f // plan.fg)):
        for blk in range(plan.blocks):
            e = blk * per
            if e >= kept:
                break
            e1 = min(kept, e + per)
            sl = bisect.bisect_right(off, e) - 1   # off[sl] <= e < off[sl+1]
            while True:
                seg = min(e1, off[sl + 1])
                out.append((grp, blk, sl, e, seg))
                e = seg
                if e >= e1:
                    break
                sl += 1
                while off[sl + 1] <= e:
                    sl += 1
    return out


def slot_compact_plain(slot: torch.Tensor, num_slots: int):
    """Plain version of the compaction of hist_q8 and hist_f32: (offsets
    [S + 1] i64, the exclusive prefix sums of the kept rows' per-slot
    counts, and the kept rows [K] i64 grouped by slot, in row order within
    a slot, which the kernel does not keep). Rows whose slot lies outside
    [0, S) are dropped."""
    sl = slot.to(torch.int64)
    keep = (sl >= 0) & (sl < num_slots)
    counts = torch.bincount(sl[keep], minlength=num_slots)
    off = torch.zeros(num_slots + 1, dtype=torch.int64, device=slot.device)
    off[1:] = torch.cumsum(counts, 0)
    rows = keep.nonzero().squeeze(1)
    order = torch.sort(sl[rows], stable=True).indices
    return off, rows[order]


def _check_bins(name: str, bins_T: torch.Tensor, bins,
                needed: bool) -> None:
    """The row-major bins of the slot histograms: [N, F] u8 beside bins_T,
    and ``needed`` on the card (with a slot vector, and always by the fused
    level pass: the compaction reads the kept rows' bins from it)."""
    f, n = bins_T.shape
    if bins is not None:
        _device_of(bins_T, bins)
        _check(bins, "bins", torch.uint8, (n, f))
    elif needed and bins_T.device.type == "cuda":
        raise ValueError(f"{name}: needs the row-major bins [N, F] on the "
                         "card (to group the kept rows by slot)")


def _slot_scratch(n: int, f: int, num_slots: int, chan_words: int,
                  dev: torch.device, zero: bool = True):
    """(idx [3S + 1] i32: counts, offsets, cursors, zeros unless not zero;
    rec [N x rec_words] i32 records; rec_words) of a compaction by slot."""
    rec_words = (f + 3) // 4 + chan_words      # slot_hist.cuh record_words
    idx = (torch.zeros if zero else torch.empty)(
        3 * num_slots + 1, dtype=torch.int32, device=dev)
    rec = torch.empty(n * rec_words, dtype=torch.int32, device=dev)
    return idx, rec, rec_words


def _check_counts(name: str, slot, counts, num_slots: int) -> None:
    """The per-slot counts a slot histogram may be handed: [S] i32 beside a
    slot vector, the kept rows of each of its slots. On the CPU counts that
    do not match the slot vector raise here; on the card the kernel stops
    with a device-side assert (csrc/slot_hist.cuh)."""
    if counts is None:
        return
    if slot is None:
        raise ValueError(f"{name}: counts need a slot vector")
    _device_of(slot, counts)
    _check(counts, "counts", torch.int32, (num_slots,))
    if counts.device.type == "cpu":
        kept = slot[(slot >= 0) & (slot < num_slots)].long()
        if not torch.equal(counts, torch.bincount(
                kept, minlength=num_slots).to(torch.int32)):
            raise ValueError(f"{name}: counts are not the kept rows of each "
                             "slot of this slot vector")


def _slot_hist(name: str, bins_T: torch.Tensor, bins, chans, slot, counts,
               num_slots: int, num_bins: int, nch: int, cell: torch.dtype,
               chan_words: int) -> torch.Tensor:
    """Launch hist_q8 or hist_f32 (the kernel ``name``) on the card: the
    compaction (its count pass only without counts) and the histogram with a
    slot vector, the histogram alone without one. Counts one launch."""
    dev = bins_T.device
    f, n = bins_T.shape
    plan = slot_hist_plan(f, n, nch, num_bins, _num_sms(dev))
    hist = torch.zeros((num_slots, nch, f, num_bins), dtype=cell, device=dev)
    idx = rec = None
    rec_words = 0
    if slot is not None:
        # handed counts over S > 1 slots, the scan writes every offset and
        # cursor and nothing adds into idx
        idx, rec, rec_words = _slot_scratch(
            n, f, num_slots, chan_words, dev,
            zero=counts is None or num_slots == 1)
    rc = getattr(cuda_lib.load(), f"lgbt_{name}")(
        bins_T.data_ptr(), _ptr(bins), *(_ptr(t) for t in chans), _ptr(slot),
        _ptr(counts), n, f, num_bins, num_slots, nch, plan.fg, plan.blocks,
        plan.min_rows, plan.pass_blocks, _ptr(idx), _ptr(rec), rec_words,
        hist.data_ptr(), _stream(dev))
    cuda_lib.check(rc, name)
    LAUNCHES[name] += 1
    return hist


def hist_q8(bins_T: torch.Tensor, gq: torch.Tensor, hq: Optional[torch.Tensor],
            cq: torch.Tensor, slot: Optional[torch.Tensor], num_slots: int,
            num_bins: int, bins: Optional[torch.Tensor] = None,
            counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 slot histogram over a precomputed slot vector.

    bins_T [F, N] u8; gq/hq/cq [N] i8 (hq None: const-hessian, channels g
    and count); slot [N] i32, or None to put every row in slot 0 (the root
    pass reads no slot vector). Rows whose slot lies outside [0, S) are
    dropped. bins [N, F] u8 is the row-major copy of bins_T
    (basic.Dataset.bins), needed on the card with a slot vector. counts [S]
    i32, the kept rows of each slot as route_level returns them, spare the
    kernel its count pass (the plain version needs none; counts that do
    not match slot raise on the CPU and assert on the card). Returns int32
    [S, nch, F, B]."""
    dev = _device_of(bins_T, gq, cq)
    f, n = bins_T.shape
    _check(bins_T, "bins_T", torch.uint8, (f, n))
    _check(gq, "gq", torch.int8, (n,))
    _check(cq, "cq", torch.int8, (n,))
    if hq is not None:
        _device_of(bins_T, hq)
        _check(hq, "hq", torch.int8, (n,))
    if slot is not None:
        _device_of(bins_T, slot)
        _check(slot, "slot", torch.int32, (n,))
    if num_slots < 1:
        raise ValueError("hist_q8: num_slots must be >= 1")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"hist_q8: num_bins {num_bins} outside [1, 256] "
                         "(uint8 bins)")
    _check_bins("hist_q8", bins_T, bins, slot is not None)
    _check_counts("hist_q8", slot, counts, num_slots)
    if dev.type == "cpu":
        return hist_q8_plain(bins_T, gq, hq, cq, slot, num_slots, num_bins)
    return _slot_hist("hist_q8", bins_T, bins, (gq, hq, cq), slot, counts,
                      num_slots, num_bins, 2 if hq is None else 3,
                      torch.int32, 1)


def route_level(bins_T: torch.Tensor, leaf_id: torch.Tensor,
                tables: torch.Tensor, na_bin: torch.Tensor, num_slots: int):
    """Each row's (slot, new leaf id) through its leaf's split, and the kept
    rows of each slot.

    tables [6, L] i32 rows (feat, thr, dleft, new_leaf, slot_left,
    slot_right); na_bin [F] i32 (a value >= B means no missing bin). Rows
    of leaves that do not split (feat < 0) or of no leaf keep their id and
    get slot S. Returns (slot [N] i32, lid2 [N] i32, counts [S] i32: the
    rows whose slot lies in [0, S), by slot), the counts for hist_q8 or
    hist_f32 over this slot vector."""
    dev = _device_of(bins_T, leaf_id, tables, na_bin)
    f, n = bins_T.shape
    l = tables.shape[1]
    _check(bins_T, "bins_T", torch.uint8, (f, n))
    _check(leaf_id, "leaf_id", torch.int32, (n,))
    _check(tables, "tables", torch.int32, (6, l))
    _check(na_bin, "na_bin", torch.int32, (f,))
    if num_slots < 1:
        raise ValueError("route_level: num_slots must be >= 1")
    if dev.type == "cpu":
        return route_plain(bins_T, leaf_id, tables, na_bin, num_slots)
    lib = cuda_lib.load()
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    lid2 = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(num_slots, dtype=torch.int32, device=dev)
    rc = lib.lgbt_route_level(
        bins_T.data_ptr(), leaf_id.data_ptr(), tables.data_ptr(),
        na_bin.data_ptr(), n, f, l, num_slots, slot.data_ptr(),
        lid2.data_ptr(), counts.data_ptr(), pass_blocks(n, _num_sms(dev)),
        _stream(dev))
    cuda_lib.check(rc, "route_level")
    LAUNCHES["route_level"] += 1
    return slot, lid2, counts


def leaf_sums(g: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              leaf_id: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """Exact per-leaf (grad, hess, count) sums [3, L] f32 of materialized
    [N] f32 rows, summed in f64; leaf ids outside [0, L) are dropped."""
    dev = _device_of(g, h, c, leaf_id)
    n = g.shape[0]
    for name, t in (("g", g), ("h", h), ("c", c)):
        _check(t, name, torch.float32, (n,))
    _check(leaf_id, "leaf_id", torch.int32, (n,))
    _check_leaves("leaf_sums", num_leaves)
    if dev.type == "cpu":
        return leaf_sums_plain(g, h, c, leaf_id, num_leaves)
    return _leaf_sums_launch(
        "leaf_sums", cuda_lib.load().lgbt_leaf_sums,
        (g.data_ptr(), h.data_ptr(), c.data_ptr(), leaf_id.data_ptr(), n,
         num_leaves), n, num_leaves, dev)


def hist_f32(bins_T: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
             c: torch.Tensor, slot: Optional[torch.Tensor], num_slots: int,
             num_bins: int, bins: Optional[torch.Tensor] = None,
             counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 slot histogram of (grad, hess, count) rows over a slot vector.

    bins_T [F, N] u8; g/h/c [N] f32 (already masked by the bag); slot [N]
    i32, or None to put every row in slot 0 (the root pass reads no slot
    vector). Rows whose slot lies outside [0, S) are dropped. bins [N, F]
    u8 is the row-major copy of bins_T (basic.Dataset.bins), needed on the
    card with a slot vector. counts [S] i32, as route_level returns them,
    spare the kernel its count pass (as in hist_q8). Returns f32
    [S, 3, F, B], channel-major."""
    dev = _device_of(bins_T, g, h, c)
    f, n = bins_T.shape
    _check(bins_T, "bins_T", torch.uint8, (f, n))
    for name, t in (("g", g), ("h", h), ("c", c)):
        _check(t, name, torch.float32, (n,))
    if slot is not None:
        _device_of(bins_T, slot)
        _check(slot, "slot", torch.int32, (n,))
    if num_slots < 1:
        raise ValueError("hist_f32: num_slots must be >= 1")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"hist_f32: num_bins {num_bins} outside [1, 256] "
                         "(uint8 bins)")
    _check_bins("hist_f32", bins_T, bins, slot is not None)
    _check_counts("hist_f32", slot, counts, num_slots)
    if dev.type == "cpu":
        return hist_f32_plain(bins_T, g, h, c, slot, num_slots, num_bins)
    return _slot_hist("hist_f32", bins_T, bins, (g, h, c), slot, counts,
                      num_slots, num_bins, 3, torch.float32, 3)
