#!/usr/bin/env python3
"""On-card smoke run of lightgbm_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored, except
that a device time the profiler does not see is printed as null, not
measured):

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the eight Hopper kernels are compiled from lightgbm_tpu_torch/csrc
   by nvcc into one library (ops/cuda_lib.py), and the build time printed;
3. kernels: each kernel's wrapper runs on the card at the main paths'
   shapes and is held against its plain PyTorch version on the same
   inputs: integer outputs and histograms exactly, leaf sums' counts
   exactly and g, h within 1e-6 of the row mass, two launches of a leaf
   sum bit for bit. The fused path's kernels at N = 10.5M rows, F = 28,
   B = 64, L = 255 (grad_quant_hist0 with 3 and 2 channels, its two
   launches split by device time, and at its packed cells' worst case:
   every row kept, in bin 0, at |gq| = |hq| = 127; leaf_sums_grad on
   uniform and on skewed leaf ids, leaf k drawn with probability
   proportional to 1 / (k + 1); the level pass, given
   the row-major bins, at a first level, S = 1, at S = 32 and 127 slots
   and on a skewed S = 127 level, with 2 and 3 channels); the unfused
   path's at B = 256: route_level at S = 32 and 127 (slot, new leaf id and
   per-slot counts, the counts also against the bincount of its slots),
   leaf_sums at L = 255 on the two leaf-id distributions, and the two
   slot histograms, hist_q8 (2 and 3
   channels) and hist_f32 (f32 rows; counts exactly, g and h within 2^-15
   of the cell's absolute mass), at S = 1 (no slot vector), at S = 32 and
   127 fed the slots and the counts route_level gives (NA bins, leaves
   that do not split, about half the rows in dropped slots; each also
   without the counts, against the same yardstick), on a skewed level
   (S = 127, about half the kept rows in one slot) and on two
   lossguide-shaped passes (S = 1, about 5% and 0.5% of the rows kept),
   hist_f32 also at B = 64 and S = 127. Each kernel is timed
   (median of CUDA-event timings), beside its plain version, the least
   time the card could take (bytes over memory rate or operations over
   peak rate, counting only what the data needs) and one PyTorch call
   computing the same function where one exists (for the slot histograms
   an index_add_ over flat cell indices, int32 for hist_q8, checked
   against the plain version; index_select for take_small; index_add_ of
   the rows for the leaf sums); take_small, its index_select, route_level,
   the level pass at S = 127 and the leaf sums also by the device time of
   their kernels alone (torch.profiler), without the host
   time that event timings include;
4. main paths: a HIGGS-shaped 10.5M x 28 table (bench.py's generator,
   copied) through lightgbm_tpu_torch.Dataset and train(), one constructed
   Dataset a bin count: a binary model (num_leaves=255, learning_rate=0.1,
   min_data_in_leaf=20) and an L2 model on a continuous target, (a) at
   max_bin=63 (B = 64, F * B = 1792: the fused quantized path), (b) at the
   default max_bin=255 (B = 256, F * B = 7168: the unfused quantized
   path), (c) at 255 with use_quantized_grad=false (the depthwise grower
   on f32 histograms) and (d) at 255 with grow_policy=lossguide (the
   leaf-wise grower, never quantized); binary for 5 iterations on (a)-(c)
   and 3 on (d), L2 for 2 on each. The launch counters are zeroed before
   each path and read after; on (a) they must equal one grad_quant_hist0 /
   leaf_sums_grad / take_small per tree and one hist_routed_fused per
   level pass, on (b) one hist_q8 per tree and per level pass, one
   route_level per level pass and one leaf_sums / take_small per tree, on
   (c) one hist_f32 per tree and per level pass, one route_level per level
   pass and one take_small per tree, on (d) one hist_f32 per tree and per
   split and one take_small per tree, and zero for every other kernel. On
   each path: train AUC on 1M rows > 0.7, the L2 model's squared error
   below the label variance, the saved model text loads back and predicts
   identically; the peak device memory of its training is printed;
5. agreement, at max_bin=63 and at 255 (the 4000-row table has more than
   128 bins a feature, so the unfused path, which is asserted): the first
   tree of a 4000-row L2 model trained on the card has the structure of
   the same tree trained through the plain versions on the CPU, and leaf
   values within 1e-6 of its largest leaf value in magnitude (the one
   difference is the f64 order of the leaf sums; later trees inherit it,
   so only the first is compared exactly). Paths (c) and (d) at both bin
   counts on exact-sum data (labels on a 1/8 grid in [0, 4), no init
   score, so the first tree's gradients are -label and h = 1, and every
   histogram sum is exact in any order): the first tree equals the
   CPU-trained one bit for bit, leaf values included.

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N, F, B, L = 10_500_000, 28, 64, 255
BW = 256              # the bin axis of the default max_bin=255
FUSED = ("grad_quant_hist0", "hist_routed_fused", "leaf_sums_grad")
UNFUSED = ("hist_q8", "route_level", "leaf_sums")
# the main paths of phase 4: (max_bin, extra parameters, binary iterations)
PATHS = {"fused": (63, {}, 5), "unfused": (255, {}, 5),
         "f32": (255, {"use_quantized_grad": "false"}, 5),
         "lossguide": (255, {"grow_policy": "lossguide"}, 3)}
# the saved model goes beside the kernel library (ignored by git)
OUT_DIR = os.path.join(HERE, "lightgbm_tpu_torch", "_build")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def synth_higgs(n_rows: int, n_feat: int = 28, seed: int = 0):
    """HIGGS-shaped binary problem (a copy of bench.py synth_higgs)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n_rows, n_feat).astype(np.float32)
    w = rng.randn(8)
    logits = (X[:, :8] @ w) * 0.7 + 0.5 * np.abs(X[:, 8]) * X[:, 9] \
        - 0.4 * (X[:, 10] ** 2) + 0.3
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.rand(n_rows) < p).astype(np.float32)
    return X, y


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(memory bytes/s, f32 operations/s) of the card from NVIDIA's data
    sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s, PCIe 2.0 TB/s and 51, NVL
    3.9 TB/s and 60."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


def time_ms(fn, reps=7):
    """Median of reps CUDA-event timings of one call of fn, after a warm-up
    call. Shared with scripts/torch_*.py."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def skewed_leaves(n: int, l: int, rand):
    """[n] int32 leaf ids over [0, l), leaf k drawn with probability
    proportional to 1 / (k + 1) (the few large leaves at the end of a
    depthwise tree; at l = 255 the largest holds about 16% of the rows),
    by the inverse CDF of rand(n), uniform on [0, 1) on the device. Shared
    with scripts/torch_*.py."""
    import torch
    u = rand(n).double()
    w = 1.0 / torch.arange(1, l + 1, dtype=torch.float64, device=u.device)
    cdf = torch.cumsum(w, 0) / w.sum()
    return torch.searchsorted(cdf, u, right=True).clamp_(max=l - 1).to(
        torch.int32)


def device_split(fn, reps=10, tries=3):
    """Device ms a call of fn by CUDA kernel (torch.profiler over reps calls,
    after a warm-up call): the time of the call's CUDA kernels alone,
    without the host time before and between launches that CUDA-event
    timings include. CUPTI's trace sometimes comes back without device
    events: the profile is taken again, up to tries sessions, and None
    (device time not measured) is returned when none of them saw any.
    Shared with scripts/torch_*.py."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            if ev.device_type.name == "CUDA" and t > 0:
                m = re.search(r"(\w+)\(", ev.key)   # the function's name
                key = m.group(1) if m else ev.key
                split[key] = split.get(key, 0.0) + t / reps / 1e3
        if split:
            return split
    print(f"chip_smoke: the profiler saw no device time in {tries} "
          "sessions; device time not measured", file=sys.stderr)
    return None


def device_ms(fn, reps=10):
    """Sum of device_split's kernel times, or None when not measured."""
    split = device_split(fn, reps)
    return None if split is None else sum(split.values())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "lightgbm_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(lightgbm_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import metrics
    from lightgbm_tpu_torch.ops import cuda_lib
    from lightgbm_tpu_torch.ops import hist_kernels as hk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    bw, flops = peaks(name)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}"
          f" count {torch.cuda.device_count()}; peaks {bw / 1e12} TB/s, "
          f"{flops / 1e12} TFLOP/s f32")

    # ---- 2. build ----
    t0 = time.perf_counter()
    cuda_lib.load()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {cuda_lib.BUILD_INFO.get('seconds', 0.0):.3f} s, "
          f"built={cuda_lib.BUILD_INFO.get('built')})")
    for line in str(cuda_lib.BUILD_INFO.get("log", "")).splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  ptxas: {line.strip()}")

    def bound(nbytes, nops):
        t_b, t_o = nbytes / bw * 1e3, nops / flops * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def exact(name_, a, b):
        """Max abs difference of kernel and plain outputs; fails unless 0."""
        if a is None and b is None:
            return 0.0
        diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"{name_}: kernel != plain (max abs diff {diff.max()}, "
                 f"{int((diff > 0).sum())} elements)")
        return float(diff.max()) if diff.numel() else 0.0

    # ---- 3. kernels against their plain versions ----
    g = torch.Generator(device=dev).manual_seed(0)
    bins_T = torch.randint(0, 63, (F, N), generator=g, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    score = torch.randn(N, generator=g, device=dev) * 0.5
    label_pos = (torch.rand(N, generator=g, device=dev) < 0.5).float()
    label_reg = torch.randn(N, generator=g, device=dev)
    bag = (torch.rand(N, generator=g, device=dev) < 0.9).float()
    logloss = ("logloss", 1.0, 1.0, 1.0)
    kernels = {}

    # B1 grad_quant_hist0: logloss (3 channels) and l2 const-hess (2), each
    # split by device time into its max pass and its quantize + histogram
    # pass; then the packed cells' worst case: every row kept and in bin 0
    # of every feature with gq = hq = 127 (score 0: logloss g = 0.5 and
    # h = 0.25 with label 0, L2 g = 1 with label -1, each at its scale), so
    # that each block's cell (j, 0) holds its whole range of rows at the
    # fields' largest sums
    variants = []
    zeros_T = torch.zeros_like(bins_T)
    ones = torch.ones(N, device=dev)
    for spec, aux, ch, worst in (
            (logloss, label_pos, False, False),
            (("l2",), label_reg, True, False),
            (logloss, torch.zeros(N, device=dev), False, True),
            (("l2",), -ones, True, True)):
        args = ((zeros_T, torch.zeros(N, device=dev), aux, ones) if worst
                else (bins_T, score, aux, bag)) + (7, spec, B, ch)
        k = hk.grad_quant_hist0(*args)
        p = hk.grad_quant_hist0_plain(*args)
        tag = f"grad_quant_hist0[{spec[0]}{', worst' if worst else ''}]"
        err = max(exact(f"{tag}.{nm}", a, b)
                  for nm, a, b in zip(("gq", "hq", "cq", "scales", "hist"),
                                      k, p))
        nch = 2 if ch else 3
        if worst:
            if int(k[0].min()) != 127 or int(k[4][0, :, 0].min()) != 127 * N:
                fail(f"{tag}: not the fields' worst case")
            variants.append(dict(spec=spec[0], nch=nch, worst_case=True,
                                 max_abs_err=err))
            continue
        ms = time_ms(lambda: hk.grad_quant_hist0(*args))
        split = device_split(lambda: hk.grad_quant_hist0(*args))
        plain_ms = time_ms(lambda: hk.grad_quant_hist0_plain(*args), reps=3)
        bms, by = bound(N * (F + 12 + nch) + nch * F * B * 4,
                        N * (40 + F * nch))
        variants.append(dict(spec=spec[0], nch=nch, max_abs_err=err, ms=ms,
                             device_ms_by_kernel=split, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by))
        if spec[0] == "logloss":
            quant3 = k
        else:
            quant2 = k
    del zeros_T, ones
    main_v = variants[0]
    kernels["grad_quant_hist0"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/grad_quant_hist0.cu",
        replaces="lightgbm_tpu/ops/pallas_hist.py:918",
        max_abs_err=max(v["max_abs_err"] for v in variants),
        ms=main_v["ms"], device_ms_by_kernel=main_v["device_ms_by_kernel"],
        plain_ms=main_v["plain_ms"], bound_ms=main_v["bound_ms"],
        bound_by=main_v["bound_by"], library_ms=None, variants=variants)
    print(f"grad_quant_hist0: exact; {variants}")

    # B2 hist_routed_fused, given the row-major bins as the growers give
    # it, on four levels: a first level (every row in leaf 0, S = 1), S = 32
    # and 127 (leaf ids over [0, 2S), leaves < S split, one child of each
    # kept: about a quarter of the rows), and S = 127 skewed (half the rows
    # moved into leaf 0, whose left child is kept); nch in {3, 2}. Bounds
    # count what the data needs: leaf ids in and out, the split bin of each
    # routed row, the kept rows' bins and channels, the histogram, tables
    na_bin = torch.full((F,), 256, dtype=torch.int32, device=dev)
    na_bin[:10] = 62
    rowmajor = bins_T.t().contiguous()      # the Dataset's bins [N, F]
    variants = []
    for name_, s, skew in (("S1", 1, False), ("S32", 32, False),
                           ("S127", 127, False), ("skew127", 127, True)):
        lid = torch.randint(0, min(L, 2 * s), (N,), generator=g, device=dev,
                            dtype=torch.int64)
        if s == 1:
            lid = torch.zeros_like(lid)
        if skew:
            lid = torch.where(torch.rand(N, generator=g, device=dev) < 0.5,
                              0, lid)
        lid = lid.to(torch.int32)
        k_ = torch.arange(L, device=dev)
        split = k_ < s
        small_left = (torch.rand(L, generator=g, device=dev) < 0.5) \
            | (k_ == 0)
        tab = torch.stack([
            torch.where(split, torch.randint(0, F, (L,), generator=g,
                                             device=dev), -1),
            torch.randint(0, 62, (L,), generator=g, device=dev),
            torch.randint(0, 2, (L,), generator=g, device=dev),
            s + k_,
            torch.where(split & small_left, k_, s),
            torch.where(split & ~small_left, k_, s)]).to(torch.int32) \
            .contiguous()
        routed = int((lid < s).sum())
        kept = int(hk.route_plain(bins_T, lid, tab, na_bin, s)[0].lt(s)
                   .sum())
        for nch, (gq, hq, cq) in ((3, quant3[:3]), (2, (quant2[0], None,
                                                        quant2[2]))):
            args = (bins_T, gq, hq, cq, lid, tab, na_bin, s, B)
            tag = f"hist_routed_fused[{name_},nch={nch}]"
            kh, kl = hk.hist_routed_fused(*args, bins=rowmajor)
            ph, pl_ = hk.hist_routed_fused_plain(*args)
            err = max(exact(f"{tag}.hist", kh, ph),
                      exact(f"{tag}.lid2", kl, pl_))
            del kh, kl, ph, pl_
            ms = time_ms(lambda: hk.hist_routed_fused(*args, bins=rowmajor))
            plain_ms = time_ms(lambda: hk.hist_routed_fused_plain(*args),
                               reps=3)
            bms, by = bound(8 * N + routed + kept * (F + nch)
                            + s * nch * F * B * 4 + 6 * L * 4 + F * 4,
                            kept * F * nch + N * 10)
            variants.append(dict(variant=name_, S=s, nch=nch, kept=kept,
                                 max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by))
            if name_ == "S127" and nch == 3:
                b2_device_ms = device_ms(
                    lambda: hk.hist_routed_fused(*args, bins=rowmajor))
    main_v = next(v for v in variants if v["variant"] == "S127"
                  and v["nch"] == 3)
    kernels["hist_routed_fused"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/hist_routed_fused.cu",
        replaces="lightgbm_tpu/ops/pallas_hist.py:676",
        max_abs_err=max(v["max_abs_err"] for v in variants),
        ms=main_v["ms"], device_ms=b2_device_ms, plain_ms=main_v["plain_ms"],
        bound_ms=main_v["bound_ms"], bound_by=main_v["bound_by"],
        library_ms=None, variants=variants)
    print(f"hist_routed_fused: exact; {variants}")
    del rowmajor, lid, tab

    # B3 leaf_sums_grad and B7 leaf_sums on uniform and on skewed leaf ids
    # (their own generator, so the other phases' inputs stay as they were):
    # counts exactly, g and h within 1e-6 * sum|x| of the leaf's rows (both
    # sum the same f32 rows in f64, in different orders), two launches bit
    # for bit; timed by events and by the device time of their kernels
    # alone, beside an index_add_ of the rows
    gen_leaves = torch.Generator(device=dev).manual_seed(7)

    def leaf_sums_phase(nm, fn, plain, make_args, ghc, lid_uniform, ops_row,
                        replaces):
        variants = []
        skewed = skewed_leaves(N, L, lambda n: torch.rand(
            n, generator=gen_leaves, device=dev))
        for leaves, lid in (("uniform", lid_uniform), ("skewed", skewed)):
            args = make_args(lid)
            ks, ks2, ps = fn(*args), fn(*args), plain(*args)
            if not torch.equal(ks.view(torch.int32), ks2.view(torch.int32)):
                fail(f"{nm}[{leaves}]: two launches differ in their bits")
            lid_l = lid.long()
            mass = torch.zeros(3, L, dtype=torch.float64, device=dev) \
                .index_add_(1, lid_l, ghc.abs().double())
            err = (ks.double() - ps.double()).abs()
            if bool((err > 1e-6 * mass + 1e-30).any()) or not torch.equal(
                    ks[2], ps[2]):
                fail(f"{nm}[{leaves}]: kernel vs plain error "
                     f"{float(err.max())} exceeds 1e-6 of the leaf's row "
                     "mass (or the counts differ)")
            split = device_split(lambda: fn(*args))
            bms, by = bound(16 * N + 3 * L * 4, ops_row * N)
            variants.append(dict(
                leaves=leaves, largest_leaf_share=float(
                    torch.bincount(lid_l, minlength=L).max()) / N,
                max_abs_err=float(err.max()), ms=time_ms(lambda: fn(*args)),
                device_ms=None if split is None else sum(split.values()),
                device_ms_by_kernel=split,
                plain_ms=time_ms(lambda: plain(*args)), bound_ms=bms,
                bound_by=by, library_ms=time_ms(
                    lambda: torch.zeros(3, L, device=dev).index_add_(
                        1, lid_l, ghc))))
        v = variants[0]
        kernels[nm] = dict(
            route="cuda", source=f"lightgbm_tpu_torch/csrc/{nm}.cu",
            replaces=replaces,
            max_abs_err=max(x["max_abs_err"] for x in variants),
            **{k: v[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            variants=variants)
        print(f"{nm}: counts exact, two launches bit-identical; {variants}")

    grad, hess = hk.grad_rows(logloss, score, label_pos)
    ghc = torch.stack([grad * bag, hess * bag, (bag > 0).float()])
    lid = torch.randint(0, L, (N,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    leaf_sums_phase(
        "leaf_sums_grad", hk.leaf_sums_grad, hk.leaf_sums_grad_plain,
        lambda lid_: (score, label_pos, bag, lid_, logloss, L), ghc, lid, 45,
        "lightgbm_tpu/ops/pallas_hist.py:1036")

    # B4 take_small, with out-of-range indices
    table = torch.randn(L, generator=g, device=dev)
    idx = torch.randint(-2, L + 3, (N,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    err = exact("take_small", hk.take_small(table, idx),
                hk.take_small_plain(table, idx))
    padded = torch.cat([table, torch.zeros(1, device=dev)])
    idx_in = torch.where((idx >= 0) & (idx < L), idx, L).to(torch.int32)
    bms, by = bound(8 * N + 4 * L, 0)
    kernels["take_small"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/take_small.cu",
        replaces="lightgbm_tpu/ops/pallas_hist.py:1213", max_abs_err=err,
        ms=time_ms(lambda: hk.take_small(table, idx)),
        device_ms=device_ms(lambda: hk.take_small(table, idx)),
        plain_ms=time_ms(lambda: hk.take_small_plain(table, idx)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: padded.index_select(0, idx_in)),
        library_device_ms=device_ms(lambda: padded.index_select(0,
                                                                idx_in)))
    print(f"take_small: exact; {kernels['take_small']}")
    del bins_T, idx, idx_in
    torch.cuda.empty_cache()

    # B5 / B6 at B = 256: route_level gives hist_q8 its slot vector, as on
    # the main path. Route tables: leaves 0 .. S-1 split (NA bins on ten
    # features, both missing directions), the others do not; leaf ids in
    # [0, 2S), so about half the rows sit in dropped slots or leaves that
    # do not split.
    bins_w = torch.randint(0, BW, (F, N), generator=g, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    na_w = torch.full((F,), 256, dtype=torch.int32, device=dev)
    na_w[:5] = 0
    na_w[5:10] = BW - 1
    rvariants, slots, route_counts = [], {}, {}
    for s in (32, 127):
        lid = torch.randint(0, min(L, 2 * s), (N,), generator=g, device=dev,
                            dtype=torch.int64).to(torch.int32)
        k_ = torch.arange(L, device=dev)
        split = k_ < s
        small_left = torch.rand(L, generator=g, device=dev) < 0.5
        tab = torch.stack([
            torch.where(split, torch.randint(0, F, (L,), generator=g,
                                             device=dev), -1),
            torch.randint(0, BW - 1, (L,), generator=g, device=dev),
            torch.randint(0, 2, (L,), generator=g, device=dev),
            s + k_,
            torch.where(split & small_left, k_, s),
            torch.where(split & ~small_left, k_, s)]).to(torch.int32) \
            .contiguous()
        args = (bins_w, lid, tab, na_w, s)
        ks, kl, kc = hk.route_level(*args)
        ps_, pl_, pc_ = hk.route_plain(*args)
        err = max(exact(f"route_level[S={s}].slot", ks, ps_),
                  exact(f"route_level[S={s}].lid2", kl, pl_),
                  exact(f"route_level[S={s}].counts", kc, pc_))
        kept = ks[(ks >= 0) & (ks < s)].long()
        exact(f"route_level[S={s}].counts vs bincount", kc,
              torch.bincount(kept, minlength=s).to(torch.int32))
        routed = int((lid < s).sum())
        ms = time_ms(lambda: hk.route_level(*args))
        plain_ms = time_ms(lambda: hk.route_plain(*args), reps=3)
        # lid in, slot and lid2 out, one bin byte a routed row, the counts,
        # tables (PERF.md states beside it the split-bin gather's practical
        # floor, a 32-byte sector of bins_T a routed row)
        bms, by = bound(12 * N + routed + 4 * s + 6 * L * 4 + F * 4, 8 * N)
        rvariants.append(dict(
            S=s, routed=routed, kept=int(kept.numel()), max_abs_err=err,
            ms=ms, device_ms=device_ms(lambda: hk.route_level(*args)),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        slots[s], route_counts[s] = ks, kc
        del lid, ps_, pl_, pc_, kl, kept
    main_v = rvariants[-1]
    kernels["route_level"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/route_level.cu",
        replaces="lightgbm_tpu/ops/pallas_hist.py:1138",
        max_abs_err=max(v["max_abs_err"] for v in rvariants),
        ms=main_v["ms"], device_ms=main_v["device_ms"],
        plain_ms=main_v["plain_ms"], bound_ms=main_v["bound_ms"],
        bound_by=main_v["bound_by"], library_ms=None, variants=rvariants)
    print(f"route_level: exact; {rvariants}")

    # B5 hist_q8 and B8 hist_f32 over shared slot vectors at B = 256: the
    # root (S = 1, no slot vector), the slots route_level gave at S = 32
    # and 127 (about half the rows dropped), a skewed level (S = 127, about
    # half the kept rows moved into slot 0) and two lossguide-shaped passes
    # (S = 1 over a slot vector keeping about 5% and 0.5% of the rows); B8
    # also at B = 64, S = 127. hist_q8 (3 and 2 channels) exactly; hist_f32
    # on the logloss rows (g, h, count): counts exactly (integers below 2^24
    # are exact in any f32 order), g and h within 2^-15 of the cell's
    # absolute mass against the plain version's f64 sums. The yardstick of
    # each is one index_add_ of the kept rows' channels (widened to int32
    # for hist_q8) into a [nch, S * F * B] table over flat cell indices
    # precomputed for the kept rows: the same sums, channel-first. Bounds
    # count the bytes this data needs: the slot vector, and the bins and
    # channels of the kept rows only
    # S = 32 and 127 are handed route_level's counts, as on the main path,
    # and each is held against the same call without them (its own count
    # pass): hist_q8 exactly, hist_f32 within 2^-15 of the cell's mass
    u = torch.rand(N, generator=g, device=dev)
    slot_vars = {
        "root": (None, 1), "S32": (slots[32], 32), "S127": (slots[127], 127),
        "skew127": (torch.where((slots[127] < 127) & (u < 0.5), 0,
                                slots[127]).to(torch.int32), 127),
        "lossguide5%": ((u >= 0.05).to(torch.int32), 1),
        "lossguide0.5%": ((u >= 0.005).to(torch.int32), 1)}
    del u
    rows = tuple(x.contiguous() for x in ghc)
    abs_rows = (rows[0].abs(), rows[1].abs(), rows[2])
    qvariants, fvariants = [], []
    for name_, (slot, s), b_ in [(k, v, BW) for k, v in slot_vars.items()] \
            + [("S127", slot_vars["S127"], B)]:
        bins_s = bins_w if b_ == BW else (bins_w & (b_ - 1))
        rowmajor = bins_s.t().contiguous()    # the Dataset's bins [N, F]
        keep = (torch.ones(N, dtype=torch.bool, device=dev) if slot is None
                else (slot >= 0) & (slot < s))
        kept = int(keep.sum())
        ridx = keep.nonzero().squeeze(1)
        sl = (torch.zeros_like(ridx) if slot is None else slot[ridx].long())
        flat = ((sl[None, :] * F + torch.arange(F, device=dev)[:, None])
                * b_ + bins_s[:, ridx].long()).reshape(-1)
        del sl
        slot_bytes = 0 if slot is None else 4 * N
        base = dict(variant=name_, S=s, B=b_, kept=kept)
        counts = route_counts.get(s) if name_ in ("S32", "S127") else None

        def yardstick(chans, dtype):
            src = torch.stack(chans)[:, ridx].to(dtype)[:, None, :].expand(
                len(chans), F, kept).reshape(len(chans), -1)

            def call():
                return torch.zeros(len(chans), s * F * b_, dtype=dtype,
                                   device=dev).index_add_(1, flat, src)
            out = call().view(len(chans), s, F, b_).transpose(0, 1)
            return out, time_ms(call)

        for nch, (gq, hq, cq) in (((3, quant3[:3]), (2, (quant2[0], None,
                                                          quant2[2])))
                                  if b_ == BW else ()):
            args = (bins_s, gq, hq, cq, slot, s, b_)
            tag = f"hist_q8[{name_},nch={nch}]"
            ph_ = hk.hist_q8_plain(*args)
            err = exact(tag, hk.hist_q8(*args, bins=rowmajor, counts=counts),
                        ph_)
            extra = {}
            if counts is not None:
                exact(f"{tag} without counts",
                      hk.hist_q8(*args, bins=rowmajor), ph_)
                extra["ms_without_counts"] = time_ms(
                    lambda: hk.hist_q8(*args, bins=rowmajor))
            lib, lib_ms = yardstick([x for x in (gq, hq, cq)
                                     if x is not None], torch.int32)
            exact(f"{tag} index_add_ yardstick", lib.contiguous(), ph_)
            bms, by = bound(slot_bytes + kept * (F + nch)
                            + s * nch * F * b_ * 4, kept * F * nch)
            qvariants.append(dict(
                base, nch=nch, max_abs_err=err,
                counts_given=counts is not None,
                ms=time_ms(lambda: hk.hist_q8(*args, bins=rowmajor,
                                              counts=counts)),
                **extra,
                plain_ms=time_ms(lambda: hk.hist_q8_plain(*args), reps=3),
                bound_ms=bms, bound_by=by, library_ms=lib_ms))
            del ph_, lib

        args = (bins_s, *rows, slot, s, b_)
        tag = f"hist_f32[{name_},B={b_}]"
        ph_ = hk.hist_f32_plain(*args)
        mass = hk.hist_f32_plain(bins_s, *abs_rows, slot, s, b_).double()
        extra, errs = {}, []
        for kw in ({"counts": counts},) + (({},) if counts is not None
                                           else ()):
            kh = hk.hist_f32(*args, bins=rowmajor, **kw)
            err = (kh.double() - ph_.double()).abs()
            if not torch.equal(kh[:, 2], ph_[:, 2]):
                fail(f"{tag}: counts differ from the plain version")
            if bool((err[:, :2] > 2.0 ** -15 * mass[:, :2]).any()):
                fail(f"{tag}: kernel vs plain error {float(err.max())} "
                     "exceeds 2^-15 of the cell's absolute mass")
            errs.append(float(err.max()))
        if counts is not None:
            extra["ms_without_counts"] = time_ms(
                lambda: hk.hist_f32(*args, bins=rowmajor))
        lib, lib_ms = yardstick(list(rows), torch.float32)
        lib_err = (lib.double() - ph_.double()).abs()
        if bool((lib_err[:, :2] > 2.0 ** -15 * mass[:, :2]).any()):
            fail(f"{tag}: the index_add_ yardstick computes another function")
        bms, by = bound(slot_bytes + kept * (F + 12) + s * 3 * F * b_ * 4,
                        kept * F * 3)
        fvariants.append(dict(
            base, max_abs_err=errs[0], counts_given=counts is not None,
            ms=time_ms(lambda: hk.hist_f32(*args, bins=rowmajor,
                                           counts=counts)), **extra,
            plain_ms=time_ms(lambda: hk.hist_f32_plain(*args), reps=3),
            bound_ms=bms, bound_by=by, library_ms=lib_ms))
        del kh, ph_, mass, err, lib, lib_err, ridx, flat, keep, rowmajor
        torch.cuda.empty_cache()
    for nm, variants, extra in (
            ("hist_q8", qvariants, dict(source="lightgbm_tpu_torch/csrc/"
                                        "hist_q8.cu", replaces="lightgbm_tpu/"
                                        "ops/pallas_hist.py:372")),
            ("hist_f32", fvariants, dict(source="lightgbm_tpu_torch/csrc/"
                                         "hist_f32.cu", replaces="lightgbm_"
                                         "tpu/ops/pallas_hist.py:114"))):
        main_v = next(v for v in variants if v["variant"] == "S127"
                      and v["B"] == BW and v.get("nch", 3) == 3)
        kernels[nm] = dict(
            route="cuda", **extra,
            max_abs_err=max(v["max_abs_err"] for v in variants),
            ms=main_v["ms"], plain_ms=main_v["plain_ms"],
            bound_ms=main_v["bound_ms"], bound_by=main_v["bound_by"],
            library_ms=main_v["library_ms"], variants=variants)
        print(f"{nm}: {'exact' if nm == 'hist_q8' else 'counts exact'}; "
              f"{variants}")
    del bins_w, slots, route_counts, counts, slot_vars, slot, bins_s, rows
    del abs_rows, args
    torch.cuda.empty_cache()

    # B7 leaf_sums on the same rows materialized (see B3)
    lid = torch.randint(0, L, (N,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    rows = (ghc[0].contiguous(), ghc[1].contiguous(), ghc[2].contiguous())
    leaf_sums_phase("leaf_sums", hk.leaf_sums, hk.leaf_sums_plain,
                    lambda lid_: rows + (lid_, L), ghc, lid, 3,
                    "lightgbm_tpu/ops/pallas_hist.py:718")
    del score, label_pos, label_reg, bag, lid, ghc, rows
    del quant2, quant3
    torch.cuda.empty_cache()

    # ---- 4. main paths through the public entry points ----
    t0 = time.perf_counter()
    X, y = synth_higgs(N, F, seed=0)
    rng = np.random.RandomState(1)
    y_reg = (X[:, :4] @ np.array([1.0, -0.5, 0.25, 2.0]) + 0.5 * X[:, 4] ** 2
             + 0.1 * rng.randn(N)).astype(np.float32)
    print(f"data: {time.perf_counter() - t0:.3f} s")
    m = min(1_000_000, N)
    launches_all = {k: 0 for k in hk.KERNELS}

    datasets = {}

    def dataset(max_bin: int):
        """The (binary, L2) Datasets of one bin count, constructed once and
        shared by the paths at that bin count."""
        if max_bin not in datasets:
            params = {"max_bin": max_bin, "verbosity": -1}
            t0 = time.perf_counter()
            ds = lt.Dataset(X, label=y, params=params, free_raw_data=False)
            ds.construct()
            torch.cuda.synchronize()
            construct_s = time.perf_counter() - t0
            ds_reg = lt.Dataset(X, label=y_reg, params=params)
            ds_reg.construct()
            torch.cuda.synchronize()
            print(f"[max_bin={max_bin}] construct: {construct_s:.3f} s ({N} x "
                  f"{F}, {ds.num_features} used features, max bins "
                  f"{ds.max_num_bins})")
            datasets[max_bin] = (ds, ds_reg)
        return datasets[max_bin]

    def expected_launches(path: str, trees: int, n_pass: int, added: int):
        """(launch count of every kernel, the path's own kernels)."""
        if path == "fused":
            exp = {"grad_quant_hist0": trees, "leaf_sums_grad": trees,
                   "hist_routed_fused": n_pass}
        elif path == "unfused":
            exp = {"hist_q8": trees + n_pass, "route_level": n_pass,
                   "leaf_sums": trees}
        elif path == "f32":
            exp = {"hist_f32": trees + n_pass, "route_level": n_pass}
        else:
            exp = {"hist_f32": trees + n_pass}
        exp["take_small"] = added
        return {k: exp.get(k, 0) for k in hk.KERNELS}, tuple(exp)

    def main_path(path: str) -> None:
        max_bin, extra, iters = PATHS[path]
        params = {"objective": "binary", "num_leaves": L, "max_bin": max_bin,
                  "learning_rate": 0.1, "min_data_in_leaf": 20,
                  "verbosity": -1, **extra}
        reg_params = dict(params, objective="regression")
        ds, ds_reg = dataset(max_bin)
        tag = f"[{path}, max_bin={max_bin}]"

        hk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bst = lt.train(params, ds, num_boost_round=iters)
        torch.cuda.synchronize()
        bin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reg = lt.train(reg_params, ds_reg, num_boost_round=2)
        torch.cuda.synchronize()
        reg_s = time.perf_counter() - t0
        launches = dict(hk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        passes = bst._gbdt.hist_passes + reg._gbdt.hist_passes
        trees, n_pass = len(passes), sum(passes)
        added = bst.num_trees() + reg.num_trees()
        expected, own = expected_launches(path, trees, n_pass, added)
        what = "splits" if path == "lossguide" else "level passes"
        print(f"{tag} train binary: {bin_s:.3f} s for {iters} iterations "
              f"({bin_s / iters:.3f} s/iter), {what} a tree "
              f"{bst._gbdt.hist_passes}; L2: {reg_s:.3f} s for 2 "
              f"({reg_s / 2:.3f} s/iter), {what} {reg._gbdt.hist_passes}")
        if path == "lossguide":
            # one host sync a split step, plus the step that finds no
            # split when a tree stops short of num_leaves
            syncs = [p + (p < L - 1) for p in passes]
            print(f"{tag} host syncs a tree (split steps): {syncs}")
        print(f"{tag} launches {launches} expected {expected}")
        print(f"{tag} peak device memory in training: {peak} bytes "
              f"({peak / 2 ** 30:.3f} GiB; torch.cuda.max_memory_allocated, "
              "both Datasets of the bin count resident)")
        if launches != expected or min(launches[k] for k in own) <= 0:
            fail(f"{path}: launch counts {launches} != expected {expected}")
        for k, v in launches.items():
            launches_all[k] += v
        gp = bst._gbdt.gp
        want = {"fused": (True, True), "unfused": (True, False),
                "f32": (False, False), "lossguide": (False, False)}[path]
        if (gp.quant, gp.fused_obj is not None) != want or (
                not gp.quant and reg._gbdt.gp.const_hess):
            fail(f"{path}: the booster took the wrong front (quant "
                 f"{gp.quant}, fused {gp.fused_obj})")

        prob = bst.predict(X[:m])
        if prob.shape != (m,) or not np.isfinite(prob).all():
            fail(f"{path}: binary predictions are not finite [1M] values")
        auc = float(metrics.auc(torch.as_tensor(y[:m]),
                                torch.as_tensor(prob)))
        print(f"{tag} train AUC on 1M rows: {auc:.6f}")
        if not auc > 0.7:
            fail(f"{path}: train AUC {auc} <= 0.7")
        reg_pred = reg.predict(X[:m])
        mse0 = float(np.mean((y_reg[:m] - y_reg.mean()) ** 2))
        mse = float(np.mean((y_reg[:m] - reg_pred) ** 2))
        print(f"{tag} L2 model: train mse {mse:.6f} vs label variance "
              f"{mse0:.6f}")
        if not (np.isfinite(reg_pred).all() and mse < mse0):
            fail(f"{path}: L2 model did not reduce the squared error")
        os.makedirs(OUT_DIR, exist_ok=True)
        fname = os.path.join(OUT_DIR, f"chip_smoke_model_{path}.txt")
        bst.save_model(fname)
        loaded = lt.Booster(model_file=fname)
        if not np.array_equal(loaded.predict(X[:m], raw_score=True),
                              bst.predict(X[:m], raw_score=True)):
            fail(f"{path}: saved and loaded model predict differently")
        print(f"{tag} model text round trip: predictions identical")

    for path in PATHS:
        main_path(path)
    del datasets
    for nm in kernels:
        kernels[nm]["launches"] = launches_all[nm]

    # ---- 5. card vs plain versions on a small input ----
    Xs, ys = X[:4000], y_reg[:4000]
    for max_bin, fused in ((63, True), (255, False)):
        small = {"objective": "regression", "num_leaves": 31,
                 "max_bin": max_bin, "min_data_in_leaf": 20,
                 "verbosity": -1}
        hk.reset_launches()
        gpu = lt.train(small, lt.Dataset(Xs, label=ys, params=small), 1)
        took = [k for k in (FUSED if fused else UNFUSED)
                if hk.LAUNCHES[k] > 0]
        if (gpu._gbdt.gp.fused_obj is None) == fused or len(took) != 3:
            fail(f"max_bin={max_bin}: the 4000-row model did not take the "
                 f"{'fused' if fused else 'two-pass'} path "
                 f"({dict(hk.LAUNCHES)})")
        cpu_p = dict(small, device_type="cpu")
        cpu = lt.train(cpu_p, lt.Dataset(Xs, label=ys, params=cpu_p), 1)
        (a,), (b,) = gpu._host_trees(), cpu._host_trees()
        for f_ in ("split_feature", "threshold_bin", "default_left",
                   "left_child", "right_child"):
            if not np.array_equal(getattr(a, f_), getattr(b, f_)):
                fail(f"max_bin={max_bin}: card and CPU trees differ in {f_}")
        # absolute bound on the tree's scale: a leaf whose value nearly
        # cancels against the init bias would inflate a 1-ulp sum
        # difference relative
        diff = float(np.abs(a.leaf_value - b.leaf_value).max())
        scale = float(np.abs(b.leaf_value).max())
        print(f"[max_bin={max_bin}] card vs CPU (4000 rows, max bins "
              f"{gpu.train_set.max_num_bins}, first tree, {a.num_leaves} "
              f"leaves): structure identical, max leaf-value diff "
              f"{diff:.3e} (largest leaf {scale:.3e})")
        if diff > 1e-6 * scale:
            fail(f"max_bin={max_bin}: card and CPU leaf values differ by "
                 "more than 1e-6 of the largest leaf value")

    # paths (c) and (d) on exact-sum data: labels on a 1/8 grid in [0, 4)
    # and no init score, so the first tree's gradients are -label and
    # h = 1; every histogram sum is exact in any order, and the first tree
    # must equal the CPU's bit for bit
    y8 = np.clip(np.floor((Xs[:, 0] + 2.0) * 8) / 8, 0, 3.875).astype(
        np.float32)
    for path in ("f32", "lossguide"):
        for max_bin in (63, 255):
            small = {"objective": "regression", "num_leaves": 31,
                     "max_bin": max_bin, "min_data_in_leaf": 20,
                     "verbosity": -1, "boost_from_average": False,
                     **PATHS[path][1]}
            hk.reset_launches()
            gpu = lt.train(small, lt.Dataset(Xs, label=y8, params=small), 1)
            other = sum(v for k, v in hk.LAUNCHES.items()
                        if k not in ("hist_f32", "route_level", "take_small"))
            if hk.LAUNCHES["hist_f32"] < 2 or other:
                fail(f"{path}, max_bin={max_bin}: the 4000-row model did "
                     f"not take its path ({dict(hk.LAUNCHES)})")
            cpu_p = dict(small, device_type="cpu")
            cpu = lt.train(cpu_p, lt.Dataset(Xs, label=y8, params=cpu_p), 1)
            (a,), (b,) = gpu._host_trees(), cpu._host_trees()
            for f_ in ("split_feature", "threshold_bin", "default_left",
                       "left_child", "right_child", "leaf_value",
                       "leaf_weight", "leaf_count"):
                if not np.array_equal(getattr(a, f_), getattr(b, f_)):
                    fail(f"{path}, max_bin={max_bin}: card and CPU first "
                         f"trees differ in {f_} on exact-sum data")
            print(f"[{path}, max_bin={max_bin}] card vs CPU on exact-sum "
                  f"data (4000 rows, max bins {gpu.train_set.max_num_bins},"
                  f" first tree, {a.num_leaves} leaves): identical, leaf "
                  "values included")

    print(f"card: {card}")
    print(json.dumps({"kernels": [dict(name=nm, **v)
                                  for nm, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
