#!/usr/bin/env python3
"""Where the slot histograms (hist_q8, hist_f32, hist_routed_fused), the
fused front grad_quant_hist0 and the level routing route_level spend their
device time.

Run from the repository root on a machine with one CUDA GPU:

    python3 scripts/torch_profile_slot_hist.py [--rows N] [--min-rows M ...]
        [--only slots|b1|b2|b6] [--port DIR]

Sections (all four without --only):

- slots: at chip_smoke.py's phase-3 shapes (N x 28 bins over [0, 256)), for
  each slot variant (the root without a slot vector; S = 127 keeping about
  a quarter of the rows, as route_level's slots do; that level skewed, half
  of its kept rows in one slot; lossguide-shaped passes keeping about 5%
  and 0.5%), hist_q8 (3 channels) and hist_f32. With --min-rows it repeats
  each variant with the planner's floor of entries a histogram block takes
  (ops/hist_kernels.py slot_hist_plan) replaced by each value given.
- b1: grad_quant_hist0 at B = 64 (bins over [0, 63)) on chip_smoke.py's
  inputs, logloss (3 channels) and L2 (2 channels): its max pass and its
  quantize + histogram pass.
- b2: the fused level pass hist_routed_fused at B = 64 on four levels, 3
  and 2 channels: a first level (every row in leaf 0, S = 1), S = 32 and
  S = 127 (leaf ids over [0, 2S), leaves < S split, one child of each
  kept), and S = 127 skewed (half the rows moved into leaf 0), split among
  route and count, scan, scatter and histogram.
- b6: the two-pass level at B = 256 on chip_smoke.py's route_level inputs
  (S = 32 and 127, NA bins, about half the rows in dropped slots or leaves
  that do not split): route_level alone, then hist_q8 (3 channels) and
  hist_f32 over its slots, each given route_level's per-slot counts (no
  count pass) and not given them (their own count pass). A checkout whose
  route_level returns no counts runs the second form only. Then
  route_level's kernel by level width, S = 1, 2, 4, ..., 127, every row
  routed (every row in a leaf < S, every such leaf split, one child of
  each kept).

Each call is timed with CUDA events (median of 7), and the device time of
10 calls is split among its CUDA kernels (the zeroing of outputs included)
with torch.profiler (chip_smoke.py time_ms and device_split). --port DIR
profiles the lightgbm_tpu_torch of another checkout (for example the
parent commit unpacked with git archive); run it once a checkout in one
call to compare them. Prints the card's name and power limit first, then
one JSON line per (section, variant, kernel).
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, B, L = 28, 256, 255


def level_tables(randint, rand, leaves, s, f, b, first_small_left=False):
    """[6, L] route tables of a level with S slots: leaves < S split on a
    random feature at a threshold below b - 1, one child of each kept (the
    left one of leaf 0 with first_small_left)."""
    import torch
    k = torch.arange(leaves, device=rand(1).device)
    split = k < s
    small_left = rand(leaves) < 0.5
    if first_small_left:
        small_left |= k == 0
    return torch.stack([
        torch.where(split, randint(0, f, (leaves,)), -1),
        randint(0, b - 1, (leaves,)), randint(0, 2, (leaves,)),
        s + k, torch.where(split & small_left, k, s),
        torch.where(split & ~small_left, k, s)]).to(torch.int32) \
        .contiguous()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--min-rows", type=int, nargs="*", default=[])
    ap.add_argument("--only", choices=("slots", "b1", "b2", "b6"),
                    default=None)
    ap.add_argument("--port", default=HERE)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, HERE)
    from chip_smoke import device_split, time_ms
    from torch_ab_train import load_port
    hk = load_port(args.port, "lightgbm_tpu_torch_profiled").ops.hist_kernels
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    n, dev = args.rows, torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    sms = hk._num_sms(dev)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64)

    def rand(size):
        return torch.rand(size, generator=g, device=dev)

    def report(section, variant, kernel, fn, **extra):
        print(json.dumps(dict(
            section=section, variant=variant, kernel=kernel, **extra,
            ms=time_ms(fn), device_ms_by_kernel=device_split(fn),
            port=os.path.abspath(args.port), card=card)), flush=True)

    def q8_chans(b):
        """bins_T over [0, b), its row-major copy, int8 g, h, count."""
        bins_T = randint(0, b, (F, n)).to(torch.uint8)
        return bins_T, bins_T.t().contiguous(), [
            randint(-127, 128, (n,)).to(torch.int8),
            randint(0, 128, (n,)).to(torch.int8),
            (rand(n) < 0.9).to(torch.int8)]

    if args.only in (None, "slots"):
        bins_T, bins, q8 = q8_chans(B)
        rows = [torch.randn(n, generator=g, device=dev) * q8[2],
                rand(n) * q8[2], q8[2].float()]
        u = rand(n)
        s127 = randint(0, 4 * 127, (n,)).to(torch.int32)
        variants = {
            "root": (None, 1), "S127": (s127, 127),
            "skew127": (torch.where((s127 < 127) & (u < 0.5), 0, s127)
                        .to(torch.int32), 127),
            "lossguide5%": ((u >= 0.05).to(torch.int32), 1),
            "lossguide0.5%": ((u >= 0.005).to(torch.int32), 1)}
        plan0 = hk.slot_hist_plan
        for floor in [None] + args.min_rows:
            hk.slot_hist_plan = (plan0 if floor is None else
                                 lambda *a, m=floor: plan0(*a)._replace(
                                     min_rows=m))
            for name, (slot, s) in variants.items():
                kept = n if slot is None else int(((slot >= 0) & (slot < s))
                                                  .sum())
                plan = hk.slot_hist_plan(F, n, 3, B, sms)._asdict()
                report("slots", name, "hist_q8",
                       lambda: hk.hist_q8(bins_T, *q8, slot, s, B, bins),
                       S=s, B=B, kept=kept, plan=plan)
                report("slots", name, "hist_f32",
                       lambda: hk.hist_f32(bins_T, *rows, slot, s, B, bins),
                       S=s, B=B, kept=kept, plan=plan)
        hk.slot_hist_plan = plan0
        del q8, rows, variants, bins_T, bins, s127, u
        torch.cuda.empty_cache()

    if args.only in (None, "b1"):
        # chip_smoke.py's B1 inputs: bins over [0, 63), score N(0, 0.25),
        # a 0/1 label, a bag keeping 90% of the rows
        bins_T = randint(0, 63, (F, n)).to(torch.uint8)
        score = torch.randn(n, generator=g, device=dev) * 0.5
        label_pos = (rand(n) < 0.5).float()
        label_reg = torch.randn(n, generator=g, device=dev)
        bag = (rand(n) < 0.9).float()
        for spec, aux, ch in ((("logloss", 1.0, 1.0, 1.0), label_pos, False),
                              (("l2",), label_reg, True)):
            report("b1", spec[0], "grad_quant_hist0",
                   lambda: hk.grad_quant_hist0(bins_T, score, aux, bag, 7,
                                               spec, 64, ch),
                   B=64, nch=2 if ch else 3)
        del bins_T, score, label_pos, label_reg, bag
        torch.cuda.empty_cache()

    if args.only in (None, "b2"):
        # B2 at B = 64: the fused quantized path's level pass
        b2 = 64
        bins_T, bins, q8 = q8_chans(b2 - 1)
        na_bin = torch.full((F,), 256, dtype=torch.int32, device=dev)
        na_bin[:10] = b2 - 2
        levels = {"S1": (1, False), "S32": (32, False), "S127": (127, False),
                  "skew127": (127, True)}
        for name, (s, skew) in levels.items():
            tab = level_tables(randint, rand, L, s, F, b2 - 1, True)
            lid = randint(0, min(L, 2 * s), (n,))
            if s == 1:
                lid = torch.zeros_like(lid)
            if skew:
                lid = torch.where(rand(n) < 0.5, 0, lid)
            lid = lid.to(torch.int32)
            kept = int(hk.route_plain(bins_T, lid, tab, na_bin, s)[0].lt(s)
                       .sum())
            for nch in (3, 2):
                chans = (q8[0], q8[1] if nch == 3 else None, q8[2])
                report("b2", name, "hist_routed_fused",
                       lambda: hk.hist_routed_fused(bins_T, *chans, lid, tab,
                                                    na_bin, s, b2, bins),
                       S=s, B=b2, nch=nch, kept=kept,
                       plan=hk.slot_hist_plan(F, n, nch, b2, sms)._asdict())
        del bins_T, bins, q8
        torch.cuda.empty_cache()

    if args.only in (None, "b6"):
        # chip_smoke.py's route_level inputs at B = 256: NA bins 0 and 255
        bins_T, bins, q8 = q8_chans(B)
        rows = [torch.randn(n, generator=g, device=dev) * q8[2],
                rand(n) * q8[2], q8[2].float()]
        na_bin = torch.full((F,), 256, dtype=torch.int32, device=dev)
        na_bin[:5] = 0
        na_bin[5:10] = B - 1
        for s in (32, 127):
            lid = randint(0, min(L, 2 * s), (n,)).to(torch.int32)
            tab = level_tables(randint, rand, L, s, F, B)
            out = hk.route_level(bins_T, lid, tab, na_bin, s)
            slot, counts = out[0], (out[2] if len(out) > 2 else None)
            kept = int(((slot >= 0) & (slot < s)).sum())
            report("b6", f"S{s}", "route_level",
                   lambda: hk.route_level(bins_T, lid, tab, na_bin, s),
                   S=s, B=B, routed=int((lid < s).sum()), kept=kept)
            for given in ((True, False) if counts is not None else (False,)):
                kw = {"counts": counts} if given else {}
                report("b6", f"S{s}", "hist_q8",
                       lambda: hk.hist_q8(bins_T, *q8, slot, s, B, bins,
                                          **kw),
                       S=s, B=B, kept=kept, counts_given=given)
                report("b6", f"S{s}", "hist_f32",
                       lambda: hk.hist_f32(bins_T, *rows, slot, s, B, bins,
                                           **kw),
                       S=s, B=B, kept=kept, counts_given=given)
        del q8, rows
        for s in (1, 2, 4, 8, 16, 32, 64, 127):
            k = torch.arange(L, device=dev)
            tab = level_tables(randint, rand, L, s, F, B)
            tab[0] = torch.where(k < s, randint(0, F, (L,)), -1)
            tab[4] = torch.where(k < s, k, s)     # the left child kept
            tab[5] = s
            lid = randint(0, s, (n,)).to(torch.int32)
            report("b6", f"routed_S{s}", "route_level",
                   lambda: hk.route_level(bins_T, lid, tab, na_bin, s),
                   S=s, B=B, routed=n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
