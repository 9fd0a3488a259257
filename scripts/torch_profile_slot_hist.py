#!/usr/bin/env python3
"""Where the two slot histograms (hist_q8, hist_f32) spend their device time.

Run from the repository root on a machine with one CUDA GPU:

    python3 scripts/torch_profile_slot_hist.py [--rows N] [--min-rows M ...]

At chip_smoke.py's phase-3 shapes (N x 28 bins over [0, 256)), for each slot
variant (the root without a slot vector; S = 127 keeping about a quarter of
the rows, as route_level's slots do; that level skewed, half of its kept
rows in one slot; lossguide-shaped passes keeping about 5% and 0.5%), it
times hist_q8 (3 channels) and hist_f32 with CUDA events (median of 7) and
splits the device time of 5 calls among their CUDA kernels (count, scan,
scatter, histogram, and the zeroing of the outputs) with torch.profiler.
With --min-rows it repeats each variant with the planner's floor of entries
a histogram block takes (ops/hist_kernels.py slot_hist_plan) replaced by
each value given. Prints the card's name and power limit first, then one
JSON line per (variant, kernel, floor).
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, B = 28, 256


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--min-rows", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    n, dev = args.rows, torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64)
    bins_T = randint(0, B, (F, n)).to(torch.uint8)
    bins = bins_T.t().contiguous()        # the Dataset's row-major bins
    q8 = [randint(-127, 128, (n,)).to(torch.int8),
          randint(0, 128, (n,)).to(torch.int8),
          (torch.rand(n, generator=g, device=dev) < 0.9).to(torch.int8)]
    rows = [torch.randn(n, generator=g, device=dev) * q8[2],
            torch.rand(n, generator=g, device=dev) * q8[2], q8[2].float()]
    u = torch.rand(n, generator=g, device=dev)
    s127 = randint(0, 4 * 127, (n,)).to(torch.int32)
    variants = {
        "root": (None, 1), "S127": (s127, 127),
        "skew127": (torch.where((s127 < 127) & (u < 0.5), 0, s127)
                    .to(torch.int32), 127),
        "lossguide5%": ((u >= 0.05).to(torch.int32), 1),
        "lossguide0.5%": ((u >= 0.005).to(torch.int32), 1)}
    plan0 = hk.slot_hist_plan

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    for floor in [None] + args.min_rows:
        hk.slot_hist_plan = (plan0 if floor is None else
                             lambda *a, m=floor: plan0(*a)._replace(
                                 min_rows=m))
        for name, (slot, s) in variants.items():
            kept = n if slot is None else int(((slot >= 0) & (slot < s))
                                              .sum())
            for kernel, fn in (
                    ("hist_q8", lambda: hk.hist_q8(bins_T, *q8, slot, s, B,
                                                   bins)),
                    ("hist_f32", lambda: hk.hist_f32(bins_T, *rows, slot, s,
                                                     B, bins))):
                ms = time_ms(fn)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize()
                split = {}
                for ev in prof.key_averages():
                    us = getattr(ev, "device_time_total", None)
                    if us is None:
                        us = getattr(ev, "cuda_time_total", 0.0)
                    if us <= 0 or ev.device_type.name != "CUDA":
                        continue
                    m = re.search(r"(\w+)\(", ev.key)
                    key = m.group(1) if m else ev.key
                    split[key] = split.get(key, 0.0) + us / 5
                print(json.dumps(dict(
                    variant=name, kernel=kernel, S=s, kept=kept,
                    min_rows=plan0(F, n, 3, B, hk._num_sms(dev)).min_rows
                    if floor is None else floor, ms=ms,
                    device_us_by_kernel=split, card=card)), flush=True)
    hk.slot_hist_plan = plan0
    return 0


if __name__ == "__main__":
    sys.exit(main())
