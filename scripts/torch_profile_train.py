#!/usr/bin/env python3
"""Where one training iteration of the PyTorch/CUDA port spends its time.

Run from the repository root on a machine with one CUDA GPU:

    python3 scripts/torch_profile_train.py [--rows N] [--iters K]
        [--max-bin 63|255] [--grow-policy depthwise|lossguide]
        [--quant auto|true|false]

It builds a main-path configuration of chip_smoke.py (HIGGS-shaped N x 28
table, num_leaves=255, learning_rate=0.1, min_data_in_leaf=20) at
max_bin=63 (B = 64: the fused path) or at the default max_bin=255 (B = 256:
the unfused path), with the depthwise grower (quantized unless --quant
false) or the leaf-wise one (--grow-policy lossguide, never quantized),
trains two warm-up iterations, then traces K iterations of the binary and
of the L2 model with torch.profiler (CUDA and CPU activity). For each it
prints one JSON line: the wall time per iteration, the device time per
iteration by kernel group (each hand-written kernel, everything else), the
device busy share, and the histogram passes per tree after the root (one
per level, or per split under lossguide). Prints the card's name and
power limit first.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel group -> the exact names of its CUDA kernel functions (the slot
# histograms' compaction passes, the fused level pass's route and count,
# and the leaf sums' final pass count as their kernel's time)
GROUPS = (("grad_quant_hist0", ("max_kernel", "quant_hist_kernel")),
          ("hist_routed_fused", ("hist_routed_count_kernel",
                                 "hist_routed_scan_kernel",
                                 "hist_routed_scatter_kernel",
                                 "hist_routed_kernel")),
          ("leaf_sums_grad", ("leaf_sums_grad_rows_kernel",
                              "leaf_sums_grad_final_kernel",
                              "leaf_sums_grad_global_kernel")),
          ("take_small", ("take_kernel",)),
          ("hist_q8", ("hist_q8_count_kernel", "hist_q8_scan_kernel",
                       "hist_q8_scatter_kernel", "hist_q8_kernel")),
          ("route_level", ("route_level_kernel",)),
          ("leaf_sums", ("leaf_sums_rows_kernel", "leaf_sums_final_kernel",
                         "leaf_sums_global_kernel")),
          ("hist_f32", ("hist_f32_count_kernel", "hist_f32_scan_kernel",
                        "hist_f32_scatter_kernel", "hist_f32_kernel")))


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


def group_of(name: str) -> str:
    """The group of a profiler event by its function's own name (the last
    identifier before the argument list), matched exactly."""
    m = re.search(r"(\w+)\(", name)
    fn = m.group(1) if m else name
    for group, keys in GROUPS:
        if fn in keys:
            return group
    return "other (split search, glue)"


def profile_iters(booster, iters: int):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_group = {}
    launches = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us <= 0 or ev.device_type.name != "CUDA":
            continue
        g = group_of(ev.key)
        by_group[g] = by_group.get(g, 0.0) + dev_us / 1e3 / iters
        launches[g] = launches.get(g, 0) + ev.count
    busy = sum(by_group.values())
    return {"wall_ms_per_iter": wall * 1e3 / iters,
            "device_ms_per_iter": by_group,
            "device_launches": launches,
            "device_busy_share": busy / (wall * 1e3 / iters)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max-bin", type=int, default=63, choices=(63, 255))
    ap.add_argument("--grow-policy", default="depthwise",
                    choices=("depthwise", "lossguide"))
    ap.add_argument("--quant", default="auto",
                    choices=("auto", "true", "false"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import lightgbm_tpu_torch as lt
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    X, y = synth_higgs(args.rows)
    rng = np.random.RandomState(1)
    y_reg = (X[:, :4] @ np.array([1.0, -0.5, 0.25, 2.0]) + 0.5 * X[:, 4] ** 2
             + 0.1 * rng.randn(args.rows)).astype(np.float32)
    base = {"num_leaves": 255, "max_bin": args.max_bin, "learning_rate": 0.1,
            "min_data_in_leaf": 20, "verbosity": -1,
            "grow_policy": args.grow_policy,
            "use_quantized_grad": args.quant}
    for objective, label in (("binary", y), ("regression", y_reg)):
        params = dict(base, objective=objective)
        ds = lt.Dataset(X, label=label, params=params)
        t0 = time.perf_counter()
        ds.construct()
        torch.cuda.synchronize()
        construct_s = time.perf_counter() - t0
        bst = lt.Booster(params=params, train_set=ds)
        for _ in range(2):
            bst.update()
        res = profile_iters(bst, args.iters)
        res.update(objective=objective, rows=args.rows,
                   max_bin=args.max_bin, grow_policy=args.grow_policy,
                   quant=bst._gbdt.gp.quant, card=card,
                   construct_s=construct_s,
                   hist_passes=bst._gbdt.hist_passes)
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
