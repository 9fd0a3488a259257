#!/usr/bin/env python3
"""Where one training iteration of the PyTorch/CUDA port spends its time.

Run from the repository root on a machine with one CUDA GPU:

    python3 scripts/torch_profile_train.py [--rows N] [--iters K]
        [--max-bin 63|255] [--grow-policy depthwise|lossguide]
        [--quant auto|true|false] [--sampling none|bagged|goss]
        [--models binary-l2|multiclass|weighted]
        [--histogram-pool-size MB]

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
per level, or per split under lossguide). ``--sampling bagged`` adds
chip_smoke.py path (e)'s sampling (bagging_fraction 0.8 every iteration,
feature_fraction 0.8, feature_fraction_bynode 0.8), ``--sampling goss``
path (f)'s GOSS (top_rate 0.2, other_rate 0.1); their draws get groups of
their own, from profiler ranges this script opens around them: "bag draw"
(the bag mask or GOSS's weights, without the top-k), "GOSS topk" (the
torch.topk calls) and "bynode draw" (the per-level or per-split feature
masks), and their host time per iteration (the ranges' CPU time, which
the draws' launches set). ``--models multiclass`` traces chip_smoke.py
path (g)'s models instead (objective multiclass and multiclassova,
num_class=5, the quintiles of the generator's latent score), ``--models
weighted`` path (h)'s (row weights uniform on [0.5, 2): binary, and
quantile with alpha 0.9 on the L2 target); their objective work gets
groups of its own too: "gradients" (the objective's gradients, the
softmax for multiclass) and "leaf renewal" (the quantile model's
per-leaf percentile). ``--histogram-pool-size`` sets histogram_pool_size
(MB): the lean depthwise grower's feature tiles, or the leaf-wise grower's
histogram pool, when the whole frontier's histograms exceed it. Prints the
card's name and power limit first.
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

sys.path.insert(0, HERE)
# each kernel's CUDA functions (the slot histograms' compaction passes, the
# fused level pass's route and count, and the leaf sums' final pass count
# as their kernel's time): chip_smoke.py's one table
from chip_smoke import (  # noqa: E402  (numpy only at import)
    KERNEL_PARTS, synth_higgs)


def group_of(name: str) -> str:
    """The group of a profiler event by its function's own name (the last
    identifier before the argument list), matched exactly."""
    m = re.search(r"(\w+)\(", name)
    fn = m.group(1) if m else name
    return KERNEL_PARTS.get(fn, "other (split search, glue)")


SAMPLING = {"none": {},
            "bagged": {"bagging_fraction": 0.8, "bagging_freq": 1,
                       "feature_fraction": 0.8,
                       "feature_fraction_bynode": 0.8},
            "goss": {"boosting": "goss", "top_rate": 0.2,
                     "other_rate": 0.1}}
RANGES = ("bag draw", "GOSS topk", "bynode draw", "gradients",
          "leaf renewal")


def ranged(name, fn):
    """fn, called inside a profiler range named name."""
    from torch.profiler import record_function

    def call(*args, **kw):
        with record_function(name):
            return fn(*args, **kw)
    return call


def annotate_draws() -> None:
    """Open a profiler range (RANGES) around every torch.topk call and
    every node mask the growers draw; boosters' _update_bag get theirs
    where they are made."""
    import torch
    from lightgbm_tpu_torch.ops import grow, grow_depthwise
    torch.topk = ranged("GOSS topk", torch.topk)
    node_mask = ranged("bynode draw", grow.node_feature_mask)
    grow.node_feature_mask = grow_depthwise.node_feature_mask = node_mask


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
        # the ranges' own device-side spans (user annotations, gaps
        # included) are no kernels: skip them
        if dev_us <= 0 or ev.device_type.name != "CUDA" or ev.key in RANGES:
            continue
        g = group_of(ev.key)
        by_group[g] = by_group.get(g, 0.0) + dev_us / 1e3 / iters
        launches[g] = launches.get(g, 0) + ev.count
    # the draws' kernels, by the ranges annotate_draws opened (their
    # generic elementwise kernels are counted in "other" above)
    ranges, host = {}, {}
    for ev in prof.events():
        if ev.name in RANGES and ev.device_type.name == "CPU":
            ranges[ev.name] = ranges.get(ev.name, 0.0) \
                + ev.device_time_total / 1e3 / iters
            host[ev.name] = host.get(ev.name, 0.0) \
                + ev.cpu_time_total / 1e3 / iters
    if ranges:
        other = "other (split search, glue)"
        by_group[other] = by_group.get(other, 0.0) - sum(
            ranges.get(r, 0.0) for r in ("bag draw", "bynode draw",
                                         "gradients", "leaf renewal"))
        if "GOSS topk" in ranges:
            ranges["bag draw"] = ranges.get("bag draw", 0.0) \
                - ranges["GOSS topk"]
        by_group.update(ranges)
    busy = sum(by_group.values())
    return {"wall_ms_per_iter": wall * 1e3 / iters,
            "device_ms_per_iter": by_group,
            "draws_host_ms_per_iter": host,
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
    ap.add_argument("--sampling", default="none", choices=tuple(SAMPLING))
    ap.add_argument("--models", default="binary-l2",
                    choices=("binary-l2", "multiclass", "weighted"))
    ap.add_argument("--histogram-pool-size", type=float, default=-1.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lt
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    X, y, latent = synth_higgs(args.rows, latent=True)
    rng = np.random.RandomState(1)
    y_reg = (X[:, :4] @ np.array([1.0, -0.5, 0.25, 2.0]) + 0.5 * X[:, 4] ** 2
             + 0.1 * rng.randn(args.rows)).astype(np.float32)
    # (objective, label, row weights, extra parameters) of each model
    if args.models == "multiclass":
        y5 = np.digitize(latent, np.quantile(latent, [0.2, 0.4, 0.6, 0.8])
                         ).astype(np.float32)
        models = [(o, y5, None, {"num_class": 5})
                  for o in ("multiclass", "multiclassova")]
    elif args.models == "weighted":
        w = np.random.RandomState(2).uniform(0.5, 2.0, args.rows).astype(
            np.float32)
        models = [("binary", y, w, {}), ("quantile", y_reg, w,
                                         {"alpha": 0.9})]
    else:
        models = [("binary", y, None, {}), ("regression", y_reg, None, {})]
    base = {"num_leaves": 255, "max_bin": args.max_bin, "learning_rate": 0.1,
            "min_data_in_leaf": 20, "verbosity": -1,
            "grow_policy": args.grow_policy,
            "use_quantized_grad": args.quant,
            "histogram_pool_size": args.histogram_pool_size,
            **SAMPLING[args.sampling]}
    annotate_draws()
    for objective, label, weight, extra in models:
        params = dict(base, objective=objective, **extra)
        ds = lt.Dataset(X, label=label, weight=weight, params=params)
        t0 = time.perf_counter()
        ds.construct()
        torch.cuda.synchronize()
        construct_s = time.perf_counter() - t0
        bst = lt.Booster(params=params, train_set=ds)
        gb = bst._gbdt
        gb._update_bag = ranged("bag draw", gb._update_bag)
        gb.objective.get_gradients = ranged("gradients",
                                            gb.objective.get_gradients)
        gb.objective.renew_leaf_values = ranged(
            "leaf renewal", gb.objective.renew_leaf_values)
        for _ in range(2):
            bst.update()
        res = profile_iters(bst, args.iters)
        res.update(objective=objective, rows=args.rows,
                   max_bin=args.max_bin, grow_policy=args.grow_policy,
                   sampling=args.sampling,
                   quant=bst._gbdt.gp.quant, card=card,
                   construct_s=construct_s,
                   lean_ft=bst._gbdt.gp.lean_ft,
                   hist_pool=bst._gbdt.gp.hist_pool,
                   hist_passes=bst._gbdt.hist_passes,
                   hist_rebuilds=bst._gbdt.hist_rebuilds)
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
