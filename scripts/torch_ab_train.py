#!/usr/bin/env python3
"""Interleaved A/B of training seconds per iteration between two checkouts.

Run from the repository root on a machine with one CUDA GPU:

    python3 scripts/torch_ab_train.py A_DIR B_DIR [--max-bin 255]
        [--objective binary|regression] [--grow-policy depthwise|lossguide]
        [--quant auto|true|false] [--sampling none|bagged|goss]
        [--cegb-lazy] [--pairs 10] [--iters 1]

A_DIR and B_DIR are checkouts of the repository (for example the parent
commit unpacked with git archive, and this tree). Both copies of
lightgbm_tpu_torch are imported into one process under their own names,
each builds its kernels into its own _build directory, and each trains a
binary model (or, with --objective regression, an L2 model on
chip_smoke.py's continuous target) on the same HIGGS-shaped table
(chip_smoke.py's generator, 10.5M x 28, seed 0) with chip_smoke.py's
parameters, with ``--sampling`` chip_smoke.py path (e)'s bagging and
feature fractions or path (f)'s GOSS, and with ``--cegb-lazy`` path
(m')'s lazy CEGB penalty (0.0005 on features 8-10), which runs the
depthwise grower's lazy bookkeeping at every level. After one warm-up
iteration each, the two boosters take turns, `--iters` iterations a turn,
A first in even pairs and B first in odd ones, each turn timed on the host
clock and ended by torch.cuda.synchronize(). Host load then falls on both
sides alike. Prints the card's name and power limit, one JSON line per
pair, and a summary line: each side's median and quartiles of seconds per
iteration, and the pairs that B won.
"""
import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


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


SAMPLING = {"none": {},
            "bagged": {"bagging_fraction": 0.8, "bagging_freq": 1,
                       "feature_fraction": 0.8,
                       "feature_fraction_bynode": 0.8},
            "goss": {"boosting": "goss", "top_rate": 0.2,
                     "other_rate": 0.1}}


def load_port(root: str, alias: str):
    """Import root/lightgbm_tpu_torch as the package ``alias`` (the port
    imports itself only relatively)."""
    path = os.path.join(os.path.abspath(root), "lightgbm_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [q[0], statistics.median(xs), q[2]]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--max-bin", type=int, default=255, choices=(63, 255))
    ap.add_argument("--objective", default="binary",
                    choices=("binary", "regression"))
    ap.add_argument("--grow-policy", default="depthwise",
                    choices=("depthwise", "lossguide"))
    ap.add_argument("--quant", default="auto",
                    choices=("auto", "true", "false"))
    ap.add_argument("--sampling", default="none", choices=tuple(SAMPLING))
    ap.add_argument("--cegb-lazy", action="store_true")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--iters", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    X, y = synth_higgs(args.rows)
    if args.objective == "regression":    # chip_smoke.py's y_reg
        rng = np.random.RandomState(1)
        y = (X[:, :4] @ np.array([1.0, -0.5, 0.25, 2.0])
             + 0.5 * X[:, 4] ** 2 + 0.1 * rng.randn(args.rows)
             ).astype(np.float32)
    params = {"objective": args.objective, "num_leaves": 255,
              "max_bin": args.max_bin, "learning_rate": 0.1,
              "min_data_in_leaf": 20, "verbosity": -1,
              "grow_policy": args.grow_policy,
              "use_quantized_grad": args.quant, **SAMPLING[args.sampling]}
    if args.cegb_lazy:                     # chip_smoke.py (m')'s
        params["cegb_penalty_feature_lazy"] = ([0.0] * 8 + [0.0005] * 3
                                               + [0.0] * 17)
    lazy = params.get("cegb_penalty_feature_lazy")
    boosters = {}
    for side, root in (("A", args.a), ("B", args.b)):
        lt = load_port(root, f"lightgbm_tpu_torch_{side}")
        ds = lt.Dataset(X, label=y, params=params)
        ds.construct()
        bst = lt.Booster(params=params, train_set=ds)
        bst.update()                       # warm-up: kernel build, caches
        torch.cuda.synchronize()
        boosters[side] = bst
    times = {"A": [], "B": []}
    for k in range(args.pairs):
        pair = {}
        for side in (("A", "B") if k % 2 == 0 else ("B", "A")):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                boosters[side].update()
            torch.cuda.synchronize()
            pair[side] = (time.perf_counter() - t0) / args.iters
            times[side].append(pair[side])
        print(json.dumps(dict(pair=k, **pair)), flush=True)
    print(json.dumps(dict(
        a=args.a, b=args.b, max_bin=args.max_bin, objective=args.objective,
        grow_policy=args.grow_policy, quant=args.quant,
        sampling=args.sampling, cegb_lazy=lazy, rows=args.rows,
        card=card, a_quartiles=quartiles(times["A"]),
        b_quartiles=quartiles(times["B"]),
        b_wins=sum(b < a for a, b in zip(times["A"], times["B"])),
        pairs=args.pairs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
