#!/usr/bin/env python3
"""Card-against-CPU spread of the constrained lossguide parity model.

Run from the repository root on a machine with one CUDA GPU:

    python3 scripts/torch_constrained_parity.py [--runs 10]

Trains the 4000-row model of path (m'') that chip_smoke.py phase 5 holds
against the CPU (lossguide, unquantized, monotone constraints on features
0-7, extra_trees, the forced splits, 3 trees on exact-sum labels), and the
one of tests/test_torch_cuda.py::test_gpu_constrained_trees_equal_cpu
(its own rows and labels), once on the CPU and ``--runs`` times on the
card. Prints the card's name and power limit, then one JSON line per data
set with, as shares of the CPU model's largest leaf value:

- ``vs_cpu``: each card run's largest leaf-value difference against the
  CPU run, tree by tree, and whether the structures are the same;
- ``vs_card``: each later card run's against the first card run (the
  card's own spread: the f32 histogram atomics add in another order on
  each launch);
- ``one_row``: the scale of a wrong leaf. For each leaf of the CPU trees
  whose value is its unclamped Newton step, the change of that value when
  one of its rows is left out of its sums (L2: g = score - y, h = 1),
  as the median over the leaf's rows; the least of these medians over
  the leaves, and the least single change over all rows.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the repository root's smoke script)


def test_data(path_dir):
    """test_gpu_constrained_trees_equal_cpu's rows, labels and (m'')
    settings (a copy of the test's data and _constrained_params)."""
    rng = np.random.RandomState(21)
    X = rng.randn(4000, 28).astype(np.float32)
    w = np.array([0.8, -1.1, 0.5, 0.9, -0.4, 1.3, -0.7, 0.6])
    y = np.clip(np.floor((X[:, :8] @ w - 0.4 * X[:, 10] ** 2
                          + 0.5 * rng.rand(4000)) * 8) / 8, -6,
                5.875).astype(np.float32)
    forced = os.path.join(path_dir, "forced_splits.json")
    params = {"objective": "regression", "num_leaves": 31, "max_bin": 63,
              "min_data_in_leaf": 20, "verbosity": -1,
              "boost_from_average": False, "grow_policy": "lossguide",
              "extra_trees": True,
              "monotone_constraints": [1, -1, 1, 1, -1, 1, -1, 1]
              + [0] * 20, "forcedsplits_filename": forced}
    return X, y, params


def one_row_scale(booster, X, y, lr):
    """(least median, least single) leaf-value change from leaving one
    row out of a leaf's sums, over the unclamped leaves of every tree."""
    leaves = booster.predict(X, pred_leaf=True).reshape(len(X), -1)
    trees = booster._host_trees()
    medians, singles = [], []
    score = np.zeros(len(X), np.float64)
    for t, tree in enumerate(trees):
        g = score - y
        for leaf in range(tree.num_leaves):
            rows = leaves[:, t] == leaf
            n = int(rows.sum())
            if n < 2:
                continue
            gl = g[rows]
            step = -lr * gl.sum() / n
            if abs(step - tree.leaf_value[leaf]) > 1e-5 * abs(step) + 1e-12:
                continue            # clamped by a monotone bound
            shift = lr * np.abs(gl - gl.sum() / n) / (n - 1)
            medians.append(float(np.median(shift)))
            singles.append(float(shift.min()))
        score += tree.leaf_value[leaves[:, t]]
    return min(medians), min(singles), len(medians)


def spread(lt, X, y, params, runs):
    cpu = lt.train(dict(params, device_type="cpu"),
                   lt.Dataset(X, label=y, params=dict(
                       params, device_type="cpu")), 3)
    tb = cpu._host_trees()
    scale = max(float(np.abs(t.leaf_value).max()) for t in tb)
    struct = ("split_feature", "threshold_bin", "default_left",
              "left_child", "right_child")

    def diffs(ta, tref):
        same = len(ta) == len(tref) and all(
            np.array_equal(getattr(a, f), getattr(b, f))
            for a, b in zip(ta, tref) for f in struct)
        per_tree = [float(np.abs(a.leaf_value - b.leaf_value).max()) / scale
                    if a.num_leaves == b.num_leaves else None
                    for a, b in zip(ta, tref)]
        return {"same_structure": same, "per_tree": per_tree}

    cards = []
    for _ in range(runs):
        gpu = lt.train(params, lt.Dataset(X, label=y, params=params), 3)
        cards.append(gpu._host_trees())
    least_median, least_single, n_leaves = one_row_scale(
        cpu, X, y, params.get("learning_rate", 0.1))
    return {"largest_leaf": scale,
            "vs_cpu": [diffs(ta, tb) for ta in cards],
            "vs_card": [diffs(ta, cards[0]) for ta in cards[1:]],
            "one_row": {"least_median": least_median / scale,
                        "least_single": least_single / scale,
                        "leaves": n_leaves}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_constrained_parity: no CUDA device", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lt
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    n = 10_500_000
    X, _, w = chip_smoke.synth_higgs(n, 28, seed=0, weights=True)
    Xs = np.ascontiguousarray(X[:4000])
    del X
    ym8, cases = chip_smoke.constrained_parity_cases(Xs, w)
    name, params, _, _ = cases[2]
    out = spread(lt, Xs, ym8, params, args.runs)
    print(json.dumps({"data": "chip_smoke phase 5", "path": name, **out}))
    Xt, yt, pt = test_data(chip_smoke.OUT_DIR)
    out = spread(lt, Xt, yt, pt, args.runs)
    print(json.dumps({"data": "test_gpu_constrained_trees_equal_cpu",
                      "path": "m''", **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
