#!/usr/bin/env python3
"""One cold start of the PyTorch/CUDA port, in a process of its own: load
the rows, construct the Dataset through the ingest pipeline and train the
first tree, with or without the background kernel prewarm.

Run from the repository root (chip_smoke.py path (r) runs it twice, once
with each --prewarm, on rows it saved once):

    python3 scripts/torch_cold_start.py ROWS.npy LABELS.npy --prewarm 1
        [--max-bin 63] [--num-leaves 255] [--device cuda|cpu]

The last line of its output is one JSON object: ``t_first_tree`` (the
epoch seconds at which the first tree is on the host; the caller subtracts
the epoch seconds at which it started the process), ``construct_s``,
``construct_phases`` and ``first_tree_s`` (this process's seconds),
``load_s`` (the kernel library's load, ``ops/cuda_lib.BUILD_INFO``; null
when no kernel was loaded, as on the CPU), ``aot_prewarm`` (the events of the run: phase,
reason, seconds), ``warm_launches`` (the prewarm's launches, counted apart
from the training's) and ``adopted``.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rows")
    ap.add_argument("labels")
    ap.add_argument("--prewarm", type=int, default=1)
    ap.add_argument("--max-bin", type=int, default=63)
    ap.add_argument("--num-leaves", type=int, default=255)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.ops import cuda_lib, hist_kernels as hk
    obs.configure(enabled=True)
    X = np.load(a.rows)
    y = np.load(a.labels)
    params = {"objective": "binary", "max_bin": a.max_bin,
              "num_leaves": a.num_leaves, "learning_rate": 0.1,
              "min_data_in_leaf": 20, "verbosity": -1,
              "prewarm": a.prewarm, "device_type": a.device,
              "telemetry": True}
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, params=params)
    ds.construct()
    construct_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    bst = lt.train(params, ds, num_boost_round=1)
    trees = bst._host_trees()
    if a.device == "cuda":
        torch.cuda.synchronize()
    t_first = time.time()
    first_tree_s = time.perf_counter() - t1
    if len(trees) != 1 or trees[0].num_leaves < 2:
        print("cold start: no first tree", file=sys.stderr)
        return 1
    events = [{k: e[k] for k in ("phase", "reason", "duration_s") if k in e}
              for e in obs.EVENTS.snapshot() if e["type"] == "aot_prewarm"]
    print(json.dumps({
        "t_first_tree": t_first, "construct_s": construct_s,
        "construct_phases": ds.construct_phases,
        "first_tree_s": first_tree_s,
        "load_s": cuda_lib.BUILD_INFO.get("load_s"),
        "aot_prewarm": events,
        "warm_launches": {k: v for k, v in hk.WARM_LAUNCHES.items() if v},
        "adopted": bool(bst._gbdt.prewarm_adopted)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
