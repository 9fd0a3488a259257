#!/usr/bin/env python3
"""The dense encode of a Dataset three ways on one device, each timed and
held against the others bit for bit: the ingest pipeline (rows staged on
host threads, binned on the device; ``ingest.py``), the host-binned encode
that the JAX package's ingest runs (each chunk binned by the mappers'
numpy ``values_to_bins`` on the same host threads, then uploaded as
uint8), and the column-at-a-time encode (``binning.bin_data``, the
pipeline's plain version). The measurement behind the choice of the
device encode for the pipeline.

Run from the repository root:

    python3 scripts/torch_host_encode.py [--rows 10500000]
        [--chunk-rows 2000000] [--max-bin 63] [--device cuda|cpu]

The rows are chip_smoke.py's ``synth_higgs`` (28 features, seed 0). The
last line of its output is one JSON object: ``pipeline_s``,
``host_binned_s``, ``column_s`` (seconds, the device synchronized),
``chunks``, ``encode_threads``, ``pipeline_stats`` (``ingest.last_stats``)
and ``equal``; the line before it is the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--chunk-rows", type=int, default=2_000_000)
    ap.add_argument("--max-bin", type=int, default=63)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import ingest
    from lightgbm_tpu_torch.binning import bin_data
    from chip_smoke import synth_higgs
    dev = torch.device(a.device)
    X, y = synth_higgs(a.rows)

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t

    params = {"objective": "binary", "max_bin": a.max_bin, "verbosity": -1,
              "prewarm": 0, "ingest_chunk_rows": a.chunk_rows,
              "device_type": a.device}
    ds = lt.Dataset(X, label=y, params=params).construct()
    stats = ingest.last_stats()
    if ds.bundle_meta is not None:
        print("torch_host_encode: the rows were bundled by EFB",
              file=sys.stderr)
        return 1
    cols = list(ds.feature_map)
    threads = ingest.resolve_encode_threads(0)
    starts = list(range(0, a.rows, a.chunk_rows))

    def host_binned():
        out = torch.empty((a.rows, len(cols)), dtype=torch.uint8,
                          device=dev)

        def encode(g0):
            g1 = min(g0 + a.chunk_rows, a.rows)
            b = np.empty((g1 - g0, len(cols)), dtype=np.uint8)
            for k, j in enumerate(cols):
                b[:, k] = ds.mappers[k].values_to_bins(X[g0:g1, j])
            return g0, b
        with ThreadPoolExecutor(threads) as ex:
            for g0, b in ex.map(encode, starts):
                out[g0:g0 + b.shape[0]].copy_(torch.from_numpy(b))
        return out

    host, host_s = timed(host_binned)
    column, column_s = timed(lambda: bin_data(X, ds.mappers, cols, dev))
    equal = bool(torch.equal(host, ds.bins) and torch.equal(column, ds.bins))
    card = "no card"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(card)
    print(json.dumps({"rows": a.rows, "features": len(cols),
                      "pipeline_s": stats["wall_s"], "host_binned_s": host_s,
                      "column_s": column_s, "chunks": len(starts),
                      "encode_threads": threads, "pipeline_stats": stats,
                      "equal": equal}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
