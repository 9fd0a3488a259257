#!/usr/bin/env python3
"""Run one cell of the benchmark of lightgbm_tpu_torch on one NVIDIA GPU.

    python3 gbdt_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers the check compared, each beside its
limit, are the last lines of standard error. Exits non-zero, printing no
result, without a CUDA card, with fewer cards than the cell asks for, or
when the JAX package or JAX is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from gbdt_bench import harness
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.load_cell(ROOT, args.workload)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    from gbdt_bench.hw import card_line
    print("card " + card_line(), flush=True)
    try:
        result = harness.run_cell(
            cell, args.seed, args.seconds, bool(args.trace), "cuda",
            t_start=T_START, info=lambda s: print(s, flush=True))
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
