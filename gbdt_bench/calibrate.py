#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on one NVIDIA GPU.

    python3 gbdt_bench/calibrate.py --workload <cell> --seeds 1 2 ...
        --control-seeds 7 8 9 [--out FILE]

In one process: the program's sound runs on each ``--seeds`` seed (the
cell's own sizes, the warm-up and a window of ``--seconds``, the check's
numbers read with no limit), then for each ``--control-seeds`` seed the
control (the reference grown in bfloat16 in the program's place) and the
faults planted in the reference in the program's place (``judge.
ControlOutputs``), and for each ``--fault-seeds`` seed the port's own run
with its timed path broken underneath (``tests/test_gbdt_bench_control.py
PORT_FAULTS``). One JSON line a
reading, on
standard output and appended to ``--out``. The benchmark's own runs do not
run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from gbdt_bench import harness, judge
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    cell.limits = {k: float("inf") for k in judge.NAMES}
    dev = torch.device("cuda")

    def emit(kind, seed, read, seconds, iterations=None):
        line = json.dumps({"cell": args.workload, "kind": kind, "seed": seed,
                           "seconds": seconds, "iterations": iterations,
                           "read": read})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                             info=lambda s: None)
        emit("program", seed, {k: c["value"] for k, c in r["checks"].items()},
             time.perf_counter() - t, r["attempted"])
    gen = __import__(f"gbdt_bench.gen.{cell.config['generator']}",
                     fromlist=["make"])
    from gbdt_bench.tests import test_gbdt_bench_control as plants

    class Patch:
        """A minimal stand-in for pytest's monkeypatch."""
        def __init__(self):
            self.undo = []

        def setattr(self, obj, name, value):
            self.undo.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)

    for seed in args.fault_seeds:
        for kind, make in sorted(plants.PORT_FAULTS.items()):
            kind = "fault_port_" + kind
            mp = Patch()
            t = time.perf_counter()
            try:
                r = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                     info=lambda s: None, plant=make(mp))
            finally:
                for obj, name, value in reversed(mp.undo):
                    setattr(obj, name, value)
            emit(kind, seed, {k: c["value"] for k, c in r["checks"].items()},
                 time.perf_counter() - t, r["attempted"])
    for seed in args.control_seeds:
        host = gen.make(cell.config, seed, dev).to("cpu")
        prob = judge.Problem(cell.params, host, dev)
        for kind, dtype, fault in (
                ("control_bf16", torch.bfloat16, None),
                *(("fault_" + f, None, f) for f in (
                    "half_rows", "alter_leaf", "short_tree", "reused_bag",
                    "extra_column"))):
            t = time.perf_counter()
            out = judge.ControlOutputs(prob, dtype=dtype, fault=fault,
                                       seed=seed)
            emit(kind, seed, judge.readings(prob, out),
                 time.perf_counter() - t)
        del prob, host
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
