#!/usr/bin/env python3
"""Where a take_small call's time goes: the kernel, and the host around it.

Run from the repository root on a machine with one CUDA GPU:

    python3 scripts/torch_take_small_split.py DIR [DIR ...] [--rows N]

Each DIR is a checkout of the repository (for example the parent commit
unpacked with git archive, and this tree); each copy of lightgbm_tpu_torch
is imported into this one process under its own name
(scripts/torch_ab_train.py load_port). On chip_smoke.py's B4 inputs (N rows, an
L = 255 f32 table, indices over [-2, L + 3)) it measures, for each
checkout's take_small and for index_select on the zero-padded table:

- event_ms: the median of 21 CUDA-event timings of one call, as
  chip_smoke.py reports it (host time inside the window included;
  chip_smoke.py time_ms);
- device_ms: the device time of the call's kernels (torch.profiler, 20
  calls; chip_smoke.py device_ms; null when not measured);
- host_us: host microseconds a call takes to return (200 calls on the host
  clock, then one synchronize; the card runs behind the host);

and the host microseconds of three parts of a wrapper's launch path:
torch.cuda.current_stream(dev).cuda_stream, torch._C's raw stream query,
and torch.cuda.get_device_properties(dev). The checkouts take turns twice
(A B B A ...). Prints the card's name and power limit, then one JSON line
per measurement.
"""
import argparse
import importlib
import json
import os
import subprocess
import sys
import time

from torch_ab_train import load_port

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import device_ms, time_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rows", type=int, default=10_500_000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    n, l = args.rows, 255
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(l, generator=g, device=dev)
    idx = torch.randint(-2, l + 3, (n,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    padded = torch.cat([table, torch.zeros(1, device=dev)])
    idx_in = torch.where((idx >= 0) & (idx < l), idx, l).to(torch.int32)

    def event_ms(fn):
        return time_ms(fn, reps=21)

    def host_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / reps * 1e6

    calls = {}
    for k, root in enumerate(args.dirs):
        load_port(root, f"lightgbm_tpu_torch_{k}")
        hk = importlib.import_module(f"lightgbm_tpu_torch_{k}.ops"
                                     ".hist_kernels")
        ref = hk.take_small_plain(table, idx)
        if not torch.equal(hk.take_small(table, idx), ref):
            print(f"{root}: take_small differs from its plain version",
                  file=sys.stderr)
            return 1
        calls[root] = (lambda hk=hk: hk.take_small(table, idx))
    calls["index_select"] = lambda: padded.index_select(0, idx_in)
    order = list(calls)
    for turn in range(2):
        for name in (order if turn == 0 else order[::-1]):
            fn = calls[name]
            print(json.dumps(dict(
                call=name, turn=turn, rows=n, event_ms=event_ms(fn),
                device_ms=device_ms(fn, reps=20), host_us=host_us(fn),
                card=card)),
                flush=True)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    parts = {
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": (lambda: raw(0)) if raw else None,
        "device_properties": lambda: torch.cuda.get_device_properties(
            dev).multi_processor_count}
    for name, fn in parts.items():
        if fn is None:
            continue
        t0 = time.perf_counter()
        for _ in range(10000):
            fn()
        print(json.dumps(dict(part=name, host_us=(time.perf_counter() - t0)
                              / 10000 * 1e6, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
