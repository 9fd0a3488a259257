#!/usr/bin/env python3
"""Levels 1..D of one tree in two kernel calls: the shallow megapass of the
PyTorch/CUDA port, its counterpart of scripts/profile_level.py's
shallow_megapass.

Run from the repository root, on a machine with one CUDA GPU (the default)
or on the CPU's plain versions:

    python3 scripts/torch_profile_level.py [--json] [--rows N] [--leaves L]
        [--features F] [--max-bin B] [--const-hess] [--device cuda|cpu]

Call 1 is grad_quant_hist0: the logloss gradients (L2 with --const-hess) of
a random score, their stochastic-rounding int8 quantization and the root
histogram (level 0), in one kernel. Call 2 is one hist_routed_fused_multi:
levels 1..D replayed from the root's leaf ids over D known route tables,
each level's slot histogram in its own band. The tables are the
reference's: level d's frontier of 2^(d-1) leaves, each split on a random
feature at a random threshold, the left child kept in slot i, the right one
dropped, one slot width S for every level (the reference's
floor_slot_width of 2^D). D is 5 where L leaves fit its new leaf ids (L >=
32), else the most levels that fit. The call's histograms and final leaf
ids are checked bit for bit against D sequential hist_routed_fused calls
on the same tables (bit_identical_vs_sequential; the script fails if they
differ). On the card each is timed with CUDA events (median of 7,
chip_smoke.py time_ms), and the launch counters read over calls 1 and 2
give ``cuda_launches`` (2); on the CPU no kernel launches (0) and the times
are not measured (null). --rows and --leaves shrink
the workload (the CPU tests run it at --rows 2000 --leaves 8).

With --json the last line is one JSON object with the reference's keys
(``backend`` is the torch device type; ``pallas_launches`` becomes
``cuda_launches``), its shallow section beside the card's name and power
limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def megapass_case(n, f, b, l, dev, const_hess=False, seed=0, bins=None):
    """The inputs of one shallow megapass: bins [F, N] and [N, F] u8 over
    [0, b - 1) (or the given row-major ``bins`` on ``dev``), score, label
    and bag rows, na_bin, the D route tables [6, L] i32 of levels 1..D,
    their slot width S and D."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.grow_depthwise import floor_slot_width
    rng = np.random.RandomState(seed)
    if bins is None:
        bins = torch.from_numpy(rng.randint(0, b - 1, size=(n, f)).astype(
            np.uint8)).to(dev)
    score = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    label = torch.from_numpy((rng.randn(n) if const_hess else
                              (rng.rand(n) < 0.5)).astype(np.float32)).to(dev)
    bag = torch.ones(n, dtype=torch.float32, device=dev)
    d = max(1, min(5, l.bit_length() - 1))
    s = floor_slot_width(2 ** d, max(1, l // 2))
    tables = []
    for lvl in range(1, d + 1):
        width = 2 ** (lvl - 1)         # leaves entering this level
        feat = np.full(l, -1, np.int32)
        feat[:width] = rng.randint(0, f, width)
        thr = np.zeros(l, np.int32)
        thr[:width] = rng.randint(1, b - 1, width)
        new_leaf = np.arange(l, dtype=np.int32)
        new_leaf[:width] = width + np.arange(width)
        slot_left = np.full(l, s, np.int32)
        slot_left[:width] = np.arange(width)
        tab = np.stack([feat, thr, np.zeros(l, np.int32), new_leaf,
                        slot_left, np.full(l, s, np.int32)])
        tables.append(torch.from_numpy(tab).to(dev).contiguous())
    return dict(bins=bins, bins_T=bins.t().contiguous(), score=score,
                label=label, bag=bag, spec=("l2",) if const_hess else
                ("logloss", 1.0, 1.0, 1.0), const_hess=const_hess,
                na_bin=torch.full((f,), b + 1, dtype=torch.int32,
                                  device=dev),
                lid0=torch.zeros(n, dtype=torch.int32, device=dev),
                tables=tables, slots=s, levels=d, num_bins=b)


def megapass(case):
    """Levels 0..D in two calls: grad_quant_hist0, then one
    hist_routed_fused_multi. Returns ((gq, hq, cq), hist0 [nch, F, B],
    hist [D, S, nch, F, B], lid [N]), int32 sums."""
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    gq, hq, cq, _, hist0 = hk.grad_quant_hist0(
        case["bins_T"], case["score"], case["label"], case["bag"], 7,
        case["spec"], case["num_bins"], case["const_hess"])
    hist, lid = hk.hist_routed_fused_multi(
        case["bins_T"], gq, hq, cq, case["lid0"], case["tables"],
        case["na_bin"], case["slots"], case["num_bins"], bins=case["bins"])
    return (gq, hq, cq), hist0, hist, lid


def sequential(case, quant):
    """The same levels as D sequential hist_routed_fused calls: ([D, S,
    nch, F, B], lid [N])."""
    import torch
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    hists, lid = [], case["lid0"]
    for t in case["tables"]:
        h, lid = hk.hist_routed_fused(
            case["bins_T"], *quant, lid, t, case["na_bin"], case["slots"],
            case["num_bins"], bins=case["bins"])
        hists.append(h)
    return torch.stack(hists), lid


def shallow_megapass(case):
    """The shallow section of the --json line (the reference's keys): the
    launch counters zeroed just before the two calls and read just after
    them, the sequential check, and on the card the timings."""
    import torch
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    d, s, b = case["levels"], case["slots"], case["num_bins"]
    f, n = case["bins_T"].shape
    hk.reset_launches()
    quant, _, hist, lid = megapass(case)
    launches = {k: v for k, v in hk.LAUNCHES.items() if v}
    hs, ls = sequential(case, quant)
    identical = bool(torch.equal(hist, hs) and torch.equal(lid, ls))
    nch = 2 if case["const_hess"] else 3
    mega_ms = seq_ms = None
    if case["bins_T"].device.type == "cuda":
        sys.path.insert(0, HERE)
        from chip_smoke import time_ms
        mega_ms = time_ms(lambda: hk.hist_routed_fused_multi(
            case["bins_T"], *quant, case["lid0"], case["tables"],
            case["na_bin"], s, b, bins=case["bins"]))
        seq_ms = time_ms(lambda: sequential(case, quant))
    return {
        "levels": list(range(0, d + 1)),
        "slot_width": s,
        "channels": nch,
        "packed": False,
        "pack_guard_bits": 0,
        # the MXU work the reference counts for one level pass; the port
        # adds each kept row's nch channels into F cells instead
        "macs_per_level": n * f * b * s * nch,
        "cuda_launches": sum(launches.values()),
        "launches_by_wrapper": launches,
        "launch_breakdown": [
            "grad_quant_hist0 (gradients + int8 quantize + level-0 root "
            "histogram, csrc/grad_quant_hist0.cu)",
            f"hist_routed_fused_multi d={d} (levels 1-{d} replay, "
            "csrc/hist_routed_fused_multi.cu)"],
        "megapass_ms": mega_ms,
        "sequential_levels_ms": seq_ms,
        "timing": ("CUDA events, median of 7" if mega_ms is not None
                   else "not measured (CPU plain versions)"),
        "bit_identical_vs_sequential": identical,
    }


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line instead of the human table")
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--features", type=int, default=28)
    ap.add_argument("--leaves", type=int, default=255)
    ap.add_argument("--max-bin", type=int, default=64)
    ap.add_argument("--const-hess", action="store_true",
                    help="the L2 front: gradients and count only")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_profile_level: no CUDA device (--device cpu runs the "
              "plain versions)", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else None
    t0 = time.perf_counter()
    sh = shallow_megapass(megapass_case(args.rows, args.features,
                                        args.max_bin, args.leaves, dev,
                                        args.const_hess))
    if not args.json:
        print(f"card: {card}")
        print(f"shallow megapass levels 1-{sh['levels'][-1]} "
              f"(S={sh['slot_width']}): {sh['megapass_ms']} ms (sequential "
              f"{sh['sequential_levels_ms']} ms, bit_identical="
              f"{sh['bit_identical_vs_sequential']}); "
              f"{time.perf_counter() - t0:.1f} s")
    else:
        print(json.dumps({
            "rows": args.rows, "features": args.features,
            "max_bin": args.max_bin, "num_leaves": args.leaves,
            "backend": dev.type, "device": dev.type, "card": card,
            "channels": sh["channels"], "packed": sh["packed"],
            "shallow": sh}))
    if not sh["bit_identical_vs_sequential"]:
        print("torch_profile_level: the megapass diverged from the "
              "sequential level passes", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
