"""The card: its name, power limit and published peaks, and the port's
kernel names.

``peaks`` and ``card_line`` are copies of ``chip_smoke.py``'s; the table
``KERNEL_PARTS`` is a copy of ``chip_smoke.py``'s, from which
``scripts/torch_profile_train.py`` groups profiler kernels, with each
wrapper given its B-number from PERF.md's kernel table.
"""
from __future__ import annotations

import re
import subprocess


def card_line() -> str:
    """nvidia-smi's "name, power limit" of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(memory bytes/s, f32 operations/s) of the card from NVIDIA's data
    sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s, PCIe 2.0 TB/s and 51, NVL
    3.9 TB/s and 60."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


# the CUDA kernels of lightgbm_tpu_torch/csrc by wrapper
KERNEL_PARTS = {
    **dict.fromkeys(("max_kernel", "quant_hist_kernel"), "grad_quant_hist0"),
    **dict.fromkeys(("hist_routed_count_kernel", "hist_routed_scan_kernel",
                     "hist_routed_scatter_kernel", "hist_routed_kernel"),
                    "hist_routed_fused"),
    **dict.fromkeys(("leaf_sums_grad_rows_kernel",
                     "leaf_sums_grad_final_kernel",
                     "leaf_sums_grad_global_kernel"), "leaf_sums_grad"),
    "take_kernel": "take_small",
    **dict.fromkeys(("hist_q8_count_kernel", "hist_q8_scan_kernel",
                     "hist_q8_scatter_kernel", "hist_q8_kernel"), "hist_q8"),
    "route_level_kernel": "route_level",
    **dict.fromkeys(("leaf_sums_rows_kernel", "leaf_sums_final_kernel",
                     "leaf_sums_global_kernel"), "leaf_sums"),
    **dict.fromkeys(("hist_f32_count_kernel", "hist_f32_scan_kernel",
                     "hist_f32_scatter_kernel", "hist_f32_kernel"),
                    "hist_f32"),
    **dict.fromkeys(("hist_routed_multi_count_kernel",
                     "hist_routed_multi_scan_kernel",
                     "hist_routed_multi_scatter_kernel",
                     "hist_routed_multi_kernel"), "hist_routed_fused_multi")}

B_NUMBER = {"grad_quant_hist0": "B1", "hist_routed_fused": "B2",
            "hist_routed_fused_multi": "B2", "leaf_sums_grad": "B3",
            "take_small": "B4", "hist_q8": "B5", "route_level": "B6",
            "leaf_sums": "B7", "hist_f32": "B8"}


def kernel_part(name: str):
    """The "B<k> wrapper" of a device kernel by its function's own name (the
    last identifier before the argument list), or None for every other
    kernel."""
    bare = name
    while True:
        stripped = re.sub(r"<[^<>]*>", "", bare)
        if stripped == bare:
            break
        bare = stripped
    m = re.search(r"(\w+)\(", bare)
    fn = m.group(1) if m else bare.split()[-1] if bare.split() else bare
    wrapper = KERNEL_PARTS.get(fn)
    return None if wrapper is None else f"{B_NUMBER[wrapper]} {wrapper}"
