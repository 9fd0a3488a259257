"""Reduce a torch.profiler Chrome trace of whole iterations to what the
per-layer readers take.

Device operations are the trace's kernels, memory copies and memsets.
``busy_s`` is the length of the union of their intervals (not the sum of
their times: kernels of two streams overlap), ``window_s`` the span of the
traced stretch from its first event to its last. An idle gap is a stretch
of the window that no device operation covers; it is named by the host
range open at its middle (``boosting`` or ``eval``, the ``record_function``
scopes that ``engine.train`` opens) and the innermost host call then.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .hw import kernel_part

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
RANGES = ("boosting", "eval")


@dataclass
class Profile:
    """One traced stretch of ``iterations`` whole iterations (times in
    seconds)."""
    iterations: int
    device: List[Tuple[str, str, float, float]]   # (cat, name, start, end)
    host: List[Tuple[str, str, float, float]]
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self):
        return [d for d in self.device if d[0] == "kernel"]


def from_chrome(doc: dict, iterations: int) -> Profile:
    dev, host = [], []
    lo, hi = float("inf"), float("-inf")
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s = float(e["ts"]) * 1e-6
        t = s + float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            dev.append((cat, e.get("name", ""), s, t))
        elif cat in HOST_CATS:
            host.append((cat, e.get("name", ""), s, t))
        else:
            continue
        lo, hi = min(lo, s), max(hi, t)
    return Profile(iterations, dev, host, (lo, hi) if dev or host
                   else (0.0, 0.0))


def load_chrome(path: str, iterations: int) -> Profile:
    with open(path) as fh:
        return from_chrome(json.load(fh), iterations)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted union of [start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def busy_s(p: Profile) -> float:
    lo, hi = p.window
    return sum(min(t, hi) - max(s, lo)
               for s, t in union([(d[2], d[3]) for d in p.device])
               if t > lo and s < hi)


def idle_gaps(p: Profile) -> List[Tuple[float, float]]:
    lo, hi = p.window
    gaps, at = [], lo
    for s, t in union([(d[2], d[3]) for d in p.device]):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, t)
    if at < hi:
        gaps.append((at, hi))
    return [g for g in gaps if g[1] > g[0]]


def host_at(p: Profile, t: float) -> str:
    """"<range>/<innermost host call>" open at time t."""
    rng, inner, inner_start = "none", None, float("-inf")
    for cat, name, s, e in p.host:
        if s <= t < e:
            if cat == "user_annotation" and name in RANGES:
                rng = name
            elif s > inner_start:
                inner, inner_start = name, s
    return rng if inner is None else f"{rng}/{inner}"


def device_label(cat: str, name: str) -> str:
    if cat != "kernel":
        return cat
    part = kernel_part(name)
    return part if part else name[:96]


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each [label, seconds], at most ``top`` of each."""
    by: Dict[str, float] = {}
    for cat, name, s, t in p.device:
        lab = device_label(cat, name)
        by[lab] = by.get(lab, 0.0) + (t - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(p), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[host_at(p, (s + t) / 2), t - s]
                          for s, t in gaps]}


def device_seconds(p: Profile, port_kernels: Optional[bool]) -> float:
    """Device kernel seconds of the port's own kernels (True), of every
    other kernel (False) or of all (None)."""
    total = 0.0
    for cat, name, s, t in p.kernels():
        mine = kernel_part(name) is not None
        if port_kernels is None or mine == port_kernels:
            total += t - s
    return total


def range_seconds(p: Profile, name: str) -> float:
    return sum(e - s for cat, n, s, e in p.host
               if cat == "user_annotation" and n == name)
