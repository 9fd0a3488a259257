"""Device-memory watermark sampling.

Port of ``lightgbm_tpu/obs/memory.py``. One reading a CUDA device from
torch's caching allocator: ``torch.cuda.memory_stats(i)``'s
``allocated_bytes.all.current`` is ``bytes_in_use`` and
``allocated_bytes.all.peak`` is ``peak_bytes_in_use`` (the peak since the
process started or since ``torch.cuda.reset_peak_memory_stats``), and the
total of ``torch.cuda.mem_get_info(i)`` (read once a device) is
``bytes_limit``; the device's
label is its index and its platform ``"gpu"``. Without CUDA there is no
reading (as the reference's CPU backend gives none) and every consumer here
takes the empty list. With CUDA a failing query raises: a card's stats are
read or the caller hears why.

:func:`sample` takes one reading; :func:`update_gauges` folds it into
``device_memory_bytes{device=...,stat=...}`` gauges (peak kept as a
high-watermark across calls); :func:`watermark` summarizes the highest peak
across devices.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

_STATS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


@functools.lru_cache(maxsize=None)
def _bytes_limit(i: int) -> int:
    """The card's total memory, which does not change: read once a device
    (cudaMemGetInfo is a driver call)."""
    import torch
    return int(torch.cuda.mem_get_info(i)[1])


def sample() -> List[Dict[str, Any]]:
    """One reading per CUDA device; [] without CUDA."""
    import torch
    if not torch.cuda.is_available():
        return []
    out: List[Dict[str, Any]] = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({"device": str(i), "platform": "gpu",
                    "bytes_in_use": int(stats.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(stats.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_limit": _bytes_limit(i)})
    return out


def update_gauges(registry, shard_of: Optional[Dict[str, int]] = None
                  ) -> List[Dict[str, Any]]:
    """Fold one sample into gauges on ``registry``; returns the raw sample.
    ``bytes_in_use`` is point-in-time (set); peaks are high-watermarked
    (set_max) so periodic sampling converges on the true run maximum.

    ``shard_of`` (device label -> shard index) additionally maintains a
    per-shard peak watermark ``shard_memory_peak_bytes{shard=...}``; one
    device trains until multi-GPU training (ROADMAP A21) names shards."""
    readings = sample()
    for rec in readings:
        dev = rec["device"]
        for k in _STATS:
            g = registry.gauge("device_memory_bytes",
                               "device allocator stats", device=dev, stat=k)
            if k == "peak_bytes_in_use":
                g.set_max(rec[k])
            else:
                g.set(rec[k])
        shard = (shard_of or {}).get(dev)
        if shard is not None:
            registry.gauge("shard_memory_peak_bytes",
                           "per-row-shard device memory high watermark",
                           shard=str(shard)).set_max(rec["peak_bytes_in_use"])
    return readings


def watermark(readings: Optional[List[Dict[str, Any]]] = None
              ) -> Dict[str, Any]:
    """Highest peak across devices; {} when no device reports stats."""
    readings = sample() if readings is None else readings
    peaks = [r["peak_bytes_in_use"] for r in readings]
    if not peaks:
        return {}
    return {"peak_bytes_in_use_max": max(peaks),
            "devices_reporting": len(peaks)}
