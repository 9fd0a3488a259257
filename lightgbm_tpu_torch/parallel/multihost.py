"""Training across processes: sharded ingest, merged-sketch global bins and
the cross-rank transport.

Port of ``lightgbm_tpu/parallel/multihost.py`` over ``torch.distributed``
(reference analogs: ``pre_partition=true`` loading,
dataset_loader.cpp:505-541, and the bin-sync Allgather of
dataset_loader.cpp:957-1040):

- every process holds only its contiguous block of rows
  (``host_row_range`` / ``load_file_shard``);
- every process sketches its own rows of the one global bin sample, one
  allgather exchanges the sketches and every process merges them in rank
  order: ``BinMapper.from_sketch`` on the merge is bit for bit
  ``find_bin_mappers`` over the concatenated rows (the sample indices are
  the same draw everywhere, a sketch is exact and a merge is
  order-invariant);
- the labels, weights and init scores are gathered to every process
  (``allgather_rows``): the trainer's row-length state (scores, gradients,
  the bag) is global and identical on every rank, each rank's kernels read
  only its own shards' rows, and a tree's per-row deltas are gathered
  after it. So the draws are the one-process draws, rank 0's snapshot is
  the whole state, and the reference's ``replicate_global`` has no
  counterpart.

Every host payload crosses as raw bytes (``wire_encode`` -> one
``torch.distributed.all_gather`` of uint8 tensors in ``_gather_raw`` ->
``wire_decode``), so f64 bounds and i64 counts arrive exact; the
histogram sums of the growers are ``allreduce_sum``. The transport is
the group's backend: NCCL moves payloads on the rank's card, gloo on the
host, each gloo payload copied there explicitly and its bytes and
milliseconds counted (``XFER``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..binning import (BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper,
                       FeatureSketch, check_max_bin_by_feature,
                       merge_sketches, sketch_feature)
from ..log import fatal
from ..utils import faults
from ..utils.retry import call_with_backoff
from . import mesh as M

# host copies of the gloo transport (cross-rank payloads of a card run
# staged through the host): calls, bytes each way and milliseconds
XFER = {"calls": 0, "bytes": 0, "ms": 0.0}
# the ingest's worker threads may still commit while a collective runs
_XFER_LOCK = threading.Lock()


def reset_xfer() -> None:
    with _XFER_LOCK:
        for k in XFER:
            XFER[k] = 0


def _dist():
    import torch.distributed as dist
    return dist


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """Process-level view of the group (reference analog: the machine
    list)."""
    process_index: int
    process_count: int
    local_devices: int
    total_devices: int

    @property
    def is_pod(self) -> bool:
        return self.process_count > 1


def detect_topology(kind: str = "cpu") -> HostTopology:
    """Rank, world size and local devices of ``kind``; every process is
    taken to hold as many devices as this one."""
    p, n = process_index(), process_count()
    nd = M.device_count(kind)
    return HostTopology(p, n, nd, nd * n)


def plan_spans_processes(plan) -> bool:
    """True when the plan is one process's block of a grid over several
    processes: the marker every multi-process branch keys on."""
    return plan is not None and int(getattr(plan, "process_count", 1)) > 1


def plan_pod_sharding(n_global: int, num_shards: int, process: int,
                      processes: int, axis_name: str = M.DATA_AXIS,
                      feature_shards: int = 1,
                      kind: str = "cpu") -> "M.RowShardPlan":
    """This process's block of a ``num_shards``-shard grid over
    ``n_global`` rows: process ``p`` owns global shards ``[p * k, (p + 1)
    * k)``, ``k = num_shards / processes``, on its first ``k *
    feature_shards`` local devices, with the global grid's rows a
    shard."""
    if num_shards % processes:
        fatal(f"num_shards={num_shards} does not divide over "
              f"{processes} processes")
    k = num_shards // processes
    rps = -(-int(n_global) // num_shards)
    fs = max(1, int(feature_shards))
    mesh = M.make_mesh(k * fs, axis_name=axis_name, feature_shards=fs,
                       kind=kind)
    lo = min(process * k * rps, n_global)
    hi = min((process + 1) * k * rps, n_global)
    return M.RowShardPlan(
        mesh=mesh, axis_name=axis_name, num_shards=k, n_rows=hi - lo,
        rows_per_shard=rps, feature_shards=fs, shard0=process * k, row0=lo,
        global_shards=int(num_shards), global_rows=int(n_global),
        process_index=int(process), process_count=int(processes))


def verify_pod_plan(plan) -> None:
    """Fatal unless the plan is a contiguous block of its grid: this
    process's shards are ``[p * k, (p + 1) * k)`` of ``k * processes``
    and its rows those shards' rows, and every feature-axis replica of a
    row shard is a device of this process (the port's mesh holds local
    devices only, so ingest replication never crosses processes)."""
    p, k = plan.process_index, plan.num_shards
    if plan.shards_global != k * plan.process_count or plan.shard0 != p * k:
        fatal(f"pod plan invalid: process {p} holds shards "
              f"[{plan.shard0}, {plan.shard0 + k}) of "
              f"{plan.shards_global} over {plan.process_count} processes")
    if (plan.row0, plan.row0 + plan.n_rows) != host_row_range(plan, p):
        fatal("pod plan invalid: the row block does not match the shards")
    if plan.rows_per_shard != -(-plan.n_global // plan.shards_global):
        fatal("pod plan invalid: rows_per_shard is not the grid's")


def host_row_range(plan, process_index: Optional[int] = None
                   ) -> Tuple[int, int]:
    """Global ``[row0, row1)`` of the real rows process ``process_index``
    (default: this one) owns under the plan's grid (``row1 == row0`` for
    a process of padding only)."""
    p = plan.process_index if process_index is None else int(process_index)
    span = plan.num_shards * plan.rows_per_shard
    return (min(p * span, plan.n_global), min((p + 1) * span,
                                              plan.n_global))


def load_file_shard(path: str, row0: int, row1: int) -> np.ndarray:
    """Rows ``[row0, row1)`` of an ``.npy`` matrix, read through a memory
    map: no process reads the whole matrix."""
    mm = np.load(path, mmap_mode="r")
    return np.array(mm[row0:row1])


# ---- the raw-uint8 wire codec ----

def _gather_raw(wire: np.ndarray) -> np.ndarray:
    """Every rank's equal-length uint8 payload as [P, W]: the one raw
    ``all_gather`` of host payloads (``collectivewatch`` flags any
    other dtype on it)."""
    n = process_count()
    if n <= 1:
        return wire.reshape(1, -1)
    dist = _dist()
    dev = M.DIST["device"] or torch.device("cpu")
    t0 = time.perf_counter()
    t = torch.from_numpy(np.array(wire, dtype=np.uint8)).to(dev)
    outs = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(outs, t)
    out = torch.stack(outs).cpu().numpy()
    if dev.type == "cpu" and M.DIST["card"] is not None:
        _count_host(wire.nbytes + out.nbytes, t0)
    return out


def _count_host(nbytes: int, t0: float) -> None:
    ms = (time.perf_counter() - t0) * 1e3
    with _XFER_LOCK:
        XFER["calls"] += 1
        XFER["bytes"] += int(nbytes)
        XFER["ms"] += ms


def wire_encode(arr: np.ndarray) -> np.ndarray:
    """The contiguous raw bytes (uint8) of a host array."""
    return np.frombuffer(np.ascontiguousarray(arr).tobytes(), dtype=np.uint8)


def wire_decode(wire: np.ndarray, dtype,
                trailing_shape: Tuple[int, ...] = ()) -> np.ndarray:
    """``wire_encode``'s inverse: raw bytes as ``dtype`` over
    ``trailing_shape``, the leading dimension inferred."""
    flat = np.frombuffer(np.ascontiguousarray(wire).tobytes(), dtype=dtype)
    return flat.reshape((-1,) + tuple(int(t) for t in trailing_shape))


def wire_allgather(local: np.ndarray, *, uniform: bool = False
                   ) -> List[np.ndarray]:
    """Allgather a host array of any dtype as raw bytes: one array a rank,
    ``local``'s dtype and trailing shape, leading dimensions free. With
    ``uniform`` the caller asserts an equal shape on every rank and the
    width negotiation (one gather) is skipped."""
    local = np.ascontiguousarray(local)
    wire = wire_encode(local)
    trailing = local.shape[1:] if local.ndim else ()
    if uniform:
        gathered = _gather_raw(wire if wire.size
                               else np.zeros(1, dtype=np.uint8))
        widths = np.full(gathered.shape[0], len(wire), dtype=np.int64)
    else:
        w = wire_encode(np.array([len(wire)], dtype=np.int64))
        widths = wire_decode(_gather_raw(w), np.int64).reshape(-1)
        padded = np.zeros(max(1, int(widths.max())), dtype=np.uint8)
        padded[:len(wire)] = wire
        gathered = _gather_raw(padded)
    return [wire_decode(gathered[r, :int(widths[r])], local.dtype, trailing)
            for r in range(gathered.shape[0])]


# ---- the sketch codec (the bin-sync payload) ----
# per feature: [bin_type, n_distinct, zero_cnt, na_cnt, total_cnt,
# distinct..., counts...], f64 (counts are exact up to 2^53)
_SK_HDR = 5


def encode_sketches(sketches: Sequence[FeatureSketch]) -> np.ndarray:
    parts = []
    for s in sketches:
        nd = len(s.distinct)
        parts.append(np.array([s.bin_type, nd, s.zero_cnt, s.na_cnt,
                               s.total_cnt], dtype=np.float64))
        if nd:
            parts.append(np.asarray(s.distinct, dtype=np.float64))
            parts.append(np.asarray(s.counts, dtype=np.float64))
    return np.concatenate(parts) if parts else np.zeros(0, np.float64)


def decode_sketches(vec: np.ndarray, num_features: int
                    ) -> List[FeatureSketch]:
    out, pos = [], 0
    for _ in range(num_features):
        bt, nd, zc, na, tot = vec[pos:pos + _SK_HDR]
        nd = int(nd)
        pos += _SK_HDR
        distinct = np.asarray(vec[pos:pos + nd], dtype=np.float64).copy()
        counts = np.asarray(vec[pos + nd:pos + 2 * nd]).astype(np.int64)
        pos += 2 * nd
        out.append(FeatureSketch(int(bt), distinct, counts, int(zc),
                                 int(na), int(tot)))
    return out


def allgather_sketches(sketches: Sequence[FeatureSketch], retries: int = 3
                       ) -> List[FeatureSketch]:
    """Exchange the processes' sketches and merge them in rank order, the
    same merge on every process. The ``sketch_allgather`` fault point and
    transient failures retry with backoff; every rank re-enters the same
    pair of gathers."""
    f = len(sketches)
    enc = encode_sketches(sketches)

    def _sync():
        faults.fault_point("sketch_allgather")
        return wire_allgather(enc)

    per_rank = [decode_sketches(v, f) for v in call_with_backoff(
        _sync, attempts=max(1, retries), base_delay=0.2,
        name="bin-sketch allgather")]
    return [merge_sketches([pr[j] for pr in per_rank]) for j in range(f)]


def find_bin_mappers_pod(raw_local: np.ndarray, n_global: int, row0: int,
                         max_bin: int, min_data_in_bin: int = 3,
                         sample_cnt: int = 200000,
                         categorical: Optional[Sequence[int]] = None,
                         use_missing: bool = True,
                         zero_as_missing: bool = False, seed: int = 1,
                         forced_bins=None, max_bin_by_feature=None,
                         retries: int = 3, phases: Optional[dict] = None
                         ) -> List[BinMapper]:
    """Merged-sketch bin finding: the same mappers on every process, and
    bit for bit ``find_bin_mappers`` over the concatenated rows. Every
    process draws the global sample indices (``RandomState(seed)``), keeps
    those in its rows, sketches them and merges the gathered sketches.
    ``phases`` gets the sketch exchange's seconds
    (``sketch_allgather_s``)."""
    n_local, f = raw_local.shape
    if n_global > sample_cnt:
        idx = np.random.RandomState(seed).choice(n_global, sample_cnt,
                                                 replace=False)
        keep = (idx >= row0) & (idx < row0 + n_local)
        sample = raw_local[idx[keep] - row0]
    else:
        sample = raw_local
    cats = set(categorical or ())
    sketches = [sketch_feature(sample[:, j], len(sample),
                               BIN_CATEGORICAL if j in cats
                               else BIN_NUMERICAL) for j in range(f)]
    t0 = time.perf_counter()
    merged = allgather_sketches(sketches, retries=retries)
    if phases is not None:
        phases["sketch_allgather_s"] = time.perf_counter() - t0
    per_feat = check_max_bin_by_feature(max_bin_by_feature, f, max_bin)
    return [BinMapper.from_sketch(
        merged[j], per_feat[j], min_data_in_bin=min_data_in_bin,
        use_missing=use_missing, zero_as_missing=zero_as_missing,
        forced_bounds=(forced_bins or {}).get(j)) for j in range(f)]


def allgather_rows(local: np.ndarray, n_global: int, row0: int,
                   retries: int = 3, name: str = "row allgather"
                   ) -> np.ndarray:
    """Every process's row block of a host array assembled on every
    process (labels, weights, init scores, a tree's row deltas). Blocks
    may differ in length: a (count, offset) gather drives the assembly and
    each payload is padded to the longest. The ``rows_allgather`` fault
    point and transient failures retry with backoff."""
    local = np.ascontiguousarray(local)
    n_local = int(local.shape[0])

    def _sync():
        faults.fault_point("rows_allgather")
        meta = np.stack(wire_allgather(
            np.array([n_local, row0], dtype=np.int64), uniform=True))
        nmax = max(1, int(meta[:, 0].max()))
        padded = np.zeros((nmax,) + local.shape[1:], dtype=local.dtype)
        padded[:n_local] = local
        return meta, wire_allgather(padded, uniform=True)

    meta, per_rank = call_with_backoff(_sync, attempts=max(1, retries),
                                       base_delay=0.2, name=name)
    out = np.zeros((int(n_global),) + local.shape[1:], dtype=local.dtype)
    for r, chunk in enumerate(per_rank):
        cnt, off = int(meta[r, 0]), int(meta[r, 1])
        if cnt:
            out[off:off + cnt] = chunk[:cnt]
    return out


def gather_rows_tensor(local: torch.Tensor, plan) -> torch.Tensor:
    """Every process's rows of a per-row device tensor on every process,
    on ``local``'s device (a tree's leaf ids or score deltas)."""
    full = allgather_rows(local.cpu().numpy(), plan.n_global, plan.row0,
                          name="tree rows allgather")
    return torch.from_numpy(full).to(local.device)


def allreduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, a new tensor on ``t``'s device with the
    same bytes on every rank. Under NCCL the sum runs on the rank's card;
    under gloo ``t`` is copied to the host explicitly, summed there and
    copied back (counted in ``XFER`` when ``t`` lies on a card)."""
    dist = _dist()
    if M.DIST["backend"] == "nccl":
        buf = t.to(M.DIST["device"], copy=True)
        dist.all_reduce(buf)
        return buf.to(t.device)
    t0 = time.perf_counter()
    buf = t.to("cpu", copy=True)
    dist.all_reduce(buf)
    out = buf.to(t.device)
    if t.device.type != "cpu":
        _count_host(2 * buf.numel() * buf.element_size(), t0)
    return out


def level_collective_bytes(num_features: int, max_bin: int, *,
                           num_shards: int, feature_shards: int = 1,
                           voting_top_k: int = 0, hist_slots: int = 1,
                           stat_width: int = 3, dtype_bytes: int = 4) -> dict:
    """Analytic per-device collective volume of one depthwise level, a
    ring all-reduce (2 (S - 1) / S of the payload over each link) over
    ``num_shards``: ``full`` the [slots, 3, F, B] histogram; ``sliced``
    the 2-D mesh's owned F / feature_shards block plus the gather of the
    rest; ``voting`` the two O(F) vote and score sums plus the k elected
    columns."""
    F, B = int(num_features), int(max_bin)
    S = max(1, int(num_shards))
    fs = max(1, int(feature_shards))
    ring = 2.0 * (S - 1) / S
    cell = hist_slots * stat_width * dtype_bytes
    full = ring * F * B * cell
    sliced = ring * (F // fs) * B * cell + ((fs - 1) / fs) * F * B * cell
    k = min(int(voting_top_k), F) if voting_top_k else 0
    voting = (ring * (2 * F * dtype_bytes * hist_slots)
              + ring * k * B * cell) if k else full
    return {"full_bytes": int(full), "sliced_bytes": int(sliced),
            "voting_bytes": int(voting), "num_shards": S,
            "feature_shards": fs, "voting_top_k": k}
