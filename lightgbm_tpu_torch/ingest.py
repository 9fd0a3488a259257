"""Chunked three-stage ingest pipeline: encode -> H2D -> commit.

Port of ``lightgbm_tpu/ingest.py`` (reference analog: ``PipelineReader``,
utils/pipeline_reader.h, and the OpenCL learner's asynchronous feature
upload). A dense matrix is cut into row chunks of ``ingest_chunk_rows``
that flow through three stages over bounded queues:

- **encode**: a pool of ``encode_threads`` host workers copies each chunk's
  used columns into a pinned staging buffer, C-contiguous, in the dtype
  the device encode reads (f32 or f64 as the rows come, else f64; numpy
  releases the GIL for the copy, so chunks really copy in parallel). The
  reference bins on the host here and uploads uint8; on the H100 that
  encode took 10.46 s for (a)'s 10.5M x 28 rows against 0.12 s binned on
  the card (PERF.md), so the card bins;
- **H2D**: one thread issues ``copy_(..., non_blocking=True)`` of each
  staged chunk on a dedicated copy stream and records an event; the
  staging buffer goes back to the pool with that event, and an encoder
  waits on it before writing the buffer again, so a buffer is never
  overwritten while its copy is in flight;
- **commit**: one thread makes the compute stream wait on the chunk's
  event, bins the chunk on the card with the Dataset's mappers
  (``BinMapper.values_to_bins_torch``), applies the EFB bundles
  (``efb.apply_bundles``) and writes its rows into one ``[N, width]``
  uint8 accumulator. The chunk tensor was allocated on the copy stream,
  so ``record_stream`` keeps the caching allocator from handing its
  memory out again before the compute stream is done with it.

The first exception of any stage is stashed and re-raised on the caller's
thread after every stage has joined; the other stages drain their queues
without working, so nothing blocks. Chunks write disjoint rows with a
per-row function, so neither the chunking nor the thread count nor the
completion order can change a bit of the result (tests/test_torch_ingest.py).

On the card, a stage's busy seconds are device times (CUDA events around
each copy and each commit) and the encode's are host seconds summed over
the workers; on the CPU all three are host seconds.

Row-sharded ingest (reference: ingest.py:121-175, :278-315): with a
``RowShardPlan`` (parallel/mesh.py) the chunk grid is aligned to the shard
grid, so that a chunk never spans two shards; each chunk is copied
straight to its shard's device and committed into that shard's own
``[rows_per_shard, width]`` block there (the ``shard_commit`` fault point,
the ``mesh_shard_commit`` event), so the whole matrix is never needed on
one device; the padding rows of the last shard stay zero. The recovery
rungs (``stream_with_recovery``) halve the chunk, then re-plan the
sharding over more devices (``reshard``) or drop it (``fallback_single``).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import efb, obs
from .binning import BinMapper
from .log import LightGBMError, debug, warning
from .utils import faults

# stats of the most recent pipeline run (scripts and chip_smoke.py read
# them); guarded: a construct may run on a worker thread while another
# thread reads
_STATS_LOCK = threading.Lock()
LAST_INGEST_STATS: Dict[str, Any] = {}


def resolve_encode_threads(requested: int) -> int:
    """0 = auto: enough host threads to keep the encode off the critical
    path without oversubscribing the host."""
    if requested and requested > 0:
        return int(requested)
    return max(1, min(4, os.cpu_count() or 1))


def overlap_efficiency(stage_spans, wall_s: float) -> float:
    """How much of the possible stage overlap was realized, in [0, 1]:
    with no overlap the wall is the sum of the stages' busy spans, with
    perfect overlap their largest; the ratio (sum - wall) / (sum - max) is
    clamped, and 1.0 when one stage dominates so far that nothing is left
    to hide."""
    total = float(sum(stage_spans))
    longest = float(max(stage_spans)) if stage_spans else 0.0
    max_savable = total - longest
    if max_savable <= 1e-9:
        return 1.0
    saved = total - float(wall_s)
    return max(0.0, min(1.0, saved / max_savable))


def stage_dtype(raw: np.ndarray) -> np.dtype:
    """The staging dtype of a dense matrix for the device encode: its own
    when f32 or f64 (exact in f64 on the card), else f64."""
    dt = np.dtype(raw.dtype)
    return dt if dt in (np.dtype(np.float32), np.dtype(np.float64)) \
        else np.dtype(np.float64)


def bin_rows_device(chunk: torch.Tensor, mappers: Sequence[BinMapper]
                    ) -> torch.Tensor:
    """The uint8 bins [rows, F_used] of staged raw rows [rows, F_used] on
    their device, a column at a time with its mapper."""
    out = torch.empty(chunk.shape, dtype=torch.uint8, device=chunk.device)
    for k, m in enumerate(mappers):
        out[:, k] = m.values_to_bins_torch(
            chunk[:, k].to(torch.float64)).to(torch.uint8)
    return out


def _check_widths(mappers: Sequence[BinMapper], columns) -> None:
    for k, m in enumerate(mappers):
        if m.num_bins > 256:
            raise LightGBMError(f"feature {columns[k]}: {m.num_bins} bins > "
                                "256 unsupported")


def stream_encode_upload(raw: np.ndarray, mappers: Sequence[BinMapper],
                         columns: Sequence[int], meta, device: torch.device,
                         *, chunk_rows: int, encode_threads: int = 0,
                         phases: Optional[Dict[str, Any]] = None,
                         shard_plan=None):
    """Run the three stages over ``raw`` [N, F_raw] and return the bin
    matrix [N, width] uint8 on ``device``: one column a used feature
    (``columns`` are their raw indices), or the EFB plan ``meta``'s columns.
    With a ``shard_plan``, the list of the shards' ``[rows_per_shard,
    width]`` blocks instead, each on its shard's device. ``phases``
    (optional) receives the stages' busy breakdown and
    ``overlap_efficiency``."""
    _check_widths(mappers, columns)
    n = int(raw.shape[0])
    f_used = len(columns)
    width = meta.num_columns if meta is not None else f_used
    if n == 0 and shard_plan is None:
        return torch.zeros((0, width), dtype=torch.uint8, device=device)
    chunk_rows = max(1, int(chunk_rows))
    if shard_plan is not None:
        # the chunk grid aligned to the shard grid: each chunk lies in one
        # shard's rows
        chunk_rows = min(chunk_rows, shard_plan.rows_per_shard)
        spans = []
        for s in range(shard_plan.num_shards):
            lo, hi = shard_plan.shard_rows_range(s)
            spans.extend((s, g0, min(g0 + chunk_rows, hi))
                         for g0 in range(lo, hi, chunk_rows))
        tasks = [(ci, s, g0, g1) for ci, (s, g0, g1) in enumerate(spans)]
    else:
        tasks = [(ci, None, g0, min(g0 + chunk_rows, n))
                 for ci, g0 in enumerate(range(0, n, chunk_rows))]
    threads = min(resolve_encode_threads(encode_threads), max(len(tasks), 1))
    cuda = device.type == "cuda"
    tele = obs.enabled()
    cols = np.asarray(columns, dtype=np.int64)
    identity = (f_used == raw.shape[1]
                and np.array_equal(cols, np.arange(f_used)))
    tdt = torch.from_numpy(np.zeros(0, stage_dtype(raw))).dtype
    # staging buffers: every encoder one, plus one queued for the copy
    # (the copy's own is free again once its event fires)
    n_buf = min(threads + 2, len(tasks) + 1)
    buf_rows = max(1, min(chunk_rows, n))
    free_q: "queue.Queue" = queue.Queue()
    for _ in range(n_buf):
        free_q.put((torch.empty((buf_rows, f_used), dtype=tdt,
                                pin_memory=cuda), None))
    work_q: "queue.Queue" = queue.Queue()
    for t in tasks:
        work_q.put(t)
    enc_q: "queue.Queue" = queue.Queue(maxsize=2)   # staged, awaiting H2D
    dev_q: "queue.Queue" = queue.Queue(maxsize=2)   # copied, awaiting commit
    state: Dict[str, Any] = {"exc": None, "encode_s": 0.0, "h2d_s": 0.0,
                             "commit_s": 0.0}
    lock = threading.Lock()
    # commit order: (ci, rows, encode s, h2d, commit, queue depth); h2d and
    # commit are CUDA event pairs on the card, host seconds on the CPU
    done: List[tuple] = []
    # the commit device of each shard (one device without a plan), its
    # compute stream and a copy stream of its own
    shard_dev = (list(shard_plan.devices) if shard_plan is not None
                 else [device])
    streams = {}
    for d in shard_dev:
        if cuda and d not in streams:
            streams[d] = (torch.cuda.current_stream(d), torch.cuda.Stream(d))
    if shard_plan is None:
        accs = [torch.empty((n, width), dtype=torch.uint8, device=device)]
    else:
        # the padding rows past the last real row stay zero
        accs = [torch.zeros((shard_plan.rows_per_shard, width),
                            dtype=torch.uint8, device=d) for d in shard_dev]

    def failed() -> bool:
        with lock:
            return state["exc"] is not None

    def fail(e: BaseException) -> None:
        with lock:
            if state["exc"] is None:
                state["exc"] = e

    def encode_loop():
        while True:
            try:
                ci, shard, g0, g1 = work_q.get_nowait()
            except queue.Empty:
                return
            if failed():
                continue   # drain the work list without encoding
            buf, ev = free_q.get()
            try:
                t0 = time.perf_counter()
                if ev is not None:
                    ev.synchronize()   # the buffer's last copy has finished
                rows = g1 - g0
                view = buf[:rows].numpy()
                part = raw[g0:g1]
                if identity:
                    view[...] = part
                else:
                    np.take(part, cols, axis=1, out=view)
                dt = time.perf_counter() - t0
                with lock:
                    state["encode_s"] += dt
                enc_q.put((ci, shard, g0, rows, buf, dt))
            except BaseException as e:   # surfaced after the join
                free_q.put((buf, None))
                fail(e)

    def h2d_loop():
        while True:
            item = enc_q.get()
            if item is None:
                dev_q.put(None)
                return
            ci, shard, g0, rows, buf, enc_dt = item
            dev = shard_dev[shard or 0]
            if failed():
                free_q.put((buf, None))
                continue   # keep draining so that no encoder blocks
            try:
                t0 = time.perf_counter()
                # chaos point: a simulated device OOM at the copy (raises
                # the real torch.cuda.OutOfMemoryError type)
                faults.fault_point("device_put_oom")
                if cuda:
                    copy_stream = streams[dev][1]
                    with torch.cuda.stream(copy_stream):
                        ev0 = torch.cuda.Event(enable_timing=True)
                        ev1 = torch.cuda.Event(enable_timing=True)
                        chunk = torch.empty((rows, f_used), dtype=tdt,
                                            device=dev)
                        ev0.record(copy_stream)
                        chunk.copy_(buf[:rows], non_blocking=True)
                        ev1.record(copy_stream)
                    free_q.put((buf, ev1))
                    timing = (ev0, ev1)
                else:
                    chunk = buf[:rows].to(dev, copy=True)
                    free_q.put((buf, None))
                    timing = time.perf_counter() - t0
                    with lock:
                        state["h2d_s"] += timing
                dev_q.put((ci, shard, g0, rows, chunk, timing, enc_dt))
            except BaseException as e:
                free_q.put((buf, None))
                fail(e)

    def commit_loop():
        while True:
            item = dev_q.get()
            if item is None:
                return
            if failed():
                continue
            ci, shard, g0, rows, chunk, timing, enc_dt = item
            try:
                t0 = time.perf_counter()
                if shard is not None:
                    # chaos point: a chunk's commit into its row shard's
                    # block failed (a lost device, a dead buffer)
                    faults.fault_point("shard_commit")
                if cuda:
                    compute = streams[shard_dev[shard or 0]][0]
                    with torch.cuda.stream(compute):
                        compute.wait_event(timing[1])
                        chunk.record_stream(compute)
                        c0 = torch.cuda.Event(enable_timing=True)
                        c1 = torch.cuda.Event(enable_timing=True)
                        c0.record(compute)
                        _commit(chunk, shard, g0, rows)
                        c1.record(compute)
                    commit = (c0, c1)
                else:
                    _commit(chunk, shard, g0, rows)
                    commit = time.perf_counter() - t0
                    with lock:
                        state["commit_s"] += commit
                depth = enc_q.qsize() + dev_q.qsize()
                done.append((ci, shard, rows, enc_dt, timing, commit, depth))
                if tele:
                    obs.METRICS.gauge(
                        "ingest_pipeline_depth",
                        "high-water chunks queued between ingest stages"
                    ).set_max(depth + 1)
                    obs.METRICS.counter("ingest_chunks",
                                        "chunks through the pipeline").inc()
            except BaseException as e:
                fail(e)

    def _commit(chunk: torch.Tensor, shard: Optional[int], g0: int,
                rows: int) -> None:
        bins = bin_rows_device(chunk, mappers)
        if meta is not None:
            bins = efb.apply_bundles(bins, meta)
        if shard is None:
            accs[0][g0:g0 + rows] = bins
        else:
            local0 = g0 - shard * shard_plan.rows_per_shard
            accs[shard][local0:local0 + rows] = bins

    t_wall = time.perf_counter()
    encoders = [threading.Thread(target=encode_loop, daemon=True,
                                 name=f"ingest-encode-{i}")
                for i in range(threads)]
    up = threading.Thread(target=h2d_loop, daemon=True, name="ingest-h2d")
    cm = threading.Thread(target=commit_loop, daemon=True,
                          name="ingest-commit")
    for th in encoders + [up, cm]:
        th.start()
    try:
        for th in encoders:
            th.join()
    finally:
        enc_q.put(None)   # h2d_loop forwards the sentinel to commit_loop
        up.join()
        cm.join()
    if cuda and state["exc"] is None:
        try:
            # a CUDA error of any chunk surfaces here, on the caller's
            # thread, and fails the construct
            for compute, copy_stream in streams.values():
                copy_stream.synchronize()
                compute.synchronize()
        except BaseException as e:
            fail(e)
    if state["exc"] is not None:
        raise state["exc"]
    wall = time.perf_counter() - t_wall
    events = []
    for ci, shard, rows, enc_dt, h2d, commit, depth in done:
        if cuda:
            h2d = h2d[0].elapsed_time(h2d[1]) * 1e-3
            commit = commit[0].elapsed_time(commit[1]) * 1e-3
            state["h2d_s"] += h2d
            state["commit_s"] += commit
        events.append((ci, shard, rows, enc_dt, h2d, commit, depth))
    if tele:
        for ci, shard, rows, enc_dt, h2d, commit, depth in events:
            obs.emit("ingest_chunk", chunk=int(ci), rows=int(rows),
                     encode_s=float(enc_dt), h2d_s=float(h2d),
                     commit_s=float(commit), depth=int(depth))
            if shard is not None:
                obs.emit("mesh_shard_commit", shard=int(shard),
                         rows=int(rows), bytes=int(rows * width),
                         chunk=int(ci), h2d_s=float(h2d),
                         commit_s=float(commit))
    # per-stage ideal spans: the encode's busy time is summed over the
    # workers, so it is divided by the pool size
    spans = (state["encode_s"] / max(threads, 1), state["h2d_s"],
             state["commit_s"])
    eff = overlap_efficiency(spans, wall)
    stats = {"encode_s": round(state["encode_s"], 6),
             "h2d_s": round(state["h2d_s"], 6),
             "commit_s": round(state["commit_s"], 6),
             "encode_threads": threads, "chunks": len(tasks),
             "chunk_rows": chunk_rows, "wall_s": round(wall, 6),
             "overlap_efficiency": round(eff, 3),
             "shards": (shard_plan.num_shards if shard_plan is not None
                        else 1)}
    with _STATS_LOCK:
        LAST_INGEST_STATS.clear()
        LAST_INGEST_STATS.update(stats)
    if phases is not None:
        phases["stream_busy"] = {k: stats[k] for k in
                                 ("encode_s", "h2d_s", "commit_s",
                                  "encode_threads", "chunks")}
        phases["overlap_efficiency"] = stats["overlap_efficiency"]
    debug("ingest pipeline: %s", stats)
    return accs if shard_plan is not None else accs[0]


def last_stats() -> Dict[str, Any]:
    """Copy of the most recent pipeline run's stage breakdown."""
    with _STATS_LOCK:
        return dict(LAST_INGEST_STATS)


# OOM-adaptive degradation bounds (stream_with_recovery): at most this many
# chunk halvings, and a cap on all recovery attempts so that a persistent
# fault cannot loop forever
MAX_CHUNK_HALVINGS = 3
MAX_RECOVERY_ATTEMPTS = 8


def _grow_plan(plan):
    """The row sharding re-planned over more devices (double, clamped to
    the device count), or None when it cannot grow."""
    if plan is None:
        return None
    from .parallel.mesh import device_count, plan_row_sharding
    fs = int(plan.feature_shards or 1)
    kind = plan.devices[0].type
    nd = device_count(kind) // fs
    if plan.num_shards >= nd:
        return None
    return plan_row_sharding(plan.n_rows, min(nd, plan.num_shards * 2),
                             axis_name=plan.axis_name, feature_shards=fs,
                             kind=kind)


def stream_with_recovery(raw, mappers, columns, meta, device, *,
                         chunk_rows: int, encode_threads: int = 0,
                         phases: Optional[Dict[str, Any]] = None,
                         policy: str = "reshard", sleep=time.sleep,
                         shard_plan=None):
    """:func:`stream_encode_upload` with OOM-adaptive degradation
    (reference: stream_with_recovery, ingest.py:407-494). A device fault in
    the pipeline (``torch.cuda.OutOfMemoryError``, or an armed device
    point: ``device_put_oom``, ``shard_commit``) is recovered by the
    ``on_device_fault`` policy, each rung emitting ``device_fault`` and
    backing off:

    1. the chunk is halved, up to :data:`MAX_CHUNK_HALVINGS` times;
    2. then ``reshard`` re-plans the row sharding over more devices (each
       shard's block shrinks), or ``fallback_single`` drops the plan and
       drains through the single-device path with a warning; without a
       plan that can change, the fault is raised;
    3. ``fatal`` (or a fault that is not a device fault) raises at once.

    Returns ``(bins, plan, chunk_rows)``: the plan and the chunk size
    actually used, which the caller adopts."""
    from .utils.retry import backoff_delays

    plan = shard_plan
    rows = max(1, int(chunk_rows))
    halvings = 0
    attempt = 0
    delays = list(backoff_delays(MAX_RECOVERY_ATTEMPTS + 1,
                                 base_delay=0.05, max_delay=1.0))
    while True:
        try:
            bins = stream_encode_upload(
                raw, mappers, columns, meta, device, chunk_rows=rows,
                encode_threads=encode_threads, phases=phases,
                shard_plan=plan)
            return bins, plan, rows
        except BaseException as e:
            if policy == "fatal" or not faults.is_device_fault(e):
                raise
            attempt += 1
            if attempt > MAX_RECOVERY_ATTEMPTS:
                raise
            before = plan.num_shards if plan is not None else 1
            if halvings < MAX_CHUNK_HALVINGS and rows > 1:
                rows = max(1, rows // 2)
                halvings += 1
                action = "halve_chunk"
                warning(f"device fault during ingest ({type(e).__name__}: "
                        f"{e}); halving chunk to {rows} rows and retrying "
                        f"({halvings}/{MAX_CHUNK_HALVINGS})")
            elif policy == "reshard" and _grow_plan(plan) is not None:
                plan = _grow_plan(plan)
                action = "reshard"
                warning("device fault persists after chunk halving; "
                        f"re-planning row sharding {before} -> "
                        f"{plan.num_shards} shards")
            elif policy == "fallback_single" and plan is not None:
                plan = None
                action = "fallback_single"
                warning("device fault persists after chunk halving; "
                        "draining to the single-device ingest path (mesh "
                        "training disabled for this dataset)")
            else:
                raise
            if device.type == "cuda":
                torch.cuda.empty_cache()
            obs.emit("device_fault", point=faults.classify_point(e),
                     policy=policy, action=action,
                     error=f"{type(e).__name__}: {e}", attempt=attempt,
                     chunk_rows=int(rows), shards_before=int(before),
                     shards_after=int(plan.num_shards if plan is not None
                                      else 1))
            sleep(delays[min(attempt - 1, len(delays) - 1)])
