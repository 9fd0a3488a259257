"""Persistent, device-resident prediction engine (serving path).

Port of ``lightgbm_tpu/serving.py`` (reference analog: the batch
``Predictor``, predictor.hpp:29, which builds its per-tree closures once
and reuses them for every query). A ``PredictEngine`` holds one model
version:

- the routing tables of ``io/pseudo_bins.PseudoRouter`` (split features,
  pseudo-bin thresholds, default directions, children, categorical
  membership) and the trees' f64 leaf values are uploaded to an explicit
  device once, and invalidated only when the tree list changes;
- each batch is pseudo-binned on the host in f64 (exact) by
  ``PseudoRouter.bin_matrix``, a large batch in row blocks on a pool of
  host threads (numpy releases the GIL in its loops), then padded to a
  small set of power-of-two row buckets (with an n = 1 fast path) and
  uploaded as int32;
- the card walks **every tree at once**: ``router.max_steps`` steps, each
  one gather of the nodes' (feature, threshold, children, default)
  records and the rows' pseudo-bins over the [rows, trees] node
  pointers, with no host sync inside the walk;
- the leaf values are summed in f64 in tree order, class by class, as
  ``ops/predict.predict_raw`` sums them, so the engine's scores equal the
  plain walk's bit for bit (the padding rows are dropped before the sum);
- matrices larger than ``chunk_rows`` stream through bounded
  double-buffered chunks: a producer thread pseudo-bins chunk i+1 on the
  host while the card walks chunk i.

``ops/predict.predict_raw`` / ``predict_leaf`` (a walk of raw f64 values,
one tree at a time) stay as the plain versions the tests hold the engine
against. The walk is plain PyTorch: the reference serves through XLA
(einsums on the MXU, or a ``vmap`` of ``route_bins``), not through a
Pallas kernel, so there is no TPU kernel to port here; a hand-written walk
is later work (ROADMAP).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch


from . import obs
from .io.pseudo_bins import PseudoRouter
from .utils import faults

# rows per streamed chunk; the tail is padded up to the same shape
_DEF_CHUNK = 1 << 17
# smallest padded batch besides the n = 1 fast path: at most log2(chunk/8)
# + 2 bucket shapes, at most 7 padded rows on a tiny batch
_MIN_BUCKET = 8
# the fewest rows a block of the threaded host pseudo-binning gets
_BIN_BLOCK = 16384
_POOL_LOCK = threading.Lock()
_BIN_POOL: Optional[ThreadPoolExecutor] = None


def _bin_pool() -> ThreadPoolExecutor:
    global _BIN_POOL
    with _POOL_LOCK:
        if _BIN_POOL is None:
            _BIN_POOL = ThreadPoolExecutor(max_workers=os.cpu_count() or 1,
                                           thread_name_prefix="pseudo-bin")
        return _BIN_POOL


def bucket_rows(n: int, min_bucket: int = _MIN_BUCKET,
                max_bucket: int = _DEF_CHUNK) -> int:
    """Pad target for an n-row batch: 1 for online scoring, else the next
    power of two clamped to [min_bucket, max_bucket]."""
    if n <= 1:
        return 1
    b = 1 << (n - 1).bit_length()
    return max(min_bucket, min(b, max_bucket))


class PredictEngine:
    """Device-resident predictor for one model version (a fixed tree list).

    Construction uploads the routing tables to ``device``; ``predict`` then
    only moves the query rows. Rebuild (via Booster) when the tree list
    changes."""

    def __init__(self, trees, n_features: int, k: int, avg_output: bool,
                 objective=None, chunk_rows: Optional[int] = None,
                 min_bucket: int = _MIN_BUCKET, upload_reason: str = "new",
                 device: Optional[torch.device] = None):
        t0 = time.perf_counter()
        self.device = torch.device(device) if device is not None \
            else torch.device("cuda", torch.cuda.current_device())
        self.router = PseudoRouter(trees, n_features)
        # the model version this engine serves: Booster.predict rebuilds
        # the engine when its tree list holds another tree anywhere
        self.trees = tuple(trees)
        self.n_trees = len(trees)
        self.k = max(int(k), 1)
        self.avg = bool(avg_output)
        self.objective = objective
        self.chunk_rows = int(chunk_rows if chunk_rows is not None
                              else _DEF_CHUNK)
        self.min_bucket = int(min_bucket)
        self.max_steps = self.router.max_steps
        # categorical membership words a node (0: no categorical node)
        self._cat_w = (int(self.router.stack["cat_mask"].shape[2])
                       if "cat_mask" in self.router.stack else 0)
        self._tables: Optional[Dict[str, torch.Tensor]] = self._upload(trees)
        # bucket and chunk traffic for the tests and chip_smoke.py; the lock
        # guards these host counters when predict runs on several threads
        self.stats = {"calls": 0, "chunked_calls": 0, "chunks": 0,
                      "buckets_seen": set()}
        self._stats_lock = threading.Lock()
        self.released = False
        obs.emit("engine_upload", n_trees=int(self.n_trees),
                 num_class=int(self.k), reason=upload_reason,
                 duration_s=time.perf_counter() - t0)
        if obs.enabled():
            obs.METRICS.counter("engine_uploads",
                                "PredictEngine table uploads",
                                reason=upload_reason).inc()

    def _upload(self, trees) -> Dict[str, torch.Tensor]:
        """The walk's tables on the device, flattened over (tree, node):
        int64 indices, bool flags, the f64 leaf values [T, max_leaves]."""
        st = self.router.stack
        dev = self.device
        t_cnt, n_int = st["split_feature"].shape
        max_l = st["leaf_value"].shape[1]
        lv = np.zeros((t_cnt, max_l), dtype=np.float64)
        for ti, t in enumerate(trees):
            lv[ti, :t.num_leaves] = np.asarray(t.leaf_value, np.float64)

        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a).reshape(-1),
                                   device=dev).to(dtype)

        # one record a node, gathered once a step: feature, threshold,
        # left child, right child, default left
        node = np.stack([st[k].reshape(-1).astype(np.int64) for k in (
            "split_feature", "threshold_bin", "left_child", "right_child",
            "default_left")], axis=1)
        tabs = {"node": torch.as_tensor(node, device=dev),
                "start": torch.as_tensor(
                    np.where(st["num_leaves"] > 1, 0, -1).astype(np.int64),
                    device=dev),
                "base": torch.arange(t_cnt, dtype=torch.int64,
                                     device=dev) * n_int,
                "lbase": torch.arange(t_cnt, dtype=torch.int64,
                                      device=dev) * max_l,
                "lv": torch.as_tensor(lv.reshape(-1), device=dev),
                "na": torch.as_tensor(self.router.na_id.astype(np.int64),
                                      device=dev)}
        if "is_cat" in st:
            tabs["is_cat"] = up(st["is_cat"], torch.bool)
            tabs["cat"] = up(st["cat_mask"], torch.bool)
        return tabs

    def bin_rows(self, x: np.ndarray) -> np.ndarray:
        """``router.bin_matrix`` of raw rows [N, F] (int32, the same array):
        past two blocks of ``_BIN_BLOCK`` rows, row blocks binned on the
        host thread pool into one output."""
        n = x.shape[0]
        k = min(os.cpu_count() or 1, n // _BIN_BLOCK)
        if k <= 1:
            return self.router.bin_matrix(np.asarray(x, dtype=np.float64))
        out = np.empty(x.shape, dtype=np.int32)
        edges = np.linspace(0, n, k + 1).astype(np.int64)

        def block(lo_hi):
            lo, hi = lo_hi
            self.router.bin_matrix(np.asarray(x[lo:hi], dtype=np.float64),
                                   out=out[lo:hi])
        list(_bin_pool().map(block, zip(edges[:-1], edges[1:])))
        return out

    # ---- core ----

    def _leaves(self, pbins: torch.Tensor) -> torch.Tensor:
        """Leaf index [B, T] i64 of each row of a device pseudo-bin matrix
        [B, F] i32 in each tree: every tree walked at once, one step per
        level for ``max_steps`` steps (reference: route_bins under a vmap
        over trees, ops/predict.py:18, :201)."""
        tb = self._tables
        pb = pbins.to(torch.int64)
        n, t_cnt = pb.shape[0], tb["base"].shape[0]
        ptr = tb["start"].expand(n, t_cnt).clone()
        cat_w = self._cat_w
        for _ in range(self.max_steps):
            node = tb["base"] + ptr.clamp(min=0)
            rec = tb["node"].index_select(0, node.view(-1)).view(
                n, t_cnt, 5)
            feat = rec[..., 0]
            col = pb.gather(1, feat)
            go_left = torch.where(col == tb["na"][feat], rec[..., 4] != 0,
                                  col <= rec[..., 1])
            if cat_w:
                mem = tb["cat"][node * cat_w + col.clamp(0, cat_w - 1)] \
                    & (col < cat_w)
                go_left = torch.where(tb["is_cat"][node], mem, go_left)
            nxt = torch.where(go_left, rec[..., 2], rec[..., 3])
            ptr = torch.where(ptr >= 0, nxt, ptr)
        return ~ptr.clamp(max=-1)

    def _raw(self, leaves: torch.Tensor) -> torch.Tensor:
        """Raw f64 scores [n] or [n, k] of the leaves [n, T]: the leaf
        values summed in tree order, tree t into class t mod k, the order
        of ``ops/predict.predict_raw``."""
        tb = self._tables
        vals = tb["lv"][tb["lbase"] + leaves]
        out = torch.zeros((leaves.shape[0], self.k), dtype=torch.float64,
                          device=self.device)
        for t in range(vals.shape[1]):
            out[:, t % self.k] += vals[:, t]
        if self.avg and self.n_trees:
            out = out / (self.n_trees // self.k)
        return out[:, 0] if self.k == 1 else out

    def _finish(self, leaves: torch.Tensor, raw_score: bool,
                pred_leaf: bool) -> np.ndarray:
        if pred_leaf:
            return leaves.cpu().numpy()
        raw = self._raw(leaves)
        if not raw_score and self.objective is not None:
            raw = self.objective.convert_output(raw)
        return raw.cpu().numpy()

    def run_binned(self, bins: np.ndarray, n: int, raw_score: bool = False,
                   pred_leaf: bool = False,
                   trace: Optional[Dict[str, float]] = None) -> np.ndarray:
        """Score an already pseudo-binned matrix: the first ``n`` rows of
        ``bins`` are real, the rest (if any) padding. Pads to the
        power-of-two bucket, uploads and walks; ``trace`` collects the
        device_dispatch / readback breakdown of request tracing (host clock
        reads only)."""
        if self.released:
            raise RuntimeError("PredictEngine used after release() — "
                               "retired model version")
        b = bucket_rows(n, self.min_bucket, self.chunk_rows)
        with self._stats_lock:
            self.stats["buckets_seen"].add(b)
        if bins.shape[0] != b:
            if bins.shape[0] > b:
                bins = bins[:b]
            else:
                bins = np.pad(bins, ((0, b - bins.shape[0]), (0, 0)))
        t0 = time.perf_counter()
        # device chaos point at the batch's upload (the real
        # torch.cuda.OutOfMemoryError type), as at ingest.py's copy
        faults.fault_point("device_put_oom")
        pbins = torch.as_tensor(np.ascontiguousarray(bins, np.int32),
                                device=self.device)
        leaves = self._leaves(pbins)[:n]
        t1 = time.perf_counter()
        out = self._finish(leaves, raw_score, pred_leaf)
        if trace is not None:
            trace["device_dispatch"] = trace.get("device_dispatch", 0.0) + \
                (t1 - t0)
            trace["readback"] = time.perf_counter() - t1
        return out

    def _predict_chunked(self, x: np.ndarray, raw_score: bool,
                         pred_leaf: bool) -> np.ndarray:
        """Bounded double-buffered streaming: the producer thread
        pseudo-bins chunk i+1 on the host (f64) while the card walks chunk
        i; every chunk is padded to the same shape. An error of the
        producer is re-raised here."""
        n, c = x.shape[0], self.chunk_rows
        q: "queue.Queue" = queue.Queue(maxsize=2)
        err: List[BaseException] = []
        stop = threading.Event()

        def producer():
            try:
                for i in range(0, n, c):
                    if stop.is_set():
                        return
                    bins = self.bin_rows(np.asarray(x[i: i + c]))
                    q.put((bins, bins.shape[0]))
            except BaseException as e:
                err.append(e)
            finally:
                q.put(None)

        th = threading.Thread(target=producer, daemon=True,
                              name="predict-producer")
        th.start()
        outs = []
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                bins, m = item
                with self._stats_lock:
                    self.stats["chunks"] += 1
                outs.append(self.run_binned(bins, m, raw_score, pred_leaf))
        finally:
            stop.set()
            while th.is_alive():   # unblock a producer waiting on the queue
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            th.join()
        if err:
            raise err[0]
        return np.concatenate(outs, axis=0)

    def predict(self, x: np.ndarray, raw_score: bool = False,
                pred_leaf: bool = False) -> np.ndarray:
        """Predict on host features [N, F] (already numpy 2-D and
        width-checked by the caller). Returns [N] / [N, k] f64 scores or
        [N, T] i64 leaf indices."""
        n = x.shape[0]
        tele = obs.enabled()
        t0 = time.perf_counter() if tele else 0.0
        chunks_before = self.stats["chunks"]
        chunked = n > self.chunk_rows
        with self._stats_lock:
            self.stats["calls"] += 1
            self.stats["chunked_calls"] += int(chunked)
        if chunked:
            out = self._predict_chunked(x, raw_score, pred_leaf)
        else:
            out = self.run_binned(self.bin_rows(np.asarray(x)), n,
                                  raw_score, pred_leaf)
        if tele:
            # a chunked batch is attributed to the chunk-sized bucket
            dt = time.perf_counter() - t0
            b = self.chunk_rows if chunked \
                else bucket_rows(n, self.min_bucket, self.chunk_rows)
            obs.METRICS.histogram("predict_latency_seconds",
                                  "predict wall time by row bucket",
                                  bucket=str(b)).observe(dt)
            obs.METRICS.counter("predict_calls", "predict() calls").inc()
            obs.METRICS.counter("predict_rows", "rows scored").inc(n)
            fields = {"rows": int(n), "bucket": int(b), "duration_s": dt,
                      "chunked": chunked}
            if chunked:
                fields["chunks"] = int(self.stats["chunks"] - chunks_before)
            obs.emit("predict_batch", **fields)
        return out

    def release(self) -> None:
        """Drop the device-resident tables (a retired model version:
        server.py calls this once a swapped-out version has drained). The
        engine must not be used afterwards."""
        self._tables = None
        self.released = True

    def warmup(self, sizes=(1,), n_features: Optional[int] = None,
               pred_leaf: bool = False) -> None:
        """Run a zero matrix through each bucket that ``sizes`` lands in,
        so that the caching allocator holds each bucket's blocks before
        traffic arrives."""
        f = int(n_features if n_features is not None
                else len(self.router.na_id))
        done = set()
        for s in sizes:
            b = bucket_rows(int(s), self.min_bucket, self.chunk_rows)
            if b in done:
                continue
            done.add(b)
            z = np.zeros((min(int(s), self.chunk_rows), f))
            self.predict(z, raw_score=False, pred_leaf=pred_leaf)
            if self.objective is not None:
                self.predict(z, raw_score=True, pred_leaf=pred_leaf)
