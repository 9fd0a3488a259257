"""Python side of the minimal C ABI (``native/capi.cpp``).

Port of ``lightgbm_tpu/capi_impl.py``. The C library embeds CPython (or
joins a running interpreter) and forwards each ``LGBMTPU_*`` entry here;
arguments cross as raw addresses and sizes, which numpy views without a
copy. The entry names and signatures are the reference's, so one C host
binds either package's library. The device is chosen as everywhere in
this package: ``device_type`` in the parameters (a config file's, a
parameter string's, or the parameter echo of a loaded model file), the GPU
by default. Serving (``server_*``: create, predict, publish, stats,
canary, promote, rollback, fleet stats, close) runs ``server.py`` and
``fleet/``; continuous learning (``dataset_append``, ``online_*``: create,
feed, capture, label, join stats, flush, close) runs ``Dataset.append``
and ``online.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np

from .config import Config, canonical_name


def train_from_config(config_path: str) -> int:
    """task=train driven by a config file (the CLI's path)."""
    from .app import main
    return int(main([f"config={config_path}"]) or 0)


def _echo_params(model_str: str) -> Dict[str, str]:
    """``device_type`` from a model text's parameter echo, when it names
    one ("[device_type: cpu]"): a loaded model predicts where it was
    trained to."""
    if "\nparameters:\n" not in model_str:
        return {}
    block = model_str.split("\nparameters:\n", 1)[1].split(
        "end of parameters")[0]
    for line in block.splitlines():
        line = line.strip()
        if line.startswith("[") and line.endswith("]") and ": " in line:
            k, v = line[1:-1].split(": ", 1)
            if canonical_name(k) == "device_type":
                return {"device_type": v.strip()}
    return {}


def booster_from_file(path: str):
    """A Booster handle of a model file (reference:
    LGBM_BoosterCreateFromModelfile, c_api.h:387)."""
    from .basic import Booster
    with open(path) as fh:
        text = fh.read()
    return Booster(model_str=text, params=_echo_params(text))


def booster_from_string(model_str: str):
    from .basic import Booster
    return Booster(model_str=model_str, params=_echo_params(model_str))


def num_feature(booster) -> int:
    return int(booster.num_feature())


def num_trees(booster) -> int:
    return int(booster.num_trees())


def _mat(addr: int, nrow: int, ncol: int, copy: bool = False) -> np.ndarray:
    src = (ctypes.c_double * (nrow * ncol)).from_address(addr)
    x = np.frombuffer(src, dtype=np.float64).reshape(nrow, ncol)
    return x.copy() if copy else x


def predict_for_mat(booster, data_addr: int, nrow: int, ncol: int,
                    raw_score: int, pred_leaf: int, out_addr: int,
                    out_cap: int) -> int:
    """A dense f64 row-major matrix's predictions (reference:
    LGBM_BoosterPredictForMat, c_api.h:822); returns the count of doubles
    written, or -1 when ``out_cap`` is too small."""
    out = booster.predict(_mat(data_addr, nrow, ncol),
                          raw_score=bool(raw_score),
                          pred_leaf=bool(pred_leaf))
    out = np.ascontiguousarray(np.asarray(out, dtype=np.float64)).reshape(-1)
    if out.size > out_cap:
        return -1
    ctypes.memmove(out_addr, out.ctypes.data, out.nbytes)
    return int(out.size)


def save_model(booster, path: str) -> int:
    booster.save_model(path)
    return 0


# ---- a Dataset from memory and stepwise training (reference:
# LGBM_DatasetCreateFromMat, LGBM_DatasetSetField, LGBM_BoosterCreate,
# LGBM_BoosterUpdateOneIter, c_api.h:215, :322, :387, :482) ----

def _parse_params(params_str: str) -> dict:
    """The reference's parameter string: space-separated k=v tokens."""
    return Config.str2map((params_str or "").split())


def dataset_from_mat(data_addr: int, nrow: int, ncol: int, params_str: str,
                     reference):
    """A Dataset handle of a dense f64 row-major matrix, copied (the host
    may free its buffer after the call)."""
    from .basic import Dataset
    return Dataset(_mat(data_addr, nrow, ncol, copy=True),
                   params=_parse_params(params_str), reference=reference)


def dataset_set_field(ds, name: str, data_addr: int, n: int,
                      dtype: int) -> int:
    """label / weight / init_score as f64 (dtype 0), group sizes as i32
    (dtype 1), the reference's SetField types (c_api.h:322)."""
    if dtype == 1:
        src = (ctypes.c_int32 * n).from_address(data_addr)
        arr = np.frombuffer(src, dtype=np.int32).copy()
    else:
        src = (ctypes.c_double * n).from_address(data_addr)
        arr = np.frombuffer(src, dtype=np.float64).copy()
    if name == "label":
        ds.set_label(arr)
    elif name == "weight":
        ds.set_weight(arr)
    elif name == "init_score":
        ds.set_init_score(arr)
    elif name in ("group", "query"):
        ds.set_group(arr.astype(np.int64))
    else:
        raise ValueError(f"unknown field name {name!r}")
    return 0


def dataset_num_data(ds) -> int:
    return int(ds.num_data if ds._constructed
               else np.shape(ds.raw_data)[0])


def dataset_num_feature(ds) -> int:
    ds.construct()
    return int(ds.num_features)


def booster_create(ds, params_str: str):
    from .basic import Booster
    return Booster(params=_parse_params(params_str), train_set=ds)


def booster_add_valid(booster, valid_ds, name: str) -> int:
    booster.add_valid(valid_ds, name)
    return 0


def booster_update_one_iter(booster) -> int:
    return 1 if booster.update() else 0


def booster_get_eval(booster, data_idx: int, out_addr: int, cap: int) -> int:
    """One eval set's metric values (reference: LGBM_BoosterGetEval,
    c_api.h:556): data_idx 0 the training set, 1.. the valid sets in the
    order they were added. Returns the count written, or -1 on overflow or
    a bad index."""
    gb = booster._gbdt
    if data_idx == 0:
        rows = booster.eval_train()
    else:
        if gb is None or not 1 <= data_idx <= len(gb.valid_names):
            return -1
        i = data_idx - 1
        rows = gb._eval(gb.valid_names[i], gb.valid_scores[i],
                        gb.valid_sets[i])
    vals = [float(r[2]) for r in rows]
    if len(vals) > cap:
        return -1
    if vals:
        buf = (ctypes.c_double * len(vals)).from_address(out_addr)
        buf[:] = vals
    return len(vals)


def booster_finish_training(booster) -> int:
    """The end of a stepwise loop. The port checks each iteration's stop
    and non-finite flags as it goes, so nothing is left to flush."""
    return 0


# ---- online serving (server.py; reference analog:
# LGBM_BoosterPredictForMatSingleRowFast, c_api.h:919, a pre-configured
# fast path for interactive traffic; this one also coalesces concurrent
# callers into shared device batches and hot-swaps model versions) ----

def server_create(model_path: str, params_str: str):
    """Opaque PredictServer handle (a FleetServer with fleet_replicas > 1):
    publishes ``model_path`` as version 1, its engine built and warmed on
    the device before the call returns; the device is the parameters'
    ``device_type``, else the model file's parameter echo's. A missing
    file fails with its name."""
    import os
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"model file {model_path!r} not found")
    with open(model_path) as fh:
        # a model serves where it was trained unless the parameters say
        params = {**_echo_params(fh.read()), **_parse_params(params_str)}
    if int(Config(params).fleet_replicas) > 1:
        from .fleet.service import FleetServer
        return FleetServer(params, model=model_path)
    from .server import PredictServer
    return PredictServer(params, model=model_path)


def server_predict(server, data_addr: int, nrow: int, ncol: int,
                   raw_score: int, pred_leaf: int, out_addr: int,
                   out_cap: int) -> int:
    """Coalesced predict: blocks until the scheduler's flush serves this
    request (concurrent C threads share device dispatches). Returns doubles
    written, -1 if out_cap is too small, -2 if shed at overload."""
    from .server import ServeOverload
    src = (ctypes.c_double * (nrow * ncol)).from_address(data_addr)
    x = np.frombuffer(src, dtype=np.float64).reshape(nrow, ncol)
    try:
        out = server.predict(x, raw_score=bool(raw_score),
                             pred_leaf=bool(pred_leaf))
    except ServeOverload:
        return -2
    out = np.ascontiguousarray(np.asarray(out, dtype=np.float64)).reshape(-1)
    if out.size > out_cap:
        return -1
    ctypes.memmove(out_addr, out.ctypes.data, out.nbytes)
    return int(out.size)


def server_publish(server, model_path: str) -> int:
    """Atomic hot-swap to a new model version; returns the new version
    number. In-flight requests finish on the version that was current when
    their flush started; the old version's device tables are freed once it
    drains."""
    return int(server.publish(model_path))


def server_stats_json(server) -> str:
    """One-line JSON: scheduler counters (requests/flushes/shed/coalesce
    factor/queue depth), per-model registry state incl. ``age_s`` freshness,
    and — when configured — SLO attainment/burn-rate plus p50/p95/p99
    request-latency summaries."""
    import json
    return json.dumps(server.stats(), sort_keys=True)


def server_canary(server, model_path: str, fraction: float,
                  shadow: int) -> int:
    """Start a canary/shadow rollout of ``model_path`` against the live
    model: canary routes ``fraction`` of traffic to the candidate, shadow
    duplicates it with zero user exposure. Auto-promotes after the
    drift-free window, auto-rolls-back on PSI/KS divergence. Returns the
    candidate version, -1 on failure."""
    try:
        ro = server.ensure_rollout()
        return int(ro.start(model_path,
                            fraction=fraction if fraction > 0 else None,
                            shadow=bool(shadow)))
    except Exception:
        return -1


def server_promote(server) -> int:
    """Promote the active canary now (its warmed engine is re-homed as the
    live version, no rebuild). Returns the new live version, -1 if no
    canary is active."""
    try:
        return int(server.ensure_rollout().promote())
    except Exception:
        return -1


def server_rollback(server) -> int:
    """Roll the active canary back now: the candidate drains and is freed,
    the incumbent keeps serving. Returns the incumbent version, -1 if no
    canary is active."""
    try:
        return int(server.ensure_rollout().rollback())
    except Exception:
        return -1


def server_fleet_stats_json(server) -> str:
    """One-line JSON of the fleet/rollout plane: replica health + routing
    counters (FleetServer), admission-control states, rollout state machine
    + comparator PSI/KS."""
    import json
    return json.dumps(server.fleet_stats(), sort_keys=True)


def server_close(server) -> int:
    """Drain queued requests, stop the scheduler thread."""
    server.close()
    return 0


# ---- continuous training (online.py; reference analog: LGBM_BoosterRefit,
# c_api.h:652 — ours additionally grows the Dataset in place under frozen
# bin boundaries and hot-swaps each refit version into the server) ----

def dataset_append(ds, data_addr: int, nrow: int, ncol: int,
                   label_addr: int) -> int:
    """Append dense f64 rows (+ labels) to a CONSTRUCTED Dataset under its
    frozen bin boundaries and EFB plan (basic.Dataset.append). Returns the
    new total row count. The buffer is copied, like dataset_from_mat."""
    src = (ctypes.c_double * (nrow * ncol)).from_address(data_addr)
    x = np.frombuffer(src, dtype=np.float64).reshape(nrow, ncol).copy()
    label = None
    if label_addr:
        lsrc = (ctypes.c_double * nrow).from_address(label_addr)
        label = np.frombuffer(lsrc, dtype=np.float64).copy()
    ds.append(x, label=label)
    return int(ds.num_data)


def online_create(ds, booster, server, params_str: str):
    """Opaque OnlineTrainer handle bound to a Dataset + current model; when
    ``server`` is non-None each refit cycle hot-swaps into its registry and
    the serve protocol's ``!learn`` lines feed this trainer."""
    from .online import OnlineTrainer
    trainer = OnlineTrainer(_parse_params(params_str), ds, booster=booster,
                            server=server)
    if server is not None:
        server.attach_online(trainer)
    return trainer


def online_feed(trainer, data_addr: int, nrow: int, ncol: int,
                label_addr: int) -> int:
    """Feed one labeled batch; returns the newly published model version
    when this batch triggered a synchronous refit cycle, else 0 (always 0
    with ``online_async_refit=1`` — the cycle runs on the trainer's worker
    thread and this call never blocks on training)."""
    src = (ctypes.c_double * (nrow * ncol)).from_address(data_addr)
    x = np.frombuffer(src, dtype=np.float64).reshape(nrow, ncol).copy()
    lsrc = (ctypes.c_double * nrow).from_address(label_addr)
    label = np.frombuffer(lsrc, dtype=np.float64).copy()
    version = trainer.feed(x, label)
    return int(version or 0)


def online_capture(trainer, rid: str, data_addr: int, nrow: int,
                   ncol: int) -> int:
    """Capture served features under request id ``rid`` for a delayed-label
    join (online.feed_features): the rows are WAL-logged immediately and
    enter training only when ``online_label`` later supplies the outcome.
    Returns the pending-join count (a duplicate rid is counted and ignored
    — first capture wins), -1 on malformed input."""
    src = (ctypes.c_double * (nrow * ncol)).from_address(data_addr)
    x = np.frombuffer(src, dtype=np.float64).reshape(nrow, ncol).copy()
    try:
        return int(trainer.feed_features(rid, x))
    except ValueError:
        return -1


def online_label(trainer, rid: str, label: float, weight: float) -> int:
    """Join a late-arriving label against the features captured under
    ``rid`` and feed the joined rows (online.feed_label). Returns the newly
    published version when the join triggered a synchronous refit, 0 when
    it merely buffered, -1 when ``rid`` matched nothing (expired or never
    captured — counted, never silent)."""
    w = weight if weight > 0 else None
    joined_before = trainer.join_stats()["joined"]
    version = trainer.feed_label(rid, float(label), weight=w)
    if version is not None:
        return int(version)
    # feed_label returns None both for a buffered join and an unmatched
    # label; the joined counter moving is what distinguishes them
    return 0 if trainer.join_stats()["joined"] > joined_before else -1


def online_join_stats_json(trainer) -> str:
    """One-line JSON of the delayed-label join plane: pending/joined/
    expired/unmatched counters plus oldest-pending age (online.join_stats).
    For an OnlineTrainerGroup handle this reports the default model."""
    import json
    return json.dumps(trainer.join_stats(), sort_keys=True)


def online_flush(trainer) -> int:
    """Drain pending rows through refit cycles now (synchronous even under
    ``online_async_refit=1``); returns the published version, or 0 when
    nothing pended."""
    return int(trainer.flush() or 0)


def online_close(trainer) -> int:
    """Stop the trainer's async refit worker, deregister its freshness
    collector, and close the write-ahead feed log (idempotent)."""
    trainer.close()
    return 0
