"""Crash-safe snapshots: manifest, retention, validation, lossless resume.

Port of ``lightgbm_tpu/snapshot.py``. Every snapshot is a pair of files,
each written atomically (``utils/atomic_io.py``):

- ``snapshot_iter_N.txt``: the model text;
- ``snapshot_iter_N.state.npz``: the trainer's exact state (device trees,
  the f32 train score, every RNG stream, early stopping's bookkeeping),
  from ``GBDT.get_resume_state`` under the reference's key names;

and ``snapshot_manifest.json``, written last: it is the commit point, and
it prunes all but the newest ``snapshot_keep`` pairs. The model text alone
cannot resume a run exactly (the first tree's bias is folded in f32, and
the text holds no bins), so the sidecar is what makes a run killed at
iteration k and resumed end with the uninterrupted run's model text.
``load_latest_valid`` walks the snapshots newest first and parses each
before it returns one, so a truncated snapshot is skipped with a warning,
never loaded. One process writes (``is_writer_rank``, always true until
the multi-GPU work, ROADMAP.md A21).
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional

import numpy as np

from . import log, obs
from .utils import atomic_io
from .utils.retry import call_with_backoff

MANIFEST_NAME = "snapshot_manifest.json"
_SNAP_RE = re.compile(r"^snapshot_iter_(\d+)\.txt$")


def model_name(iteration: int) -> str:
    return f"snapshot_iter_{iteration}.txt"


def state_name(iteration: int) -> str:
    return f"snapshot_iter_{iteration}.state.npz"


def snapshot_dir_for(conf) -> str:
    """``snapshot_dir``, else the directory of ``output_model``."""
    d = getattr(conf, "snapshot_dir", "") or ""
    if d:
        return d
    out = getattr(conf, "output_model", "") or ""
    return os.path.dirname(out) or "."


def is_writer_rank() -> bool:
    """Whether this process writes snapshots: one process trains."""
    return True


class SnapshotPayload:
    """A validated snapshot, ready for ``GBDT.set_resume_state``."""

    def __init__(self, model_path: str, iteration: int,
                 arrays: Dict[str, np.ndarray], meta: Dict,
                 es_state: Optional[Dict]):
        self.model_path = model_path
        self.iteration = iteration
        self.arrays = arrays
        self.meta = meta
        self.es_state = es_state


def _read_manifest(directory: str) -> List[int]:
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(path) as f:
            data = json.load(f)
        return sorted({int(e["iteration"]) for e in data.get("snapshots", [])})
    except FileNotFoundError:
        return []
    except Exception as e:
        log.warning(f"snapshot manifest {path} unreadable "
                    f"({type(e).__name__}: {e}); falling back to a "
                    "directory scan")
        return []


def _scan_dir(directory: str) -> List[int]:
    out = []
    try:
        for fn in os.listdir(directory):
            m = _SNAP_RE.match(fn)
            if m:
                out.append(int(m.group(1)))
    except OSError:
        pass
    return sorted(set(out))


def _update_manifest(directory: str, iteration: int, keep: int) -> None:
    """Record the new snapshot and prune past the retention; the manifest
    is written atomically and last, so a crash before it leaves the old
    manifest naming only whole snapshots."""
    iters = _read_manifest(directory)
    for it in _scan_dir(directory):
        if it not in iters:
            iters.append(it)
    iters = sorted(set(iters + [iteration]))
    pruned, kept = iters[:-keep] if keep > 0 else [], iters[-keep:]
    manifest = {"version": 1,
                "snapshots": [{"iteration": it, "model": model_name(it),
                               "state": state_name(it)} for it in kept]}
    atomic_io.atomic_write_text(os.path.join(directory, MANIFEST_NAME),
                                json.dumps(manifest, indent=1))
    for it in pruned:
        for fn in (model_name(it), state_name(it)):
            try:
                os.unlink(os.path.join(directory, fn))
            except OSError:
                pass


def write_snapshot(booster, directory: str, iteration: int, keep: int = 3,
                   es_state: Optional[Dict] = None, retries: int = 2) -> str:
    """Write one snapshot pair and the manifest; returns the model path.
    A failed write (an injected ``snapshot_write`` fault too) retries with
    backoff, and the atomic protocol leaves no partial file behind."""
    os.makedirs(directory, exist_ok=True)
    model_path = os.path.join(directory, model_name(iteration))
    state_path = os.path.join(directory, state_name(iteration))
    text = booster.model_to_string(num_iteration=-1)
    arrays = None
    if booster._gbdt is not None:
        arrays, meta = booster._gbdt.get_resume_state()
        meta["es_state"] = es_state
        arrays["meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8).copy()

    def _write():
        atomic_io.atomic_write_text(model_path, text,
                                    fault_name="snapshot_write")
        if arrays is not None:
            atomic_io.atomic_write_with(
                state_path, lambda f: np.savez_compressed(f, **arrays),
                fault_name="snapshot_write")

    t0 = time.perf_counter()
    call_with_backoff(_write, attempts=max(retries, 0) + 1, base_delay=0.05,
                      name=f"snapshot write (iteration {iteration})")
    _update_manifest(directory, iteration, keep)
    obs.emit("snapshot_write", iteration=int(iteration), path=model_path,
             duration_s=time.perf_counter() - t0, kept=int(keep),
             num_shards=_num_shards(booster))
    if obs.enabled():
        obs.METRICS.counter("snapshot_writes", "snapshots written").inc()
    return model_path


def _num_shards(booster) -> int:
    """The shard count the snapshot was taken at (informational: the state
    is stored unsharded, so a resume re-shards onto any count)."""
    plan = getattr(getattr(booster, "_gbdt", None), "_shard_plan", None)
    return plan.num_shards if plan is not None else 1


def _validate(directory: str, iteration: int) -> SnapshotPayload:
    """Load and validate one snapshot; raises on any damage."""
    from .io.model_text import parse_model_text
    model_path = os.path.join(directory, model_name(iteration))
    state_path = os.path.join(directory, state_name(iteration))
    with open(model_path) as f:
        text = f.read()
    if "end of trees" not in text:
        raise ValueError("model text truncated (missing 'end of trees')")
    _, trees = parse_model_text(text)
    arrays: Dict[str, np.ndarray] = {}
    with np.load(state_path) as npz:
        for k in npz.files:
            arrays[k] = np.asarray(npz[k])
    meta = json.loads(bytes(arrays.pop("meta_json").tobytes()).decode())
    n_trees = int(meta.get("num_trees", -1))
    if len(trees) != n_trees:
        raise ValueError(f"model text holds {len(trees)} trees but the state "
                         f"sidecar recorded {n_trees}")
    for f in [k for k in arrays if k.startswith("trees_")]:
        if arrays[f].shape[0] != n_trees:
            raise ValueError(f"state array {f} has {arrays[f].shape[0]} "
                             f"trees, expected {n_trees}")
    return SnapshotPayload(model_path, iteration, arrays, meta,
                           meta.get("es_state"))


def load_latest_valid(directory: str) -> Optional[SnapshotPayload]:
    """The newest snapshot that validates; damaged ones are skipped with a
    warning (never loaded) for older ones."""
    iters = _read_manifest(directory) or _scan_dir(directory)
    for it in sorted(iters, reverse=True):
        try:
            return _validate(directory, it)
        except FileNotFoundError as e:
            log.warning(f"snapshot iteration {it} incomplete "
                        f"({type(e).__name__}: {e}); trying an older one")
        except Exception as e:
            log.warning(f"snapshot iteration {it} failed validation "
                        f"({type(e).__name__}: {e}); trying an older one")
    return None


def booster_from_latest(directory: str, params: Optional[Dict] = None):
    """The newest valid snapshot's model as a Booster with its iteration,
    ``(booster, iteration)``, or ``(None, 0)``: training continued on a
    grown Dataset goes through ``train(init_model=...)`` with it, since
    ``set_resume_state`` refuses another row count."""
    payload = load_latest_valid(directory)
    if payload is None:
        return None, 0
    from .basic import Booster
    return (Booster(model_file=payload.model_path, params=params),
            int(payload.iteration))
