"""The pre-training fences: the ranks' consistency and the mesh preflight.

Port of ``lightgbm_tpu/parallel/fence.py``. Every rank must hold the same
bin mappers, feature map, shard grid and training-relevant config before
the first cross-rank sum, or the sums silently add unlike histograms and
the model is garbage with no diagnostic. ``consistency_fence`` (:64-157)
verifies it: each rank hashes its state, the digests are allgathered
(fixed shape and dtype, so the gather works even when the state
disagrees) and a mismatch raises ``LightGBMError`` on every rank, naming
the field, before step 0. ``mesh_preflight`` (:159-260) adds device
liveness and the plan's own consistency: a dead device or a stale grid
would otherwise hang or sum wrongly mid-training. Digests are sha256
truncated to 64 bits, shipped as ``[n_items, 2]`` uint32.
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np
import torch

from .. import obs
from ..log import fatal, info, warning
from . import mesh as M

# config fields that alter the training trajectory (reference: :24-46);
# a rank that disagrees on any of them makes split decisions the sums
# then blend silently; the mesh fields and the 2-D / voting ones
# desynchronize the schedule of the sums
FENCE_CONFIG_FIELDS = (
    "objective", "boosting", "num_class", "num_iterations", "learning_rate",
    "num_leaves", "max_depth", "max_bin", "min_data_in_leaf",
    "min_sum_hessian_in_leaf", "lambda_l1", "lambda_l2", "min_gain_to_split",
    "max_delta_step", "bagging_fraction", "pos_bagging_fraction",
    "neg_bagging_fraction", "bagging_freq", "bagging_seed",
    "feature_fraction", "feature_fraction_bynode", "feature_fraction_seed",
    "extra_trees", "extra_seed", "grow_policy", "tree_learner",
    "use_quantized_grad", "seed", "data_random_seed", "boost_from_average",
    "monotone_constraints", "feature_contri", "cegb_penalty_split",
    "cegb_penalty_feature_coupled", "cegb_penalty_feature_lazy",
    "drop_rate", "skip_drop", "max_drop", "uniform_drop",
    "xgboost_dart_mode", "drop_seed", "top_rate", "other_rate",
    "num_shards", "mesh_axis", "on_device_fault",
    "feature_shards", "voting_parallel", "top_k",
)


def _digest(data: bytes) -> np.ndarray:
    """The 64-bit sha256 prefix as uint32[2]."""
    return np.frombuffer(hashlib.sha256(data).digest()[:8],
                         dtype=np.uint32).copy()


def _mapper_bytes(m) -> bytes:
    head = repr((int(m.bin_type), int(m.missing_type), int(m.num_bins),
                 int(m.default_bin), int(m.most_freq_bin),
                 bool(m.is_trivial))).encode()
    ub = np.asarray(m.upper_bounds, dtype=np.float64).tobytes()
    cv = np.asarray(m.cat_values, dtype=np.int64).tobytes()
    return head + ub + cv


def fence_items(config, train_set=None) -> List[Tuple[str, bytes]]:
    """The named byte strings each rank hashes. Their count and order are
    the same on every rank (the gather needs equal shapes), so all
    mappers fold into one item. The shard plan is the grid's (the global
    rows and shards), the same on every rank."""
    items: List[Tuple[str, bytes]] = [
        (f"config.{f}", repr(getattr(config, f, None)).encode())
        for f in FENCE_CONFIG_FIELDS]
    ts = train_set
    h = hashlib.sha256()
    for m in (getattr(ts, "mappers", None) if ts is not None else None) \
            or []:
        h.update(_mapper_bytes(m))
    items.append(("data.bin_mappers", h.digest()))
    fm = getattr(ts, "feature_map", None) if ts is not None else None
    items.append(("data.feature_map",
                  b"none" if fm is None
                  else np.asarray(fm, dtype=np.int64).tobytes()))
    items.append(("data.num_features",
                  repr(getattr(ts, "num_features", None)
                       if ts is not None else None).encode()))
    plan = getattr(ts, "shard_plan", None) if ts is not None else None
    items.append(("data.shard_plan",
                  b"none" if plan is None
                  else repr((plan.axis_name, int(plan.shards_global),
                             int(plan.n_global), int(plan.rows_per_shard),
                             int(plan.feature_shards or 1),
                             plan.feature_axis or "")).encode()))
    dev = getattr(ts, "device", None) if ts is not None else None
    items.append(("host.topology",
                  _topology_bytes(dev.type if dev is not None else "cpu")))
    return items


def _topology_bytes(kind: str = "cpu") -> bytes:
    """The process count and this process's device census (types and
    count): a rank that lost a device or sees another grid builds an
    incompatible mesh, caught here instead of at a hanging sum."""
    from .multihost import process_count
    census = sorted(d.type for d in M.local_devices(kind))
    return repr((int(process_count()), census)).encode()


def consistency_fence(config, train_set=None, raise_on_mismatch: bool = True
                      ) -> bool:
    """Allgather the ranks' digests and fail fast on a divergence: True
    when every rank agrees (trivially in one process); on a mismatch a
    ``LightGBMError`` with each mismatched field's per-rank digests, or
    with ``raise_on_mismatch=False`` a warning and False."""
    from .multihost import process_count, wire_allgather
    if process_count() <= 1:
        return True
    items = fence_items(config, train_set)
    local = np.stack([_digest(v) for _n, v in items])        # [n, 2] u32
    gathered = np.stack(wire_allgather(local, uniform=True))  # [P, n, 2]
    mismatched = [i for i in range(len(items))
                  if not (gathered[:, i] == gathered[0, i]).all()]
    nproc = gathered.shape[0]
    obs.emit("consistency_fence", processes=int(nproc), ok=not mismatched,
             mismatched_fields=len(mismatched))
    if not mismatched:
        info(f"consistency fence passed across {nproc} processes "
             f"({len(items)} fields verified)")
        return True
    lines = []
    for i in mismatched:
        digests = " ".join(
            "rank%d=%08x%08x" % (r, gathered[r, i, 0], gathered[r, i, 1])
            for r in range(nproc))
        lines.append(f"  {items[i][0]}: {digests}")
    msg = ("pre-training consistency fence FAILED: ranks disagree on "
           f"{len(mismatched)} field(s); training would silently corrupt "
           "the cross-rank histogram sums. Mismatched fields:\n"
           + "\n".join(lines))
    if raise_on_mismatch:
        fatal(msg)
    warning(msg)
    return False


def probe_device_liveness(devices) -> List[str]:
    """One tiny copy to each device and back; a device that fails it is
    reported in milliseconds instead of failing a sum later. Returns one
    line a dead device."""
    dead: List[str] = []
    for d in devices:
        try:
            x = torch.ones(1, dtype=torch.float32).to(torch.device(d))
            if float(x.cpu()[0]) != 1.0:
                dead.append(f"  {d}: probe readback mismatch")
        except Exception as e:   # a dead device is data here, not a failure
            dead.append(f"  {d}: {type(e).__name__}: {e}")
    return dead


def mesh_preflight(config, train_set, plan,
                   raise_on_mismatch: bool = True) -> bool:
    """Validate the mesh before step 0: device liveness and the plan's
    consistency with the config and the Dataset. Trivially True without a
    plan (the serial path has no mesh)."""
    if plan is None:
        return True
    problems: List[str] = []
    axis = getattr(plan, "axis_name", None)
    if axis != config.mesh_axis:
        problems.append(f"  plan.axis_name: plan={axis!r} "
                        f"config.mesh_axis={config.mesh_axis!r}")
    devices = list(getattr(plan, "devices", []))
    k = int(getattr(plan, "num_shards", 0))
    if k != len(devices):
        problems.append(f"  plan.num_shards: plan={k} "
                        f"mesh devices={len(devices)}")
    kinds = {d.type for d in devices if isinstance(d, torch.device)}
    nd = M.device_count(kinds.pop()) if len(kinds) == 1 else len(devices)
    if k > nd:
        problems.append(f"  plan.num_shards: plan={k} exceeds the "
                        f"{nd} local devices")
    # the grid's rows and shards (this process's block of them when the
    # grid spans processes)
    rps = int(getattr(plan, "rows_per_shard", 0))
    n_rows = int(getattr(plan, "global_rows", 0)
                 or getattr(plan, "n_rows", 0))
    kg = int(getattr(plan, "global_shards", 0) or k)
    if kg > 0 and rps != -(-n_rows // kg):
        problems.append(f"  plan.rows_per_shard: plan={rps} "
                        f"expected ceil({n_rows}/{kg})={-(-n_rows // kg)}")
    ts_n = getattr(train_set, "num_data", None) if train_set is not None \
        else None
    if ts_n is not None and int(ts_n) != n_rows:
        problems.append(f"  plan.n_rows: plan={n_rows} "
                        f"train_set.num_data={int(ts_n)}")
    fs = int(getattr(plan, "feature_shards", 1) or 1)
    if fs > 1 and not getattr(plan, "feature_axis", ""):
        problems.append(f"  plan.feature_shards={fs} but feature_axis unset")
    mesh = getattr(plan, "mesh", None)
    all_devs = list(mesh.devices.flat) if mesh is not None else devices
    # each distinct device once: virtual shards share theirs
    seen = []
    for d in all_devs:
        if d not in seen:
            seen.append(d)
    problems.extend(probe_device_liveness(seen))
    nproc = int(getattr(plan, "process_count", 1))
    fence_ok = True
    if not problems and nproc > 1:
        # across the ranks: the same config, mappers and grid
        fence_ok = consistency_fence(config, train_set,
                                     raise_on_mismatch=raise_on_mismatch)
    ok = fence_ok and not problems
    obs.emit("mesh_preflight", shards=int(k), ok=ok,
             devices=len(devices), mismatched_fields=len(problems))
    if ok:
        info(f"mesh preflight passed: {k} shard(s) over {len(devices)} "
             f"live device(s), {nproc} process(es)")
        return True
    if problems:
        msg = ("mesh preflight FAILED before step 0: a bad mesh fails "
               "later and worse. Problems:\n" + "\n".join(problems))
        if raise_on_mismatch:
            fatal(msg)
        warning(msg)
    return False
