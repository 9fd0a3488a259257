"""The mesh preflight: device liveness and shard-plan consistency before
step 0.

Port of ``probe_device_liveness`` and ``mesh_preflight`` of
``lightgbm_tpu/parallel/fence.py`` (:159-260). A bad mesh does not fail
loudly on its own: a dead device or a stale shard grid turns into a hang
or a wrong sum mid-training. The preflight turns that into a
``LightGBMError`` with a per-field diff before the first tree. The
cross-process half (``consistency_fence``, the ranks' config and mapper
digests) belongs to the process-spanning mesh (ROADMAP A21b); in one
process there is nothing to compare it with.
"""
from __future__ import annotations

from typing import List

import torch

from .. import obs
from ..log import fatal, info, warning
from . import mesh as M


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
    rps = int(getattr(plan, "rows_per_shard", 0))
    n_rows = int(getattr(plan, "n_rows", 0))
    if k > 0 and rps != -(-n_rows // k):
        problems.append(f"  plan.rows_per_shard: plan={rps} "
                        f"expected ceil({n_rows}/{k})={-(-n_rows // k)}")
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
    ok = not problems
    obs.emit("mesh_preflight", shards=int(k), ok=ok,
             devices=len(devices), mismatched_fields=len(problems))
    if ok:
        info(f"mesh preflight passed: {k} shard(s) over {len(devices)} "
             "live device(s), 1 process")
        return True
    msg = ("mesh preflight FAILED before step 0: a bad mesh fails later "
           "and worse. Problems:\n" + "\n".join(problems))
    if raise_on_mismatch:
        fatal(msg)
    warning(msg)
    return False
