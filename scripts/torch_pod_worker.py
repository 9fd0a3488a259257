"""One rank of a multi-process training drill of lightgbm_tpu_torch.

    RANK=r python scripts/torch_pod_worker.py SPEC.json [--port P]
        [--rank-env NAME]

``SPEC.json`` (written by the launcher: tests/test_torch_pod_drill.py on
the CPU, chip_smoke.py's path (u) on the card)::

    {"world": 2, "port": 29500, "devices": 2, "device_type": "cpu",
     "out": "DIR", "jobs": [JOB, ...]}

Each rank joins a ``torch.distributed`` group of ``world`` processes over
``tcp://127.0.0.1:port`` (``parallel.mesh.init_distributed``: gloo on the
CPU or when ranks share a card, NCCL when each owns one), runs inside
``virtual_devices(devices, its device)`` and runs the jobs in order. A
job::

    {"name": "dp", "data": "DIR holding X.npy, y.npy", "params": {...},
     "rounds": 4, "fobj": "grid9" | "int" | null, "valid": "DIR" | null,
     "rank_params": {"1": {...}}, "expect_error": "text" | null,
     "faults": "spec" | null, "cli": false, "mappers_distributed": false,
     "probe_shape": [S, 3, F, B] | null}

reads only this rank's rows of ``X.npy`` (``multihost.host_row_range`` of
the grid, ``load_file_shard``), trains, and prints one line ``POD_RESULT
{json}``: the mapper and tree digests (the model text before its
parameter echo), seconds a iteration, the kernel launches, each tree's
level passes and leaves (with num_leaves and max_depth), the
cross-rank sums (``ops.grow.ALLREDUCE``) and host copies
(``multihost.XFER``), the construct's phases, the backend and the fault
points' hits. ``expect_error``: the training must raise a
``LightGBMError`` naming it before any tree (no kernel launched). A
``tree_update@k`` fault in ``faults`` is a kill: the rank exits with code
17 at iteration k, as a lost process would. ``cli``: the job trains
through ``python -m lightgbm_tpu_torch``'s ``app.main`` on ``DATA/train.csv``
(the round-robin load). ``probe_shape``: the job times one cross-rank sum
of a tensor of that shape instead. Every collective is recorded by
``parallel.collectivewatch`` in ``OUT/collwatch_rank<r>.jsonl``.
"""
import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch import metrics  # noqa: E402
from lightgbm_tpu_torch.config import params_to_config  # noqa: E402
from lightgbm_tpu_torch.log import LightGBMError  # noqa: E402
from lightgbm_tpu_torch.ops import grow as G  # noqa: E402
from lightgbm_tpu_torch.ops import hist_kernels as hk  # noqa: E402
from lightgbm_tpu_torch.parallel import collectivewatch  # noqa: E402
from lightgbm_tpu_torch.parallel import mesh as M  # noqa: E402
from lightgbm_tpu_torch.parallel import multihost  # noqa: E402
from lightgbm_tpu_torch.utils import faults  # noqa: E402
from lightgbm_tpu_torch.utils.faults import FaultInjected  # noqa: E402

POINTS = ("dist_init", "sketch_allgather", "rows_allgather",
          "mapper_allgather", "hist_allreduce")


def grid9_fobj(preds, train_data):
    """Logistic loss with gradients rounded to multiples of 2^-9 and
    hessian 0.25: every f32 histogram sum is exact, in any order."""
    y = np.asarray(train_data.get_label(), np.float64)
    p = 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float64)))
    g = np.round((p - y) * 512.0) / 512.0
    return g.astype(np.float32), np.full_like(g, 0.25).astype(np.float32)


def int_fobj(preds, train_data):
    """Integer gradients in {-1, 0, 1}, hessian 0.25 (exact at any row
    count)."""
    g = np.clip(np.round(np.asarray(preds, np.float64) * 2.0)
                - (2.0 * train_data.get_label() - 1.0), -1.0, 1.0)
    return g.astype(np.float32), np.full(g.shape, 0.25, np.float32)


FOBJ = {"grid9": grid9_fobj, "int": int_fobj, None: None}


def mapper_digest(mappers) -> str:
    h = hashlib.sha256()
    for m in mappers:
        h.update(np.asarray([m.bin_type, m.missing_type, m.num_bins,
                             m.default_bin, m.most_freq_bin,
                             int(m.is_trivial)], np.int64).tobytes())
        h.update(np.asarray(m.upper_bounds, np.float64).tobytes())
        h.update(np.asarray(m.cat_values, np.int64).tobytes())
        h.update(np.float64(m.sparse_rate).tobytes())
        h.update(np.float64(m.min_value).tobytes())
        h.update(np.float64(m.max_value).tobytes())
    return h.hexdigest()


def tree_digest(model_text: str) -> str:
    """The model text before its parameter echo (which names the
    topology), hashed."""
    return hashlib.sha256(
        model_text.split("\nparameters:\n", 1)[0].encode()).hexdigest()


def sync(device_type):
    if device_type == "cuda":
        torch.cuda.synchronize()


def run_cli(job, params, out, rank):
    """The CLI's round-robin load and training (app.main)."""
    from lightgbm_tpu_torch import app
    model = os.path.join(out, f"{job['name']}_rank{rank}.txt")
    args = [f"data={os.path.join(job['data'], 'train.csv')}",
            f"output_model={model}", "task=train", "header=false",
            f"num_iterations={job['rounds']}"]
    args += [f"{k}={v}" for k, v in params.items()]
    rc = app.main(args)
    if rc:
        raise RuntimeError(f"app.main returned {rc}")
    with open(model) as fh:
        text = fh.read()
    return {"tree": tree_digest(text)}


def probe(job, card, device_type):
    """One cross-rank sum of a level's histograms (``probe_shape``, f32)
    timed ``reps`` times after a warm-up, in ms."""
    t = torch.randn(job["probe_shape"], device=card)
    ms = []
    for _ in range(int(job.get("reps", 5)) + 1):
        sync(device_type)
        t0 = time.perf_counter()
        multihost.allreduce_sum(t)
        sync(device_type)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"probe_ms": ms[1:], "probe_bytes": t.numel() * 4}


def run_job(job, spec, rank, card):
    dt = spec["device_type"]
    if job.get("probe_shape"):
        return dict(probe(job, card, dt), rank=rank, name=job["name"])
    params = dict(job["params"], device_type=dt,
                  num_machines=spec["world"],
                  machines=",".join(
                      [f"127.0.0.1:{spec['port']}"]
                      + ["127.0.0.1:0"] * (spec["world"] - 1)))
    params.update(job.get("rank_params", {}).get(str(rank), {}))
    res = {"rank": rank, "name": job["name"]}
    if job.get("cli"):
        res.update(run_cli(job, params, spec["out"], rank))
        if job.get("mappers_distributed"):
            from lightgbm_tpu_torch.parallel.dist_data import (
                find_bin_mappers_distributed, round_robin_rows)
            X = np.load(os.path.join(job["data"], "X.npy"))
            keep = round_robin_rows(X.shape[0], rank, spec["world"])
            res["dist_mappers"] = mapper_digest(
                find_bin_mappers_distributed(X[keep], params["max_bin"]))
        return res
    xpath = os.path.join(job["data"], "X.npy")
    n_global = int(np.load(xpath, mmap_mode="r").shape[0])
    conf = params_to_config(params)
    ns = int(conf.num_shards) or spec["world"] * spec["devices"]
    plan = multihost.plan_pod_sharding(
        n_global, ns, rank, spec["world"], kind=card.type,
        feature_shards=max(1, int(conf.feature_shards or 0)))
    r0, r1 = multihost.host_row_range(plan)
    t0 = time.perf_counter()
    X = multihost.load_file_shard(xpath, r0, r1)
    y = multihost.load_file_shard(os.path.join(job["data"], "y.npy"), r0, r1)
    read_s = time.perf_counter() - t0
    sync(dt)
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, params=params).construct()
    sync(dt)
    res["construct_s"] = time.perf_counter() - t0
    res["phases"] = dict(ds.construct_phases, read_rows_s=read_s)
    res["mappers"] = mapper_digest(ds.mappers)
    res["rows"] = [r0, r1]
    hk.reset_launches()
    G.reset_allreduce()
    multihost.reset_xfer()
    sync(dt)
    t0 = time.perf_counter()
    try:
        bst = lt.train(params, ds, job["rounds"], fobj=FOBJ[job.get("fobj")],
                       resume_from_snapshot=job.get("resume"))
    except FaultInjected as e:
        if e.point == "tree_update":
            print(f"POD_KILLED rank={rank} at {e.hit}", flush=True)
            os._exit(17)
        raise
    except LightGBMError as e:
        if not job.get("expect_error"):
            raise
        res["error"] = str(e)
        res["launches"] = dict(hk.LAUNCHES)
        return res
    sync(dt)
    train_s = time.perf_counter() - t0
    if job.get("expect_error"):
        raise RuntimeError(f"{job['name']}: training did not raise")
    res.update(tree=tree_digest(bst.model_to_string()),
               s_per_iter=train_s / job["rounds"],
               launches=dict(hk.LAUNCHES), allreduce=dict(G.ALLREDUCE),
               xfer=dict(multihost.XFER), passes=bst._gbdt.hist_passes,
               leaves=[t.num_leaves for t in bst._gbdt.models_dev],
               num_leaves=bst._gbdt.gp.num_leaves,
               max_depth=bst._gbdt.gp.max_depth,
               shards=bst._gbdt._shard_plan.num_shards)
    if job.get("valid"):
        Xv = np.load(os.path.join(job["valid"], "X.npy"))
        yv = np.load(os.path.join(job["valid"], "y.npy"))
        res["valid_auc"] = float(metrics.auc(
            torch.as_tensor(yv, dtype=torch.float64),
            torch.as_tensor(bst.predict(Xv).astype(np.float64))))
    # the ranks' results agree before anyone reports them
    mine = np.frombuffer(hashlib.sha256(
        (res["mappers"] + res["tree"]).encode()).digest()[:16], np.uint32)
    allv = np.stack(multihost.wire_allgather(mine, uniform=True))
    res["ranks_agree"] = bool(np.all(allv == allv[0]))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("spec")
    ap.add_argument("--port", type=int, default=0,
                    help="the group's port (default: the spec's)")
    ap.add_argument("--rank-env", default="RANK",
                    help="the environment variable holding the rank")
    args = ap.parse_args()
    with open(args.spec) as fh:
        spec = json.load(fh)
    if args.port:
        spec["port"] = args.port
    rank = int(os.environ[args.rank_env])
    os.environ["RANK"] = str(rank)
    conf = params_to_config({"device_type": spec["device_type"],
                             "num_machines": spec["world"]})
    backend, card = M.choose_backend(conf)
    card = card if card is not None else torch.device("cpu")
    if card.type == "cuda":
        torch.cuda.set_device(card)
        from lightgbm_tpu_torch.ops import cuda_lib
        cuda_lib.load()
    collectivewatch.install(os.path.join(spec["out"],
                                         f"collwatch_rank{rank}.jsonl"))
    with M.virtual_devices(spec["devices"], card):
        for job in spec["jobs"]:
            if job.get("faults"):
                faults.configure(job["faults"])
            try:
                res = run_job(job, spec, rank, card)
            finally:
                res_hits = {p: faults.hits(p) for p in POINTS}
                faults.reset()
            res.update(backend=M.DIST["backend"] or backend,
                       card=str(card), hits=res_hits)
            print("POD_RESULT " + json.dumps(res), flush=True)
    collectivewatch.WATCH.write_ledger()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
