"""The port's runtime lock-order drill: real concurrency under lockwatch.

    python3 scripts/torch_lockwatch_drill.py ROWS.npy LABELS.npy
        [--device cuda] [--rows N] [--append-rows 500000] [--work DIR]

Loads ``lightgbm_tpu_torch/analysis/lockwatch.py`` by its file path and
installs it BEFORE the port is imported, so every lock the port creates is
watched (its sites keyed by repository path). Then, in this one process:

1. trains path (a)'s parameters (binary, num_leaves 255, max_bin 63,
   learning_rate 0.1, min_data_in_leaf 20) for 5 iterations on the first
   N - append_rows rows of ROWS.npy (the fused front: B1-B4), its kernel
   launches counted;
2. serves the model behind a ``PredictServer`` to CLIENTS (8)
   closed-loop single-row clients, for SERVE_S (2) seconds and then
   while an attached ``OnlineTrainer`` (its write-ahead feed log under
   ``--work``, a temporary directory by default, removed at the end) takes the next ``--append-rows`` rows as one
   batch and runs one boost cycle of 2 rounds on them;
3. starts a 2-replica ``FleetServer`` on the new model and promotes a
   clean canary (the same model) under the same clients.

Every answer must be its version's ``Booster.predict`` bit for bit. Then
``WATCH.assert_clean()``: no two lock sites were taken in both orders.
The last line is ``LOCKWATCH_RESULT {json}``: the lock sites and edges
seen, the requests answered, each phase's seconds and the launches.
Exits non-zero on an inversion or a wrong answer. chip_smoke.py's path
(v3) runs it on the card; ``--device cpu --rows 40000 --append-rows
4000`` rehearses it on the CPU.
"""
import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CLIENTS = 8
SERVE_S = 2.0


def install_lockwatch():
    """The port's watchdog, loaded by path before any port module."""
    spec = importlib.util.spec_from_file_location(
        "lightgbm_tpu_torch.analysis.lockwatch",
        os.path.join(ROOT, "lightgbm_tpu_torch", "analysis", "lockwatch.py"))
    lw = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = lw
    spec.loader.exec_module(lw)
    if not lw.install():
        raise SystemExit("lockwatch is disabled (LGBMTPU_LOCKWATCH=0)")
    return lw


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rows")
    ap.add_argument("labels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows-used", "--rows", dest="n", type=int, default=0,
                    help="rows of the file to use (default: all)")
    ap.add_argument("--append-rows", type=int, default=500_000)
    ap.add_argument("--work", default=None,
                    help="directory for the feed log (default: a new "
                         "temporary one)")
    args = ap.parse_args()

    lw = install_lockwatch()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.fleet.service import FleetServer
    from lightgbm_tpu_torch.online import OnlineTrainer, last_cycle_stats
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.server import PredictServer

    cuda = args.device == "cuda"
    if cuda:
        from lightgbm_tpu_torch.ops import cuda_lib
        torch.cuda.set_device(0)
        cuda_lib.load()
    X = np.load(args.rows, mmap_mode="r")
    y = np.load(args.labels)
    n = args.n or len(X)
    n0, na = n - args.append_rows, args.append_rows
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "device_type": args.device}
    sec = {}
    t_all = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # 1. the model
    t = time.perf_counter()
    ds = lt.Dataset(np.ascontiguousarray(X[:n0]), label=y[:n0],
                    params=params).construct()
    sync()
    sec["construct_s"] = time.perf_counter() - t
    hk.reset_launches()
    t = time.perf_counter()
    bst = lt.train(params, ds, 5)
    sync()
    sec["train_5_s"] = time.perf_counter() - t
    launches = dict(hk.LAUNCHES)

    # 2. serving, then an online cycle under the same clients
    work = tempfile.mkdtemp(prefix="lockwatch_drill_", dir=args.work)
    online = {**params, "online_refit_rows": na, "online_boost_rounds": 2,
              "online_max_rows": n0, "online_wal": True,
              "online_wal_dir": os.path.join(work, "wal")}
    srv = PredictServer({"verbosity": -1, "serve_max_batch_rows": 1024,
                         "device_type": args.device}, model=bst)
    tr = OnlineTrainer(online, ds, booster=bst, server=srv)
    srv.attach_online(tr)
    Xq = np.ascontiguousarray(X[n0 - 4096:n0], dtype=np.float64)
    want = {1: bst.predict(Xq)}
    answers, errs, stop = [], [], threading.Event()
    target = {"predict": srv.predict_versioned}

    def client(c):
        i = c
        try:
            while not stop.is_set():
                q = i % len(Xq)
                out, v = target["predict"](Xq[q])
                answers.append((q, v, float(out[0])))
                i += CLIENTS
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)

    ths = [threading.Thread(target=client, args=(c,), name=f"client{c}")
           for c in range(CLIENTS)]
    [th.start() for th in ths]
    try:
        time.sleep(SERVE_S)
        t = time.perf_counter()
        v = tr.feed(np.ascontiguousarray(X[n0:n]), y[n0:n], batch_id="a0")
        sec["cycle_s"] = time.perf_counter() - t
        if v != 2:
            raise SystemExit(f"the online cycle published {v}, not 2")
        want[2] = tr.booster.predict(Xq)
        time.sleep(0.5)
        served = len(answers)

        # 3. a fleet of 2 replicas and a clean canary
        t = time.perf_counter()
        fs = FleetServer({"verbosity": -1, "fleet_replicas": 2,
                          "serve_max_batch_rows": 1024,
                          "device_type": args.device,
                          "canary_fraction": 0.5, "canary_min_samples": 200,
                          "canary_cmp_window": 512, "canary_psi_max": 0.25,
                          "canary_window_s": 600.0}, model=tr.booster)
        try:
            ro = fs.ensure_rollout()
            clock = [1000.0]
            ro.clock = lambda: clock[0]

            def fleet_predict(row):
                # the fleet's versions 1 and 2 both hold the cycle's model
                out, fv = fs.predict_versioned(row)
                if fv not in (1, 2):
                    raise AssertionError(f"fleet version {fv}")
                return out, 2
            target["predict"] = fleet_predict
            ro.start(lt.Booster(model_str=tr.booster.model_to_string()))
            t_end = time.monotonic() + 60
            while min(*ro.comparator.counts()) < ro.min_samples:
                if time.monotonic() > t_end:
                    raise SystemExit("the canary's comparator never filled")
                time.sleep(0.05)
            state1 = ro.tick()
            clock[0] += ro.window_s + 1.0
            state2 = ro.tick()
            if (state1, state2) != ("canary", "idle"):
                raise SystemExit(f"the canary did not promote: {state1}, "
                                 f"{state2}, {ro.history[-1:]}")
            time.sleep(0.5)
        finally:
            stop.set()
            [th.join() for th in ths]
            fs.close()
        sec["fleet_s"] = time.perf_counter() - t
    finally:
        stop.set()
        [th.join() for th in ths]
        srv.close()
        tr.close()
        shutil.rmtree(work, ignore_errors=True)
    bad = sum(1 for q, v, o in answers if o != want.get(v, want[2])[q])
    if errs or bad or not served or len(answers) <= served:
        raise SystemExit(f"clients: errors {errs[:3]}, {bad} wrong answers, "
                         f"{served} served before the fleet, "
                         f"{len(answers)} in all")
    lw.WATCH.assert_clean("serving, an online cycle and a fleet canary")
    edges = lw.WATCH.edges()
    res = {"sites": sorted(lw.WATCH.sites), "edges": sorted(
        f"{a} -> {b}" for a, b in edges), "inversions": 0,
        "requests": len(answers), "served_before_fleet": served,
        "cycle": {k: last_cycle_stats().get(k) for k in
                  ("rows", "mode", "version", "duration_s")},
        "seconds": sec, "total_s": time.perf_counter() - t_all,
        "launches_train": launches, "device": args.device,
        "card": (torch.cuda.get_device_name(0) if cuda else "cpu")}
    print("LOCKWATCH_RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
