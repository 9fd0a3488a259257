#!/usr/bin/env python3
"""One process of the online trainer's kill-and-replay drill.

An OnlineTrainer with a write-ahead feed log (``online_wal``) over a base
Dataset of the first ``--base-rows`` rows of ``ROWS.npy`` / ``LABELS.npy``,
continuing the model in ``MODEL``, is fed the ``--batches`` batches of
``--batch-rows`` rows that follow the base rows, each under the batch id
``b<i>``. ``PARAMS`` (JSON) are the trainer's parameters; the feed log
lives in ``WAL_DIR``.

    python3 scripts/torch_online_drill.py ROWS.npy LABELS.npy MODEL WAL_DIR \\
        PARAMS --base-rows N --batch-rows R --batches K --crash
    python3 scripts/torch_online_drill.py ... --recover --out TEXT

``--crash`` arms ``faults=online_publish:1``, feeds the batches, and dies
(exit code 3, no clean-up, as a killed process would) once the cycle the
last batch triggers has trained and before it publishes. ``--recover``
builds the same trainer over the same feed log: the trainer re-appends the
committed rows, replays the pending batches (their cycle trains and
commits), and then every batch is sent again and must deduplicate by its
id. It writes the model text to ``--out``. Each mode prints one JSON line:
the feed log's state (seqs, commit, bytes, fsync seconds) and, for
``--recover``, the recovery's seconds and the kernel launches of the
replayed cycle. ``--device cpu`` runs on the CPU (default: the GPU).
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rows")
    ap.add_argument("labels")
    ap.add_argument("model")
    ap.add_argument("wal_dir")
    ap.add_argument("params")
    ap.add_argument("--base-rows", type=int, required=True)
    ap.add_argument("--batch-rows", type=int, required=True)
    ap.add_argument("--batches", type=int, required=True)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--crash", action="store_true")
    mode.add_argument("--recover", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()

    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.online import OnlineTrainer
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.utils import atomic_io, faults
    from lightgbm_tpu_torch.utils.faults import FaultInjected

    t_start = time.perf_counter()
    X = np.load(a.rows, mmap_mode="r")
    y = np.load(a.labels, mmap_mode="r")
    params = {**json.loads(a.params), "online_wal": True,
              "online_wal_dir": a.wal_dir, "device_type": a.device}
    n0, nb = a.base_rows, a.batch_rows
    batches = [(X[n0 + i * nb:n0 + (i + 1) * nb],
                y[n0 + i * nb:n0 + (i + 1) * nb], f"b{i}")
               for i in range(a.batches)]
    b1 = lt.Booster(model_file=a.model, params=params)
    ds = lt.Dataset(X[:n0], label=y[:n0], params=params)
    out = {"mode": "crash" if a.crash else "recover"}
    if a.crash:
        faults.configure("online_publish:1")
        tr = OnlineTrainer(params, ds, booster=b1)
        try:
            for Xb, yb, bid in batches:
                tr.feed(Xb, yb, batch_id=bid)
        except FaultInjected as e:
            st = tr.wal.stats()
            out.update(died_at=e.point, last_seq=st["last_seq"],
                       committed_seq=st["committed_seq"],
                       wal_bytes=st["bytes"], fsync_s=st["fsync_s"],
                       bytes_appended=st["bytes_appended"],
                       seconds=time.perf_counter() - t_start)
            print(json.dumps(out), flush=True)
            os._exit(3)   # dies: no close, no flush of anything
        print(json.dumps(dict(out, died_at=None)), flush=True)
        return 1
    hk.reset_launches()
    t0 = time.perf_counter()
    tr = OnlineTrainer(params, ds, booster=b1)
    if a.device == "cuda":
        torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    launches = {k: v for k, v in hk.LAUNCHES.items() if v}
    seqs = tr.wal.batch_seqs()
    resent = [tr.feed(Xb, yb, batch_id=bid) for Xb, yb, bid in batches]
    atomic_io.atomic_write_text(a.out, tr.booster.model_to_string())
    st = tr.wal.stats()
    out.update(recover_s=recover_s, recovery=tr.recovery,
               cycles=tr.cycles, num_data=int(tr.dataset.num_data),
               batch_seqs=seqs, batch_seqs_after_resend=tr.wal.batch_seqs(),
               resend_deduped=all(v is None for v in resent)
               and tr.pending_rows == 0,
               last_seq=st["last_seq"], committed_seq=st["committed_seq"],
               wal_bytes=st["bytes"], launches=launches,
               seconds=time.perf_counter() - t_start)
    tr.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
