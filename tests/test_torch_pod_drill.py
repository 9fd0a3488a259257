"""Process-spanning training drills of the PyTorch/CUDA port on the CPU.

The cases of the reference's tests/test_zz_pod_drill.py on the port: each
drill spawns rank processes (``scripts/torch_pod_worker.py`` through
``tests/_mp_util.spawn_ranks``, one OpenMP thread and a 120 s timeout
each) that start a gloo ``torch.distributed`` group, read only their own
rows of the file (``multihost.host_row_range`` + ``load_file_shard``) on
``virtual_devices`` and train with ``_pod_common``'s data and parameters,
quantization off and the lattice objective (gradients on a 2^-9 grid,
hessian 0.25), so that every histogram sum is exact in any order and
"byte for byte" is string equality:

- the merged-sketch mappers are the reference's serial
  ``find_bin_mappers`` over all rows, bit for bit;
- the model text before its parameter echo is the port's one-process run
  on the same shard grid (``virtual_devices`` in this process) and the
  reference's single-process run on its 8 virtual XLA devices, for 4
  ranks x 2 devices (data-parallel) and 2 x 4 (voting-parallel);
- a kill of both ranks at iteration 4 (2 ranks x 2), resumed from rank
  0's snapshots in one process on the same 4-shard grid, is the
  uninterrupted model; with lazy CEGB, whose snapshot gathers the
  rows' feature bitset across the ranks (ROADMAP C18), the same at a
  kill at iteration 3;
- a rank with another learning_rate fails the consistency fence on every
  rank, naming the field, before any tree;
- the CLI's round-robin load trains through ``app.main`` with the
  process-spanning fault points armed once each (each retried).

Every rank's ``collectivewatch`` ledger must equal the others' and carry
only uint8 raw gathers.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.binning import find_bin_mappers as ref_find_bin_mappers
from lightgbm_tpu_torch.parallel import collectivewatch
from lightgbm_tpu_torch.parallel.mesh import virtual_devices

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _mp_util import spawn_ranks  # noqa: E402
from _pod_common import (GRIDS, ROUNDS, base_params, lattice_fobj,  # noqa
                         make_data, mapper_digest, tree_digest)

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join("scripts", "torch_pod_worker.py")
RANK_TIMEOUT_S = 120


def _params(mode):
    return dict(base_params(mode), use_quantized_grad=False)


@pytest.fixture(scope="module")
def pod_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pod")
    X, y = make_data()
    np.save(d / "X.npy", X)
    np.save(d / "y.npy", y)
    np.savetxt(d / "train.csv", np.column_stack([y, X]), delimiter=",",
               fmt="%.17g")
    return str(d)


@pytest.fixture(scope="module")
def serial_mapper_digest():
    X, _ = make_data()
    return mapper_digest(ref_find_bin_mappers(
        X, max_bin=base_params("dp")["max_bin"]))


@pytest.fixture(autouse=True)
def _one_thread_ranks(monkeypatch):
    # the spawned ranks inherit it
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _spawn(out, world, devices, jobs, expect_rc=0):
    """Run the jobs on ``world`` ranks of ``devices`` virtual CPU devices
    each; the ranks' results (one list a rank) after their ledgers were
    compared."""
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, "spec.json")
    with open(spec, "w") as fh:
        json.dump({"world": world, "port": 0, "devices": devices,
                   "device_type": "cpu", "out": out, "jobs": jobs}, fh)
    procs, outs = spawn_ranks(
        lambda port: [WORKER, spec, "--port", str(port), "--rank-env",
                      "JAX_PROCESS_ID"],
        nprocs=world, timeout=RANK_TIMEOUT_S, cwd=REPO)
    for p, o in zip(procs, outs):
        assert p.returncode == expect_rc, \
            f"rank rc={p.returncode} (expected {expect_rc}):\n{o[-3000:]}"
    results = [[json.loads(ln.split(" ", 1)[1]) for ln in o.splitlines()
                if ln.startswith("POD_RESULT ")] for o in outs]
    if expect_rc:
        # a killed job: the results of the jobs that ran before it
        return results
    assert all(len(r) == len(jobs) for r in results), outs[0][-3000:]
    paths = [os.path.join(out, f"collwatch_rank{r}.jsonl")
             for r in range(world)]
    collectivewatch.assert_ledgers_match(paths, context=f"{world} ranks")
    assert collectivewatch.read_ledger(paths[0]), "no collective recorded"
    return results


def _port_digest(X, y, params, shards, rounds, **kw):
    """The port's one-process run on ``shards`` virtual CPU devices."""
    p = dict(params, device_type="cpu", num_shards=shards)
    with virtual_devices(shards, "cpu"):
        bst = lt.train(p, lt.Dataset(X, label=y, params=p), rounds,
                       fobj=lattice_fobj, **kw)
    return tree_digest(bst.model_to_string())


def _ref_digest(X, y, params, shards, rounds):
    """The reference's single-process run on its virtual XLA devices."""
    p = dict(params, num_shards=shards)
    bst = lgb.train(p, lgb.Dataset(X, label=y, params=p), rounds,
                    fobj=lattice_fobj, verbose_eval=False)
    return tree_digest(bst.model_to_string())


@pytest.mark.parametrize("mode,world,devices", [
    ("dp", 4, 2),        # 4 processes x 2 devices
    ("voting", 2, 4),    # voting-parallel top-k over the same 8 shards
])
def test_pod_byte_identical_to_one_process(mode, world, devices, pod_data,
                                           serial_mapper_digest, tmp_path):
    res = _spawn(str(tmp_path), world, devices, [
        {"name": mode, "data": pod_data, "params": _params(mode),
         "rounds": ROUNDS, "fobj": "grid9"}])
    got = [r[0] for r in res]
    assert all(r["ranks_agree"] and r["backend"] == "gloo" for r in got)
    assert len({(r["mappers"], r["tree"]) for r in got}) == 1, got
    assert [r["rows"] for r in got] == [
        [i * 3000 // world, (i + 1) * 3000 // world] for i in range(world)]
    # every level's histograms were summed across the ranks
    assert got[0]["allreduce"]["x_hist_calls"] >= ROUNDS
    assert got[0]["hits"]["sketch_allgather"] == 1
    assert got[0]["mappers"] == serial_mapper_digest
    X, y = make_data()
    ns = GRIDS[mode][0]
    assert got[0]["tree"] == _port_digest(X, y, _params(mode), ns, ROUNDS)
    assert got[0]["tree"] == _ref_digest(X, y, _params(mode), ns, ROUNDS)


def test_chaos_kill_and_resume_in_one_process(pod_data, tmp_path):
    """Both ranks killed at iteration 4 (2 x 2), resumed from rank 0's
    snapshots in one process on the same 4 shards: the uninterrupted
    model, the port's and the reference's."""
    snaps = str(tmp_path / "snaps")
    params = dict(_params("chaos"), snapshot_freq=2, snapshot_dir=snaps)
    _spawn(str(tmp_path), 2, 2, [
        {"name": "chaos", "data": pod_data, "params": params, "rounds": 6,
         "fobj": "grid9", "faults": "tree_update@4"}], expect_rc=17)
    assert sorted(f for f in os.listdir(snaps) if f.endswith(".txt")) \
        == ["snapshot_iter_2.txt", "snapshot_iter_4.txt"], os.listdir(snaps)
    X, y = make_data()
    resumed = _port_digest(X, y, params, 4, 6, resume_from_snapshot=snaps)
    clean = _port_digest(X, y, _params("chaos"), 4, 6)
    assert resumed == clean
    assert clean == _ref_digest(X, y, _params("chaos"), 4, 6)


def test_c18_lazy_cegb_snapshot_across_ranks_resumes(pod_data, tmp_path):
    """C18: a lazy-CEGB run with a snapshot every 2 iterations on 2 ranks
    x 2 shards. The snapshot gathers the lazy bitset from both ranks'
    rows, a collective the non-writer rank once skipped, so both ranks
    hung until their timeout. Now both ranks finish the unkilled run, and
    a run killed at iteration 3, resumed from rank 0's snapshot of
    iteration 2 in one process on the same 4 shards, is the unkilled
    model byte for byte."""
    cegb = dict(_params("chaos"), cegb_penalty_feature_lazy=[0.001] * 8)
    snaps = str(tmp_path / "snaps")
    killed = dict(cegb, snapshot_freq=2, snapshot_dir=snaps)
    res = _spawn(str(tmp_path), 2, 2, [
        {"name": "clean", "data": pod_data, "rounds": 4, "fobj": "grid9",
         "params": dict(cegb, snapshot_freq=2,
                        snapshot_dir=str(tmp_path / "clean_snaps"))},
        {"name": "killed", "data": pod_data, "params": killed, "rounds": 4,
         "fobj": "grid9", "faults": "tree_update@3"}], expect_rc=17)
    clean = [r[0] for r in res]
    assert [len(r) for r in res] == [1, 1]
    assert all(r["ranks_agree"] for r in clean)
    assert clean[0]["tree"] == clean[1]["tree"]
    assert sorted(f for f in os.listdir(snaps) if f.endswith(".txt")) \
        == ["snapshot_iter_2.txt"], os.listdir(snaps)
    X, y = make_data()
    resumed = _port_digest(X, y, killed, 4, 4, resume_from_snapshot=snaps)
    assert resumed == clean[0]["tree"]
    assert resumed == _port_digest(X, y, cegb, 4, 4)


def test_fence_mismatch_raises_on_every_rank(pod_data, tmp_path):
    res = _spawn(str(tmp_path), 2, 1, [
        {"name": "fence", "data": pod_data,
         "params": dict(_params("dp"), num_shards=2), "rounds": 2,
         "fobj": "grid9", "rank_params": {"1": {"learning_rate": 0.3}},
         "expect_error": "config.learning_rate"}])
    for r in res:
        err = r[0]["error"]
        assert "consistency fence FAILED" in err
        assert "config.learning_rate" in err
        # the one field that differs; the data agree
        assert "data." not in err and err.count("config.") == 1
        assert not any(r[0]["launches"].values())


def test_cli_round_robin_with_retried_fault_points(pod_data, tmp_path):
    """``app.main`` on 2 ranks: each parses the file and keeps its
    round-robin rows; the group start, the sketch and row exchanges and
    the mapper exchange (dist_data) each fail once and are retried. The
    model is the one-process model over the ranks' rows in rank order."""
    params = {"objective": "regression", "num_leaves": 7, "max_bin": 16,
              "min_data_in_leaf": 5, "learning_rate": 0.5,
              "boost_from_average": False, "use_quantized_grad": False,
              "enable_bundle": False, "num_shards": 4, "verbosity": -1}
    res = _spawn(str(tmp_path), 2, 2, [
        {"name": "cli", "data": pod_data, "params": params, "rounds": 1,
         "cli": True, "mappers_distributed": True,
         "faults": "dist_init:1,sketch_allgather:1,rows_allgather:1,"
                   "mapper_allgather:1"}])
    got = [r[0] for r in res]
    for r in got:
        for point in ("dist_init", "sketch_allgather", "mapper_allgather"):
            assert r["hits"][point] == 2, (point, r["hits"])
        assert r["hits"]["rows_allgather"] >= 2
    assert got[0]["tree"] == got[1]["tree"]
    assert got[0]["dist_mappers"] == got[1]["dist_mappers"]
    X, y = make_data()
    order = np.concatenate([np.arange(r, len(X), 2) for r in (0, 1)])
    # exact sums: one L2 tree from zero scores on labels in {0, 1}
    p = dict(params, device_type="cpu")
    with virtual_devices(4, "cpu"):
        one = lt.train(p, lt.Dataset(X[order], label=y[order], params=p), 1)
    assert got[0]["tree"] == tree_digest(one.model_to_string())
    # each rank's block of features binned from its own rows (seed + rank)
    from lightgbm_tpu.parallel.dist_data import feature_slice
    mappers = []
    for r in (0, 1):
        lo, hi = feature_slice(X.shape[1], r, 2)
        mappers += ref_find_bin_mappers(X[r::2, lo:hi], max_bin=16,
                                        seed=1 + r)
    assert got[0]["dist_mappers"] == mapper_digest(mappers)
