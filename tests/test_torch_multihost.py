"""The process-spanning pieces of the port (A21b) in one process, against
the reference where it has a counterpart.

``parallel/multihost.py`` (the raw-uint8 wire codec, the row and sketch
exchanges, the grid's row blocks), ``parallel/dist_data.py`` (the
fixed-width mapper codec byte for byte the reference's, feature blocks,
round-robin rows), ``parallel/fence.py`` (the fenced fields and their
order the reference's), ``parallel/mesh.init_distributed`` (its
``init_process_group`` arguments from ``machines``,
``machine_list_filename``, ``local_listen_port`` and ``time_out``, taken
with the call replaced), the fault points retried through their sites,
the cross-rank sum of the growers, the writer rank and
``parallel/collectivewatch.py``. The drills across processes are in
tests/test_torch_pod_drill.py.
"""
import datetime

import numpy as np
import pytest
import torch

from lightgbm_tpu import binning as RB
from lightgbm_tpu.parallel import dist_data as RD
from lightgbm_tpu.parallel import fence as RF
from lightgbm_tpu.parallel import multihost as RM
from lightgbm_tpu_torch import binning as PB
from lightgbm_tpu_torch import snapshot
from lightgbm_tpu_torch.config import Config, check_slice, params_to_config
from lightgbm_tpu_torch.log import LightGBMError
from lightgbm_tpu_torch.ops import grow as G
from lightgbm_tpu_torch.parallel import collectivewatch as CW
from lightgbm_tpu_torch.parallel import dist_data as PD
from lightgbm_tpu_torch.parallel import fence as PF
from lightgbm_tpu_torch.parallel import mesh as M
from lightgbm_tpu_torch.parallel import multihost as PM
from lightgbm_tpu_torch.utils import faults

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _mixed(n=800, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[:, 1] = np.round(X[:, 1] * 3) / 3
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.6, 3] = 0.0
    X[:, 4] = rng.randint(0, 9, n)
    X[:, 5] = 1.0       # a trivial column
    return X


# ---------------- the wire codec ----------------

@pytest.mark.parametrize("arr", [
    np.array([1.5, np.nan, -0.0, 1e300], np.float64),
    np.arange(12, dtype=np.int64).reshape(3, 4) * (2 ** 40),
    np.array([[1, 2, 3]], np.uint8),
    np.zeros((0, 5), np.float32),
    np.array([7], np.int32)], ids=["f64", "i64", "u8", "empty", "i32"])
@pytest.mark.parametrize("uniform", [False, True])
def test_wire_codec_round_trip(arr, uniform):
    wire = PM.wire_encode(arr)
    assert wire.dtype == np.uint8
    assert wire.tobytes() == RM.wire_encode(arr).tobytes()
    back = PM.wire_decode(wire, arr.dtype, arr.shape[1:])
    assert back.tobytes() == arr.tobytes() and back.shape == arr.shape
    (got,) = PM.wire_allgather(arr, uniform=uniform)
    assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()


def test_allgather_rows_one_process():
    local = np.arange(10, dtype=np.float32).reshape(5, 2)
    out = PM.allgather_rows(local, 5, 0)
    assert np.array_equal(out, local)


# ---------------- the grid's row blocks ----------------

@pytest.mark.parametrize("n,shards,procs", [
    (3000, 8, 4), (3000, 8, 2), (1001, 4, 2), (5, 8, 4), (10, 2, 2)])
def test_pod_plan_row_blocks(n, shards, procs):
    """Each process's block of the grid: contiguous, in process order,
    covering every row once, its shards the grid's."""
    plans = []
    with M.virtual_devices(shards // procs, "cpu"):
        for p in range(procs):
            plan = PM.plan_pod_sharding(n, shards, p, procs)
            PM.verify_pod_plan(plan)
            assert PM.plan_spans_processes(plan) == (procs > 1)
            plans.append(plan)
    rps = -(-n // shards)
    edges = [PM.host_row_range(plans[0], p) for p in range(procs)]
    assert edges[0][0] == 0 and edges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    for p, plan in enumerate(plans):
        assert (plan.row0, plan.row0 + plan.n_rows) == edges[p]
        assert plan.rows_per_shard == rps and plan.shards_global == shards
        assert plan.n_global == n and plan.shard0 == p * plan.num_shards
        # the trainer's global rows cut to this process's, then split
        x = torch.arange(n)
        blocks = plan.split(x)
        assert torch.equal(plan.gather(blocks, torch.device("cpu")),
                           x[edges[p][0]:edges[p][1]])


def test_detect_topology_one_process():
    with M.virtual_devices(3, "cpu"):
        topo = PM.detect_topology("cpu")
    assert (topo.process_index, topo.process_count, topo.local_devices,
            topo.total_devices, topo.is_pod) == (0, 1, 3, 3, False)


def test_pod_plan_refuses_uneven_processes():
    with pytest.raises(LightGBMError, match="does not divide"):
        PM.plan_pod_sharding(100, 6, 0, 4)


def test_load_file_shard(tmp_path):
    X = np.arange(40, dtype=np.float64).reshape(10, 4)
    np.save(tmp_path / "X.npy", X)
    assert np.array_equal(PM.load_file_shard(str(tmp_path / "X.npy"), 3, 7),
                          X[3:7])


@pytest.mark.parametrize("kw", [
    dict(num_shards=8), dict(num_shards=8, feature_shards=2),
    dict(num_shards=4, voting_top_k=5), dict(num_shards=1),
    dict(num_shards=8, hist_slots=127, stat_width=2)])
def test_level_collective_bytes_equal_reference(kw):
    assert PM.level_collective_bytes(28, 64, **kw) == \
        RM.level_collective_bytes(28, 64, **kw)


# ---------------- dist_data ----------------

@pytest.mark.parametrize("f,ranks", [(8, 2), (7, 3), (2, 4), (28, 2)])
def test_feature_slice_and_round_robin_equal_reference(f, ranks):
    for r in range(ranks):
        assert PD.feature_slice(f, r, ranks) == RD.feature_slice(f, r, ranks)
        assert np.array_equal(PD.round_robin_rows(101, r, ranks),
                              RD.round_robin_rows(101, r, ranks))


@pytest.mark.parametrize("kw", [{}, {"zero_as_missing": True},
                                {"use_missing": False}])
def test_mapper_codec_rows_equal_reference(kw):
    """The port's encoded mapper rows are the reference's, byte for byte,
    and decode to the mapper (numerical, NaN, zeros, categorical)."""
    X = _mixed()
    port = PB.find_bin_mappers(X, max_bin=32, categorical=[4], **kw)
    ref = RB.find_bin_mappers(X, max_bin=32, categorical=[4], **kw)
    width = 10 + 32 + 2
    for p, r in zip(port, ref):
        row = PD._encode_mapper(p, width)
        assert row.tobytes() == RD._encode_mapper(r, width).tobytes()
        back = PD._decode_mapper(row)
        for name in ("num_bins", "bin_type", "missing_type", "default_bin",
                     "most_freq_bin", "is_trivial", "sparse_rate",
                     "min_value", "max_value"):
            assert getattr(back, name) == getattr(p, name), name
        assert np.asarray(back.upper_bounds).tobytes() == \
            np.asarray(p.upper_bounds).tobytes()
        assert np.array_equal(back.cat_values, p.cat_values)


def test_mapper_allgather_fault_retried():
    """In one process the distributed mappers are find_bin_mappers over
    all features with seed + 0; an armed mapper_allgather fails once and
    the exchange is retried."""
    X = _mixed()
    faults.configure("mapper_allgather:1")
    got = PD.find_bin_mappers_distributed(X, max_bin=16)
    assert faults.hits("mapper_allgather") == 2
    ref = RB.find_bin_mappers(X, max_bin=16)
    for g, r in zip(got, ref):
        assert (g.num_bins, g.missing_type, g.default_bin) == \
            (r.num_bins, r.missing_type, r.default_bin)
        assert np.asarray(g.upper_bounds).tobytes() == \
            np.asarray(r.upper_bounds).tobytes()


def test_sketch_and_rows_faults_retried():
    """find_bin_mappers_pod (its sketch exchange) and allgather_rows each
    fail once and retry; one process's pod mappers are the reference's
    serial ones, sampled rows included."""
    X = _mixed(n=3000)
    faults.configure("sketch_allgather:1,rows_allgather:1")
    phases = {}
    got = PM.find_bin_mappers_pod(X, 3000, 0, max_bin=16, sample_cnt=1000,
                                  categorical=[4], phases=phases)
    rows = PM.allgather_rows(X[:, :2].copy(), 3000, 0)
    assert faults.hits("sketch_allgather") == 2
    assert faults.hits("rows_allgather") == 2
    assert "sketch_allgather_s" in phases
    assert np.array_equal(rows, X[:, :2])
    ref = RB.find_bin_mappers(X, max_bin=16, sample_cnt=1000,
                              categorical=[4])
    for g, r in zip(got, ref):
        assert np.asarray(g.upper_bounds).tobytes() == \
            np.asarray(r.upper_bounds).tobytes()
        assert np.array_equal(g.cat_values, r.cat_values)
        assert (g.sparse_rate, g.min_value, g.max_value) == \
            (r.sparse_rate, r.min_value, r.max_value)


# ---------------- the fence ----------------

class _Shim:
    def __init__(self, mappers, plan=None):
        self.mappers = mappers
        self.feature_map = np.arange(len(mappers))
        self.num_features = len(mappers)
        self.shard_plan = plan
        self.device = torch.device("cpu")


def test_fence_items_names_and_order_equal_reference():
    assert PF.FENCE_CONFIG_FIELDS == RF.FENCE_CONFIG_FIELDS
    X = _mixed()
    port = PF.fence_items(params_to_config({}),
                          _Shim(PB.find_bin_mappers(X, max_bin=16)))
    from lightgbm_tpu.config import params_to_config as ref_config
    ref = RF.fence_items(ref_config({}),
                         _Shim(RB.find_bin_mappers(X, max_bin=16)))
    assert [n for n, _ in port] == [n for n, _ in ref]
    # the mappers hash the same bytes in both packages
    assert dict(port)["data.bin_mappers"] == dict(ref)["data.bin_mappers"]
    assert PF._digest(b"abc").tobytes() == RF._digest(b"abc").tobytes()


def test_fence_one_process_passes_and_plan_item_is_the_grids():
    assert PF.consistency_fence(params_to_config({}), None) is True
    with M.virtual_devices(2, "cpu"):
        a = PM.plan_pod_sharding(1000, 4, 0, 2)
        b = PM.plan_pod_sharding(1000, 4, 1, 2)
    items = [dict(PF.fence_items(params_to_config({}), _Shim([], p)))
             for p in (a, b)]
    # every rank hashes the same grid, whatever its block
    assert items[0]["data.shard_plan"] == items[1]["data.shard_plan"]


# ---------------- the bootstrap ----------------

@pytest.fixture
def captured(monkeypatch):
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    monkeypatch.setenv("RANK", "1")
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    saved = dict(M.DIST)
    yield calls
    M.DIST.update(saved)


@pytest.mark.parametrize("params,init", [
    ({"machines": "10.0.0.1:1234,10.0.0.2:1234,10.0.0.3:1234"},
     "tcp://10.0.0.1:1234"),
    ({"machines": "hostA,hostB,hostC", "local_listen_port": 23456},
     "tcp://hostA:23456"),
    ({"machine_list_filename": "LIST"}, "tcp://hostB:4321"),
    ({}, "env://"),
])
def test_init_distributed_arguments(captured, tmp_path, params, init):
    if "machine_list_filename" in params:
        f = tmp_path / "mlist.txt"
        f.write_text("# the coordinator first\nhostB 4321\n"
                     "hostC:4321  # a comment\n\nhostD 4321\n")
        params = {"machine_list_filename": str(f)}
    conf = params_to_config(dict(params, num_machines=3, time_out=7,
                                 device_type="cpu"))
    assert M.init_distributed(conf) is True
    (kw,) = captured
    assert kw == {"backend": "gloo", "init_method": init, "world_size": 3,
                  "rank": 1, "timeout": datetime.timedelta(minutes=7)}
    assert M.DIST["backend"] == "gloo"
    assert M.DIST["device"] == torch.device("cpu")


def test_machine_list_parsing(tmp_path):
    f = tmp_path / "m.txt"
    f.write_text("a 1\n# x\n b:2 # y\n")
    conf = params_to_config({"machine_list_filename": str(f)})
    assert M.machine_list(conf) == ["a:1", "b:2"]
    conf = params_to_config({"machines": " a:1 , b:2 ,",
                             "machine_list_filename": str(f)})
    assert M.machine_list(conf) == ["a:1", "b:2"]


def test_init_distributed_one_machine_and_missing_rank(captured,
                                                       monkeypatch):
    assert M.init_distributed(params_to_config({})) is False
    monkeypatch.delenv("RANK")
    with pytest.raises(LightGBMError, match="RANK"):
        M.init_distributed(params_to_config({"num_machines": 2,
                                             "device_type": "cpu"}))
    assert captured == []


def test_dist_init_fault_retried(captured):
    faults.configure("dist_init:1")
    conf = params_to_config({"num_machines": 3, "device_type": "cpu",
                             "machines": "h:1"})
    assert M.init_distributed(conf) is True
    assert faults.hits("dist_init") == 2 and len(captured) == 1


def test_dist_init_fault_exhausts_network_retries(captured):
    faults.configure("dist_init:-1")
    conf = params_to_config({"num_machines": 3, "device_type": "cpu",
                             "network_retries": 2, "machines": "h:1"})
    with pytest.raises(faults.FaultInjected):
        M.init_distributed(conf)
    assert faults.hits("dist_init") == 2 and captured == []


@pytest.mark.parametrize("env,backend", [
    ({}, "gloo"), ({"LOCAL_WORLD_SIZE": "1"}, "nccl"),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, "gloo")])
def test_choose_backend(monkeypatch, env, backend):
    """NCCL only when every rank of the host owns a card; the CPU is
    gloo."""
    assert M.choose_backend(params_to_config({"device_type": "cpu"})) == \
        ("gloo", None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("RANK", "0")
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, card = M.choose_backend(params_to_config({"num_machines": 2}))
    assert got == backend and card == torch.device("cuda", 0)


def test_check_slice_accepts_num_machines():
    check_slice(params_to_config({"num_machines": 4}))
    assert faults.UNPORTED_POINTS == {}


def test_writer_rank(monkeypatch):
    assert snapshot.is_writer_rank()
    monkeypatch.setattr(PM, "process_index", lambda: 1)
    assert not snapshot.is_writer_rank()


# ---------------- the cross-rank sums ----------------

def test_shard_sums_cross_ranks_when_the_axis_spans_processes(monkeypatch):
    """One process: a lone part is returned as it is. Spanning processes
    (``processes`` > 1): every local sum goes through the cross-rank sum
    once, counted apart from the in-process sums."""
    parts = [torch.full((3, 4, 8), float(i)) for i in range(3)]
    gp = G.GrowParams(axis_name="data")
    assert G._psum(parts[:1], gp) is parts[0]
    seen = []
    monkeypatch.setattr(PM, "allreduce_sum",
                        lambda t: seen.append(t.clone()) or t * 2)
    gp2 = G.GrowParams(axis_name="data", processes=2)
    G.reset_allreduce()
    got = G._hist_allreduce(parts, gp2, 1)
    assert torch.equal(got, 2 * (parts[0] + parts[1] + parts[2]))
    assert torch.equal(G._psum(parts[:1], gp2), 2 * parts[0])
    assert G.ALLREDUCE["x_calls"] == 2 and G.ALLREDUCE["x_hist_calls"] == 1
    assert G.ALLREDUCE["x_bytes"] == 2 * 3 * 4 * 8 * 4
    # a 2-D mesh sums each feature block across the ranks
    gp3 = G.GrowParams(axis_name="data", processes=2,
                       feature_axis_name="feature", feature_shards=2)
    seen.clear()
    got = G._hist_allreduce(parts, gp3, 1, (torch.device("cpu"),) * 2)
    assert torch.equal(got, 2 * (parts[0] + parts[1] + parts[2]))
    assert [tuple(t.shape) for t in seen] == [(3, 2, 8), (3, 2, 8)]


def test_allreduce_sum_over_a_one_process_gloo_group():
    """The transport on a real gloo group: a new tensor with the rank sum
    (one rank: the same values), the input untouched."""
    import torch.distributed as dist
    from _mp_util import free_port
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    saved = dict(M.DIST)
    try:
        M.DIST.update(backend="gloo", device=torch.device("cpu"), card=None)
        t = torch.arange(6, dtype=torch.float32)
        out = PM.allreduce_sum(t)
        assert out is not t and torch.equal(out, t)
        assert PM.process_count() == 1 and PM.process_index() == 0
    finally:
        M.DIST.update(saved)
        dist.destroy_process_group()


# ---------------- collectivewatch ----------------

def test_collectivewatch_flags_raw_non_uint8_and_divergence(tmp_path):
    w = CW.CollectiveWatch()
    w.note("all_gather", torch.zeros(4, dtype=torch.uint8))
    w.note("all_reduce", torch.zeros(2, 3))
    assert w.wire_violations() == []
    w.assert_clean()
    w.note("all_gather", torch.zeros(4, dtype=torch.float64))
    assert len(w.wire_violations()) == 1
    with pytest.raises(AssertionError, match="wire-dtype"):
        w.assert_clean("a drill")
    a, b = CW.CollectiveWatch(), CW.CollectiveWatch()
    for x in (a, b):
        x.note("all_gather", torch.zeros(4, dtype=torch.uint8))
    a.note("all_reduce", torch.zeros(3))
    b.note("all_reduce", torch.zeros(4))
    pa, pb = a.write_ledger(str(tmp_path / "a")), \
        b.write_ledger(str(tmp_path / "b"))
    problems = CW.compare_ledgers([pa, pb])
    assert len(problems) == 1 and "rendezvous #1" in problems[0]
    b.note("barrier", None)
    b.write_ledger(pb)
    assert any("COUNT" in p for p in CW.compare_ledgers([pa, pb]))
    with pytest.raises(AssertionError):
        CW.assert_ledgers_match([pa, pb])


def test_collectivewatch_install_wraps_and_uninstall_restores():
    import torch.distributed as dist
    orig = dist.all_gather
    CW.install()
    try:
        assert dist.all_gather is not orig
        assert dist.all_gather.collectivewatch_of is orig
        CW.install()        # idempotent
        assert dist.all_gather.collectivewatch_of is orig
    finally:
        CW.uninstall()
    assert dist.all_gather is orig


def test_check_slice_config_of_network_knobs():
    conf = Config({"num_machines": 2, "machines": "a:1,b:1",
                   "time_out": 5, "network_retries": 4})
    assert (conf.num_machines, conf.time_out, conf.network_retries) == \
        (2, 5, 4)


@pytest.mark.parametrize("what", ["subset", "append", "save_binary"])
def test_row_wise_operations_refused_on_a_process_spanning_dataset(
        what, tmp_path):
    import lightgbm_tpu_torch as lt
    X = _mixed(n=200)
    ds = lt.Dataset(X, label=np.arange(200) % 2,
                    params={"device_type": "cpu", "verbosity": -1})
    ds.construct()
    ds._pod_rows_of = (0, 400)     # as a rank of two would hold it
    call = {"subset": lambda: ds.subset([0, 1, 2]),
            "append": lambda: ds.append(X[:10], label=np.zeros(10)),
            "save_binary": lambda: ds.save_binary(str(tmp_path / "d.bin"))}
    with pytest.raises(LightGBMError, match="spanning processes"):
        call[what]()
