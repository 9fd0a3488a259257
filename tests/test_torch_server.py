"""The serving front end of the PyTorch/CUDA port (lightgbm_tpu_torch/server.py:
request-coalescing microbatcher, model registry, line protocol, stdio and
TCP transports, the C API's server entries), on the CPU: the reference's
tests/test_server.py cases on the port.

Scheduler outputs equal Booster.predict (the engine) and the port's plain
raw-value walk (ops/predict.predict_raw) bit for bit under concurrency; a
hot swap under load drops nothing and every answer is its version's; the
queue sheds at overload; the line protocol's answers are the reference's
for the same model text and lines (versions and replies exactly, scores
within rtol 1e-6: the reference sums its trees in f32); a pure-C host
drives the server entries of the C library. The reference's
``test_zero_retraces_after_warmup`` counts XLA lowerings; here no new
engine upload and no new bucket appear after the warm-up.
"""
import io
import os
import shutil
import socket
import subprocess
import sys
import sysconfig
import threading
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu import server as ref_server
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.ops import predict as P
from lightgbm_tpu_torch.server import (MicroBatcher, ModelRegistry,
                                       PredictServer, ServeOverload,
                                       handle_line, serve_stdio, serve_tcp)

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _lockwatch_zero_inversions():
    """The runtime watchdog conftest installs before any lock exists (its
    prefix also matches the port's files) must record no lock-order
    inversion after this file's real concurrency (ROADMAP A22)."""
    from lightgbm_tpu.analysis import lockwatch
    yield
    lockwatch.WATCH.assert_clean("tests/test_torch_server.py")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.RandomState(11)
N_FEAT = 8
CPU = {"device_type": "cpu"}
DEV = torch.device("cpu")
RTOL = 1e-6


def _train(rounds=6, seed_shift=0.0, **extra):
    X = RNG.rand(500, N_FEAT)
    y = (X[:, 0] + X[:, 1] + seed_shift * X[:, 2] > 1).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, **CPU, **extra}
    return lt.train(params, lt.Dataset(X, label=y, params=params),
                    num_boost_round=rounds)


@pytest.fixture(scope="module")
def boosters():
    return _train(rounds=5), _train(rounds=8, seed_shift=1.0)


@pytest.fixture(scope="module")
def queries():
    return RNG.rand(64, N_FEAT)


def _mk_server(b, **conf):
    conf = {"verbosity": -1, "serve_max_batch_rows": 256, **CPU, **conf}
    return PredictServer(conf, model=b)


def _plain(b, x, raw_score=False):
    trees = b._host_trees()
    raw = P.predict_raw(trees, torch.as_tensor(x, dtype=torch.float64),
                        b.num_model_per_iteration())
    if b.average_output() and trees:
        raw = raw / (len(trees) // b.num_model_per_iteration())
    obj = b._objective_for_predict()
    if not raw_score and obj is not None:
        raw = obj.convert_output(raw)
    return raw.numpy()


# ---- bit-exactness and thread safety ----

def test_concurrent_bit_exact_vs_direct(boosters, queries):
    """8 threads x 3 passes of single-row requests through the scheduler
    equal the direct predict and the plain walk, bit for bit."""
    b1, _ = boosters
    srv = _mk_server(b1)
    try:
        want = {False: b1.predict(queries),
                True: b1.predict(queries, raw_score=True)}
        assert np.array_equal(want[False], _plain(b1, queries))
        assert np.array_equal(want[True], _plain(b1, queries, True))
        n_threads, reps = 8, 3
        errs, results = [], {}

        def worker(t):
            try:
                out = []
                for rep in range(reps):
                    for i in range(t, len(queries), n_threads):
                        raw = (t + rep + i) % 2 == 1
                        out.append((i, raw, srv.predict(queries[i],
                                                        raw_score=raw)))
                results[t] = out
            except Exception as e:            # pragma: no cover
                errs.append(e)

        ths = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
        [t.start() for t in ths]
        [t.join() for t in ths]
        assert not errs, errs
        checked = 0
        for out in results.values():
            for i, raw, got in out:
                assert got.shape == (1,)
                assert got[0] == want[raw][i], (i, raw)
                checked += 1
        assert checked == n_threads * reps * (len(queries) // n_threads)
        st = srv.stats()["scheduler"]
        assert st["requests"] >= checked
        assert st["flushes"] <= st["requests"]
    finally:
        srv.close()


def test_multirow_requests_bit_exact(boosters, queries):
    b1, _ = boosters
    srv = _mk_server(b1)
    try:
        for n in (1, 2, 7, 33):
            got = srv.predict(queries[:n])
            assert np.array_equal(got, b1.predict(queries[:n])), n
            assert np.array_equal(got, _plain(b1, queries[:n])), n
        got = srv.predict(queries[:5], pred_leaf=True)
        assert np.array_equal(got, b1.predict(queries[:5], pred_leaf=True))
    finally:
        srv.close()


def test_no_new_upload_or_bucket_after_warmup(boosters, queries):
    """After the publish-time warm-up of every bucket, a concurrent storm of
    requests makes no engine upload and meets no bucket the warm-up did
    not (the card's counterpart, the caching allocator's
    num_alloc_retries, is in tests/test_torch_cuda.py)."""
    b1, _ = boosters
    obs.reset()
    obs.configure(enabled=True)
    srv = _mk_server(b1, serve_max_batch_rows=64)
    try:
        eng = srv.registry.current().engine
        seen = set(eng.stats["buckets_seen"])
        assert seen == {1, 8, 16, 32, 64}
        ups = sum(e["type"] == "engine_upload" for e in obs.EVENTS.snapshot())

        # 6 threads of at most 8 rows coalesce to at most 48 rows, inside
        # the warmed buckets (a flush may overshoot serve_max_batch_rows by
        # its last request, as the reference's does)
        def worker(t):
            for n in (1, 2, 5, 8, 3, 7):
                srv.predict(queries[:n], raw_score=(t % 2 == 0))
        ths = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
        [t.start() for t in ths]
        [t.join() for t in ths]
        assert eng.stats["buckets_seen"] == seen
        assert sum(e["type"] == "engine_upload"
                   for e in obs.EVENTS.snapshot()) == ups
    finally:
        srv.close()
        obs.reset()
        obs.configure(enabled=False)


# ---- hot swap ----

def test_hot_swap_mid_load_zero_drops(boosters, queries):
    """Publish v2 while 8 threads hammer v1: every request is answered,
    each answer is its serving version's, and v1's engine is released once
    its flushes drain."""
    b1, b2 = boosters
    srv = _mk_server(b1)
    try:
        want = {1: b1.predict(queries), 2: b2.predict(queries)}
        eng_v1 = srv.registry.current().engine
        errs, results = [], []
        res_lock = threading.Lock()
        stop = threading.Event()

        def worker(t):
            try:
                j = t
                while not stop.is_set():
                    i = j % len(queries)
                    r = srv.batcher.submit_async(queries[i])
                    out = r.result(timeout=30)
                    with res_lock:
                        results.append((i, r.version, out))
                    j += 1
            except Exception as e:            # pragma: no cover
                errs.append(e)

        ths = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        [t.start() for t in ths]
        while len(results) < 50 and not errs:
            time.sleep(0.005)
        assert srv.publish(b2) == 2
        n_at_swap = len(results)
        while len(results) < n_at_swap + 50 and not errs:
            time.sleep(0.005)
        stop.set()
        [t.join() for t in ths]
        assert not errs, errs
        seen = set()
        for i, version, out in results:
            seen.add(version)
            assert out[0] == want[version][i], (i, version)
        assert seen == {1, 2}, seen
        assert srv.registry.current().version == 2
        assert eng_v1.released
        with pytest.raises(RuntimeError, match="release"):
            eng_v1.run_binned(np.zeros((1, N_FEAT), np.int32), 1)
    finally:
        srv.close()


def test_registry_versioning_and_drain(boosters):
    b1, b2 = boosters
    reg = ModelRegistry(DEV)
    sm1 = reg.publish("m", b1)
    assert sm1.version == 1 and sm1.engine.device == DEV
    held = reg.acquire("m")                   # an in-flight flush
    sm2 = reg.publish("m", b2)
    assert sm2.version == 2 and reg.current("m") is sm2
    assert sm1.retired and not sm1.engine.released   # still held
    reg.release(held, rows=3)
    assert sm1.engine.released                # released at drain
    assert sm1.served_rows == 3
    with pytest.raises(KeyError):
        reg.acquire("nope")


# ---- scheduling ----

def test_overload_sheds_bounded(boosters, queries):
    b1, _ = boosters
    reg = ModelRegistry(DEV)
    reg.publish("default", b1, warmup_sizes=())
    mb = MicroBatcher(reg, queue_max=4, start=False)
    reqs = [mb.submit_async(queries[i]) for i in range(4)]
    with pytest.raises(ServeOverload):
        mb.submit_async(queries[4])
    assert mb.stats["shed"] == 1
    # a draining close still serves every admitted request
    mb.start()
    mb.close(drain=True)
    assert mb.stats["flushed_rows"] == 4
    for i, r in enumerate(reqs):
        assert r.result(timeout=10)[0] == b1.predict(queries[i:i + 1])[0]


def test_coalesce_factor_above_one(boosters, queries):
    b1, _ = boosters
    reg = ModelRegistry(DEV)
    reg.publish("default", b1)
    mb = MicroBatcher(reg, batch_window_us=2000, max_batch_rows=256,
                      start=False)
    reqs = [mb.submit_async(queries[i % len(queries)]) for i in range(50)]
    mb.start()
    outs = [r.result(timeout=30) for r in reqs]
    assert all(o is not None for o in outs)
    assert mb.coalesce_factor() > 1.0
    assert mb.stats["flushes"] < 50
    mb.close()


def test_idle_fast_path(boosters, queries):
    """A lone request on an idle server does not wait for the window."""
    b1, _ = boosters
    srv = _mk_server(b1, serve_batch_window_us=300_000)
    try:
        srv.predict(queries[0])
        t0 = time.perf_counter()
        srv.predict(queries[1])
        dt = time.perf_counter() - t0
        assert dt < 0.25, f"idle single-row request took {dt:.3f}s"
        assert srv.stats()["scheduler"]["fast_path"] >= 1
    finally:
        srv.close()


def test_request_validation(boosters, queries):
    b1, _ = boosters
    srv = _mk_server(b1, serve_max_batch_rows=16)
    try:
        with pytest.raises(ValueError, match="serve_max_batch_rows"):
            srv.predict(RNG.rand(17, N_FEAT))
        with pytest.raises(ValueError, match="features"):
            srv.predict(RNG.rand(2, 2, 2))
        with pytest.raises(KeyError, match="no model"):
            srv.predict(queries[0], model="ghost")
        # a capture id (a delayed-label join) needs an online trainer
        with pytest.raises(lt.LightGBMError, match="online trainer"):
            srv.predict(queries[0], capture_id="r1")
        # attached, the trainer files the captured features before the
        # predict, and the late label joins them
        from lightgbm_tpu_torch.online import OnlineTrainer
        X = np.random.RandomState(3).rand(100, N_FEAT)
        p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
             "min_data_in_leaf": 5, "online_refit_rows": 1000, **CPU}
        tr = OnlineTrainer(p, lt.Dataset(X, label=X[:, 0] > 0.5, params=p),
                           booster=b1, server=srv)
        srv.attach_online(tr)
        got = srv.predict(queries[0], capture_id="r1")
        assert np.array_equal(got, b1.predict(queries[:1]))
        assert tr.join_stats()["pending"] == 1
        tr.feed_label("r1", 1.0)
        assert tr.join_stats()["joined"] == 1 and tr.pending_rows == 1
        assert srv.stats()["online"]["join"]["joined"] == 1
        tr.close()
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match="shut down"):
        srv.predict(queries[0])


# ---- transports ----

def test_line_protocol_and_stdio_match_reference(boosters, queries, tmp_path):
    """The same model texts and lines through the port's and the
    reference's handle_line / serve_stdio: the same versions and replies,
    scores within rtol 1e-6; the port's scores equal its own predict."""
    b1, b2 = boosters
    p1, p2 = str(tmp_path / "m1.txt"), str(tmp_path / "m2.txt")
    b1.save_model(p1)
    b2.save_model(p2)
    line = ",".join("%.17g" % v for v in queries[0])
    script = (f"{line}\n!publish {p2}\n{line}\n!stats\n!bogus\n"
              f"not,numbers,at,all\n!learn 1,2,3\n!label r1 1\nr1|{line}\n"
              "!promote\n!fleet_stats\n!quit\n")
    outs = []
    for srv in (PredictServer({"verbosity": -1, **CPU}, model=p1),
                ref_server.PredictServer({"verbose": -1}, model=p1)):
        try:
            out = io.StringIO()
            served = serve_stdio(srv, io.StringIO(script), out) \
                if isinstance(srv, PredictServer) else \
                ref_server.serve_stdio(srv, io.StringIO(script), out)
            outs.append((served, out.getvalue().splitlines()))
        finally:
            srv.close()
    (n_port, port), (n_ref, ref) = outs
    assert n_port == n_ref == 11
    for i, (a, r) in enumerate(zip(port, ref)):
        if "\t" in r:
            (va, xa), (vr, xr) = a.split("\t"), r.split("\t")
            assert va == vr, i
            np.testing.assert_allclose(float(xa), float(xr), rtol=RTOL)
        elif r.startswith("{"):
            assert a.startswith("{") and ('"flushes"' in a) == \
                ('"flushes"' in r)
        elif i in (6, 7, 8):
            # the online trainer's commands with no trainer attached: the
            # reference's errors word for word
            assert r.startswith("error:") and a == r, (a, r)
        else:
            assert a.split(":")[0] == r.split(":")[0], (i, a, r)
    v1, s1 = port[0].split("\t")
    v2, s2 = port[2].split("\t")
    assert (v1, v2, port[1]) == ("1", "2", "ok version=2")
    assert np.float64(s1) == b1.predict(queries[:1])[0]
    assert np.float64(s2) == b2.predict(queries[:1])[0]


def test_tcp_transport(boosters, queries):
    b1, _ = boosters
    srv = _mk_server(b1)
    ready = threading.Event()
    th = threading.Thread(target=serve_tcp, args=(srv, "127.0.0.1", 0, ready),
                          daemon=True)
    th.start()
    assert ready.wait(10)
    host, port = ready.addr
    try:
        want = b1.predict(queries[:4])

        def client(i, out):
            with socket.create_connection((host, port), timeout=10) as s:
                f = s.makefile("rw")
                f.write(",".join("%.17g" % v for v in queries[i]) + "\n")
                f.flush()
                out[i] = f.readline().strip()

        outs = {}
        ths = [threading.Thread(target=client, args=(i, outs))
               for i in range(4)]
        [t.start() for t in ths]
        [t.join() for t in ths]
        for i in range(4):
            ver, val = outs[i].split("\t")
            assert int(ver) == 1 and np.float64(val) == want[i], i
    finally:
        with socket.create_connection((host, port), timeout=10) as s:
            s.sendall(b"!quit\n")
        th.join(10)
        srv.close()
        assert not th.is_alive()


# ---- the C API ----

def test_capi_server_roundtrip(boosters, queries, tmp_path):
    from lightgbm_tpu_torch import capi_impl as C
    b1, b2 = boosters
    p1, p2 = str(tmp_path / "v1.txt"), str(tmp_path / "v2.txt")
    b1.save_model(p1)
    b2.save_model(p2)
    srv = C.server_create(p1, "verbosity=-1 serve_max_batch_rows=64 "
                              "device_type=cpu")
    try:
        x = np.ascontiguousarray(queries[:3], dtype=np.float64)
        out = np.zeros(3, dtype=np.float64)
        n = C.server_predict(srv, x.ctypes.data, 3, N_FEAT, 0, 0,
                             out.ctypes.data, out.size)
        assert n == 3 and np.array_equal(out, b1.predict(queries[:3]))
        assert C.server_predict(srv, x.ctypes.data, 3, N_FEAT, 0, 0,
                                out.ctypes.data, 1) == -1   # cap too small
        assert C.server_publish(srv, p2) == 2
        n = C.server_predict(srv, x.ctypes.data, 3, N_FEAT, 0, 0,
                             out.ctypes.data, out.size)
        assert n == 3 and np.array_equal(out, b2.predict(queries[:3]))
        assert '"version": 2' in C.server_stats_json(srv)
    finally:
        assert C.server_close(srv) == 0
    with pytest.raises(FileNotFoundError, match="no_such"):
        C.server_create(str(tmp_path / "no_such.txt"), "device_type=cpu")


_C_HOST = r"""
#include <stdio.h>
#include <stdlib.h>
int LGBMTPU_ServerCreate(const char*, const char*, void**);
int LGBMTPU_ServerPredict(void*, const double*, long long, int, int, int,
                          double*, long long, long long*);
int LGBMTPU_ServerPublish(void*, const char*, int*);
int LGBMTPU_ServerStatsJSON(void*, char*, long long, long long*);
int LGBMTPU_ServerClose(void*);
const char* LGBMTPU_GetLastError(void);
int main(int argc, char** argv) {
  FILE* f = fopen(argv[3], "rb");
  double x[3 * 8];
  if (fread(x, sizeof(double), 24, f) != 24) return 2;
  fclose(f);
  void* s = 0;
  if (LGBMTPU_ServerCreate(argv[1], "device_type=cpu verbosity=-1", &s)) {
    fprintf(stderr, "%s\n", LGBMTPU_GetLastError());
    return 1;
  }
  double out[3];
  long long n = 0;
  int v = 0;
  for (int round = 0; round < 2; ++round) {
    if (LGBMTPU_ServerPredict(s, x, 3, 8, 0, 0, out, 3, &n)) return 3;
    for (int i = 0; i < n; ++i) printf("%.17g\n", out[i]);
    if (round == 0 && LGBMTPU_ServerPublish(s, argv[2], &v)) return 4;
    if (round == 0) printf("version %d\n", v);
  }
  char small[4];
  if (LGBMTPU_ServerStatsJSON(s, small, 4, &n) != -1) return 5;
  char* buf = (char*)malloc(n + 1);
  if (LGBMTPU_ServerStatsJSON(s, buf, n + 1, &n)) return 6;
  printf("stats %lld\n", n);
  free(buf);
  if (LGBMTPU_ServerClose(s)) return 7;
  if (LGBMTPU_ServerCreate("no_such_model.txt", "", &s) != -1) return 8;
  printf("%s\n", LGBMTPU_GetLastError());
  return 0;
}
"""


def test_c_host_server_roundtrip(boosters, queries, tmp_path):
    """A pure-C host starts a server on a model file, predicts 3 rows,
    hot-swaps to a second model, predicts again ("%.17g" equal to each
    model's Booster.predict), reads the stats JSON (a buffer too small is
    an error that reports the length) and closes it."""
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no g++/gcc to build the C ABI and its C host")
    if not os.path.exists(os.path.join(sysconfig.get_path("include"),
                                       "Python.h")):
        pytest.skip("no Python.h to build the C ABI against")
    from lightgbm_tpu_torch.native.build_capi import build_capi
    so = build_capi()
    b1, b2 = boosters
    p1, p2 = str(tmp_path / "v1.txt"), str(tmp_path / "v2.txt")
    b1.save_model(p1)
    b2.save_model(p2)
    x = np.ascontiguousarray(queries[:3], dtype=np.float64)
    x.tofile(str(tmp_path / "x.bin"))
    src = tmp_path / "host.c"
    src.write_text(_C_HOST)
    host = str(tmp_path / "host")
    subprocess.run(["gcc", str(src), so, "-o", host,
                    f"-Wl,-rpath,{os.path.dirname(so)}"], check=True,
                   capture_output=True, timeout=120)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in sys.path
                                                    if p]))
    r = subprocess.run([host, p1, p2, str(tmp_path / "x.bin")],
                       capture_output=True, timeout=300, env=env,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    lines = r.stdout.decode().splitlines()
    got1 = np.array([float(v) for v in lines[0:3]])
    got2 = np.array([float(v) for v in lines[4:7]])
    assert lines[3] == "version 2"
    assert np.array_equal(got1, b1.predict(x))
    assert np.array_equal(got2, b2.predict(x))
    assert lines[7].startswith("stats ") and int(lines[7].split()[1]) > 10
    assert "no_such_model" in lines[8]


# ---- every boosting type serves ----

_BOOSTING_PARAMS = {
    "gbdt": {},
    "dart": {"drop_rate": 0.5, "max_drop": 3},
    "goss": {"top_rate": 0.3, "other_rate": 0.2},
    "rf": {"bagging_freq": 1, "bagging_fraction": 0.7},
}


@pytest.mark.parametrize("boosting", sorted(_BOOSTING_PARAMS))
def test_boosting_types_round_trip_serving(boosting, queries, tmp_path):
    """GBDT, DART, GOSS and RF serve bit for bit through the registry and
    the engine, in session and from the saved file (DART's rescaled leaves
    and RF's average output survive the publish path)."""
    X = np.random.RandomState(5).rand(400, N_FEAT)
    y = (X[:, 0] + X[:, 1] > 1).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, "boosting": boosting, **CPU,
              **_BOOSTING_PARAMS[boosting]}
    b = lt.train(params, lt.Dataset(X, label=y, params=params),
                 num_boost_round=6)
    want = {False: b.predict(queries), True: b.predict(queries,
                                                       raw_score=True)}
    assert np.array_equal(want[True], _plain(b, queries, True))
    path = str(tmp_path / f"{boosting}.txt")
    b.save_model(path)
    loaded = lt.Booster(model_file=path, params=CPU)
    for raw in (False, True):
        assert np.array_equal(loaded.predict(queries, raw_score=raw),
                              want[raw]), (boosting, "loaded", raw)
    srv = _mk_server(b)
    try:
        for raw in (False, True):
            assert np.array_equal(srv.predict(queries, raw_score=raw),
                                  want[raw]), (boosting, "served", raw)
        assert srv.publish(path) == 2
        for raw in (False, True):
            assert np.array_equal(srv.predict(queries, raw_score=raw),
                                  want[raw]), (boosting, "served-v2", raw)
        assert np.array_equal(srv.predict(queries[:5], pred_leaf=True),
                              b.predict(queries[:5], pred_leaf=True))
    finally:
        srv.close()
