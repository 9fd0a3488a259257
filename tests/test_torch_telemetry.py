"""Telemetry of the PyTorch/CUDA port (lightgbm_tpu_torch/obs, utils/timer.py)
against the JAX reference's (lightgbm_tpu/obs), on the CPU: the repair of
ROADMAP C12 (the telemetry knobs were accepted and read nowhere).

Both packages train the same small models with ``telemetry=true`` and
``metrics_out`` and write events.jsonl, metrics.json and metrics.prom; the
reference trains on its Pallas kernels in interpret mode. The reference's
JAX-only events are filtered from its stream (``compile``: jit cache
growth), with the metric families only they feed. The training streams
also leave the cold start aside (``aot_prewarm``, ``ingest_chunk``): the
port streams a valid set through its ingest pipeline where the reference
bins it on the host; tests/test_torch_ingest.py compares the cold-start
events of one construct. The serving streams (a publish, flushes, a shed,
a canary and its rollback) are compared event for event. Then the event
types come in the
same order, each event has the same field names, and ``iteration``,
``path`` (relative to its run's snapshot directory), ``point``, ``policy``
and ``where`` have the same values; timings are left aside. One
difference is by design: the reference reads a train_iter's tree stats
(``leaf_count``, ``best_gain``, ``lagged_iteration``) from a queue 8
iterations deep, so its first 8 iterations carry none, while the port's
level loop syncs every level and gives each iteration its own
(``lagged_iteration == iteration``); those three fields are compared
apart. Telemetry changes no model, byte for byte (L2 models: ROADMAP C10
makes a first logloss model of a process differ by an ulp on the CPU).
"""
import ast
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import obs as ref_obs
from lightgbm_tpu.utils import faults as ref_faults
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import app, obs
from lightgbm_tpu_torch.obs import events as obs_events
from lightgbm_tpu_torch.obs import http_server, memory, tracing
from lightgbm_tpu_torch.obs.metrics import parse_prometheus
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.timer import TIMER, time_op, timed

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS = {"histogram_impl": "pallas", "use_quantized_grad": "true",
          "prewarm": 0}
CPU = {"device_type": "cpu"}
BASE = {"objective": "binary", "num_leaves": 4, "verbosity": -1}
# the reference's events and metric families that the port does not emit,
# and the cold start, which the training streams leave aside
JAX_ONLY_EVENTS = ("compile", "aot_prewarm", "ingest_chunk")
JAX_ONLY_FAMILIES = ("jit_compiles", "jit_retraces", "ingest_chunks",
                     "ingest_pipeline_depth")
LAGGED = ("leaf_count", "best_gain", "lagged_iteration")
COMPARED = ("iteration", "path", "point", "policy", "where")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """The telemetry singletons are process-wide: isolate every test."""
    monkeypatch.delenv("LGBMTPU_TELEMETRY", raising=False)
    for o in (obs, ref_obs):
        o.reset()
        o.configure(enabled=False, metrics_out="")
    faults.reset()
    ref_faults.reset()
    yield
    for o in (obs, ref_obs):
        o.reset()
        o.configure(enabled=False, metrics_out="")
    faults.reset()
    ref_faults.reset()


def _data(n=500, f=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.rand(n) > 0.65).astype(np.float32)
    return X, y


def _read(d):
    with open(os.path.join(d, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    with open(os.path.join(d, "metrics.json")) as fh:
        metrics = json.load(fh)
    with open(os.path.join(d, "metrics.prom")) as fh:
        prom = fh.read()
    return events, metrics, prom


def _run_both(tmp_path, params, rounds, run, X=None, y=None):
    """``run(pkg, params, X, y)`` in each package with its telemetry
    written to its own directory; returns [(events, metrics, prom, dir)]
    for the reference and the port."""
    if X is None:
        X, y = _data()
    out = []
    for pkg, extra in ((lgb, PALLAS), (lt, CPU)):
        d = str(tmp_path / pkg.__name__)
        p = {**params, **extra, "telemetry": True, "metrics_out": d}
        run(pkg, p, X, y, rounds)
        out.append((*_read(d), d))
    return out


def _train(pkg, p, X, y, rounds):
    pkg.train(p, pkg.Dataset(X, label=y, params=p), rounds)


def _comparable(events, root):
    """(type, field names, compared values) of each event; the reference's
    JAX-only events dropped, the tree stats set aside, paths relative to
    their run's snapshot directory."""
    out = []
    for e in events:
        if e["type"] in JAX_ONLY_EVENTS:
            continue
        names = sorted(k for k in e if k not in ("ts", "type") + LAGGED)
        vals = {k: e[k] for k in COMPARED if k in e}
        if "path" in vals:
            vals["path"] = os.path.relpath(vals["path"], root)
        out.append((e["type"], names, vals))
    return out


def _families(metrics):
    return sorted(k for k in metrics if k not in JAX_ONLY_FAMILIES)


def _assert_same_stream(pair, root_of=lambda d: d):
    (ref_ev, ref_m, _, ref_d), (port_ev, port_m, port_prom, port_d) = pair
    assert _comparable(port_ev, root_of(port_d)) == \
        _comparable(ref_ev, root_of(ref_d))
    # the port also times the phases of its boosting iteration into
    # span_seconds (obs/tracing.py), where the reference's training opens
    # no span: that family is the port's own in a training stream
    spans = set(port_m.get("span_seconds", {}).get("series", {}))
    if any(e["type"] == "train_iter" for e in port_ev):
        assert {'{span="grow.tree"}', '{span="sync.finite"}'} <= spans
        if "span_seconds" not in ref_m:
            port_m = {k: v for k, v in port_m.items() if k != "span_seconds"}
    assert _families(port_m) == _families(ref_m)
    parse_prometheus(port_prom)
    for e in port_ev:      # the port's own tree stats: this iteration's
        if e["type"] == "train_iter":
            obs_events._validate("train_iter", {k: v for k, v in e.items()
                                                if k not in ("ts", "type")})
    return [e for e in port_ev if e["type"] == "train_iter"]


def _assert_own_stats(train_iters):
    for e in train_iters:
        assert e["lagged_iteration"] == e["iteration"]
        assert e["leaf_count"] >= 1 and e["best_gain"] >= 0


def test_event_stream_matches_reference(tmp_path):
    """500 x 4 rows, binary, 2 rounds: the same filtered event stream
    (hist_pack_fallback, then one train_iter an iteration), field names and
    metric families; metrics.prom parses."""
    pair = _run_both(tmp_path, BASE, 2, _train)
    _assert_own_stats(_assert_same_stream(pair))
    types = [e["type"] for e in pair[1][0]]
    assert types.count("train_iter") == 2
    m = pair[1][1]
    assert m["train_iterations"]["series"]["{}"] == 2
    assert {'{phase="boosting"}', '{phase="dataset_construct"}'} <= \
        set(m["phase_seconds"]["series"])


def test_kill_snapshot_and_resume_stream_matches_reference(tmp_path):
    """snapshot_freq=1, killed by tree_update@2 and resumed to 4 rounds,
    both runs with telemetry: snapshot_write at 1 and 2, fault_injected at
    tree_update, resume at 2, a train_iter for each iteration run; the
    snapshot paths relative to each package's snapshot directory."""
    def run(pkg, p, X, y, rounds):
        snaps = os.path.join(p["metrics_out"], "snaps")
        q = {**p, "objective": "regression", "snapshot_freq": 1,
             "snapshot_dir": snaps}
        with pytest.raises(Exception) as ei:
            pkg.train({**q, "faults": "tree_update@2"},
                      pkg.Dataset(X, label=y, params=q), rounds)
        assert "tree_update" in str(ei.value)
        (faults if pkg is lt else ref_faults).reset()
        pkg.train(q, pkg.Dataset(X, label=y, params=q), rounds,
                  resume_from_snapshot=snaps)
    pair = _run_both(tmp_path, BASE, 4, run)
    _assert_own_stats(_assert_same_stream(
        pair, lambda d: os.path.join(d, "snaps")))
    types = [e["type"] for e in pair[1][0]]
    for t in ("snapshot_write", "fault_injected", "resume"):
        assert t in types, t
    assert types.count("train_iter") == 4
    assert [e["iteration"] for e in pair[1][0]
            if e["type"] == "resume"] == [2]
    assert pair[1][1]["snapshot_writes"]["series"]["{}"] == 2 + 2


def test_snapshot_retry_stream_matches_reference(tmp_path):
    """A snapshot write failing once (faults=snapshot_write:1) and retried:
    fault_injected at snapshot_write, then dist_retry (its name and
    attempt), then snapshot_write, as in the reference."""
    def run(pkg, p, X, y, rounds):
        q = {**p, "objective": "regression", "snapshot_freq": 1,
             "snapshot_dir": os.path.join(p["metrics_out"], "snaps"),
             "faults": "snapshot_write:1"}
        pkg.train(q, pkg.Dataset(X, label=y, params=q), rounds)
    pair = _run_both(tmp_path, BASE, 2, run)
    _assert_own_stats(_assert_same_stream(
        pair, lambda d: os.path.join(d, "snaps")))
    ev = pair[1][0]
    types = [e["type"] for e in ev]
    assert types[types.index("fault_injected"):][:3] == [
        "fault_injected", "dist_retry", "snapshot_write"]
    retry = next(e for e in ev if e["type"] == "dist_retry")
    ref_retry = next(e for e in pair[0][0] if e["type"] == "dist_retry")
    assert (retry["name"], retry["attempt"]) == (ref_retry["name"],
                                                 ref_retry["attempt"])


def test_nonfinite_guard_stream_matches_reference(tmp_path):
    """L2 on labels near 1e38 at learning_rate 1e38 under warn_skip_tree
    (ROADMAP C9's overflow): a nonfinite_guard event (where train_score,
    its policy and iteration) for each skipped iteration, as the
    reference's. The flight recorder is off (flight_events=0): its dumps
    are debounced by the clock."""
    X, _ = _data()
    y = 1e38 + 1e37 * np.random.RandomState(1).rand(len(X))
    p = {**BASE, "objective": "regression", "learning_rate": 1e38,
         "nonfinite_policy": "warn_skip_tree", "flight_events": 0}
    pair = _run_both(tmp_path, p, 2, _train, X, y)
    # every iteration skipped: no tree, so no tree stats
    assert all("leaf_count" not in e for e in _assert_same_stream(pair))
    guards = [e for e in pair[1][0] if e["type"] == "nonfinite_guard"]
    assert guards and all(e["action"] == "skip_tree" for e in guards)


def test_nonfinite_guard_trips_the_flight_recorder(tmp_path):
    """A nonfinite_guard event dumps the flight ring into metrics_out
    (flight_dir falls back to it) with the event in it."""
    X, _ = _data()
    y = 1e38 + 1e37 * np.random.RandomState(1).rand(len(X))
    d = str(tmp_path)
    p = {**BASE, **CPU, "objective": "regression", "learning_rate": 1e38,
         "nonfinite_policy": "warn_skip_tree", "telemetry": True,
         "metrics_out": d}
    lt.train(p, lt.Dataset(X, label=y, params=p), 1)
    dumps = [f for f in os.listdir(d) if f.startswith("flight_")]
    assert dumps
    with open(os.path.join(d, dumps[0])) as fh:
        doc = json.load(fh)
    assert doc["reason"] == "nonfinite_guard"
    assert any(r.get("type") == "nonfinite_guard" for r in doc["records"])


def test_cli_train_exports_telemetry_as_reference(tmp_path):
    """task=train with metrics_out through the command line: the same
    filtered event stream and metric families as the reference's CLI."""
    X, y = _data()
    data = tmp_path / "train.tsv"
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t", fmt="%.9g")
    out = []
    for pkg_app, extra in ((None, PALLAS), (app, CPU)):
        d = tmp_path / ("port" if pkg_app else "ref")
        argv = [f"data={data}", "task=train", "objective=binary",
                "num_iterations=2", "num_leaves=4", "verbosity=-1",
                "telemetry=true", f"metrics_out={d}",
                f"output_model={d / 'model.txt'}"]
        argv += [f"{k}={v}" for k, v in extra.items()]
        if pkg_app is None:
            from lightgbm_tpu import app as ref_app
            ref_app.main(argv)
        else:
            pkg_app.main(argv)
        out.append((*_read(str(d)), str(d)))
    _assert_own_stats(_assert_same_stream(out))
    assert (tmp_path / "port" / "model.txt").exists()


def test_cli_predict_exports_telemetry(tmp_path):
    X, y = _data()
    data = tmp_path / "rows.tsv"
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t", fmt="%.9g")
    p = {**BASE, **CPU}
    model = tmp_path / "model.txt"
    lt.train(p, lt.Dataset(X, label=y, params=p), 2).save_model(str(model))
    d = tmp_path / "tele"
    app.main([f"data={data}", "task=predict", f"input_model={model}",
              f"output_result={tmp_path / 'pred.txt'}", "telemetry=true",
              f"metrics_out={d}", "device_type=cpu"])
    events, metrics, prom = _read(str(d))
    assert "events_buffered" in metrics
    parse_prometheus(prom)


def test_telemetry_changes_no_model_and_traces_boosting(tmp_path):
    """With telemetry on and xla_trace_out set, the model text equals the
    one with telemetry off byte for byte, and the trace directory holds a
    Chrome trace with the boosting range of every iteration."""
    X, y = _data(300, 4, 3)
    p = {**BASE, **CPU, "objective": "regression"}
    off = lt.train(p, lt.Dataset(X, label=y, params=p), 2)
    tdir = str(tmp_path / "trace")
    q = {**p, "telemetry": True, "metrics_out": str(tmp_path / "m"),
         "xla_trace_out": tdir}
    on = lt.train(q, lt.Dataset(X, label=y, params=q), 2)
    strip = [s.split("\nparameters:\n")[0]
             for s in (off.model_to_string(), on.model_to_string())]
    assert strip[0] == strip[1]
    files = [f for f in os.listdir(tdir) if f.endswith(".json")]
    assert len(files) == 1
    assert tracing.LAST_TRACE["path"] == os.path.join(tdir, files[0])
    with open(os.path.join(tdir, files[0])) as fh:
        trace = json.load(fh)
    ranges = [e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"]
    assert [e["name"] for e in ranges].count("boosting") == 2
    # no capture runs after the loop
    assert tracing.stop_xla_trace() is None


def test_schema_equals_reference_and_every_emit_is_registered():
    """The port's EVENT_SCHEMAS equals the reference's; every obs.emit call
    in lightgbm_tpu_torch/ with a literal type names a registered type and
    only its registered fields, with every required one (the port's
    counterpart of scripts/check_telemetry_schema.py), and emit(...) in
    obs/ itself."""
    from lightgbm_tpu.obs.events import EVENT_SCHEMAS as REF
    assert obs.EVENT_SCHEMAS == REF
    calls = 0
    root = os.path.join(REPO, "lightgbm_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), filename=path)
            for node in ast.walk(tree):
                # obs.emit(...), or emit(...) inside obs/ itself
                if not (isinstance(node, ast.Call) and (
                        (isinstance(node.func, ast.Attribute)
                         and node.func.attr == "emit"
                         and isinstance(node.func.value, ast.Name)
                         and node.func.value.id == "obs")
                        or (isinstance(node.func, ast.Name)
                            and node.func.id == "emit"
                            and os.path.basename(dirpath) == "obs"))):
                    continue
                arg = node.args[0] if node.args else None
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    continue
                calls += 1
                where = f"{path}:{node.lineno}"
                assert arg.value in REF, where
                required, optional = REF[arg.value]
                kws = {k.arg for k in node.keywords}
                if None in kws:      # **fields: checked when emitted
                    continue
                assert kws <= set(required) | set(optional), where
                assert set(required) <= kws, where
    assert calls >= 15


def test_off_by_default_records_and_writes_nothing(tmp_path):
    """With no knob and no environment variable, emit records nothing and
    a run with metrics_out but without telemetry writes no file."""
    assert not obs.enabled()
    obs.emit("train_iter", iteration=1, duration_s=0.1, rows_per_s=1.0)
    assert len(obs.EVENTS) == 0
    X, y = _data()
    p = {**BASE, **CPU, "metrics_out": str(tmp_path)}
    lt.train(p, lt.Dataset(X, label=y, params=p), 2)
    assert len(obs.EVENTS) == 0 and os.listdir(tmp_path) == []
    assert obs.export_all(str(tmp_path)) is None


def test_environment_variable_overrides_the_param(monkeypatch, tmp_path):
    X, y = _data()
    monkeypatch.setenv("LGBMTPU_TELEMETRY", "1")
    p = {**BASE, **CPU, "metrics_out": str(tmp_path)}
    lt.train(p, lt.Dataset(X, label=y, params=p), 1)
    assert os.path.exists(tmp_path / "events.jsonl")
    monkeypatch.setenv("LGBMTPU_TELEMETRY", "0")
    obs.reset()
    lt.train({**p, "telemetry": True, "metrics_out": str(tmp_path / "b")},
             lt.Dataset(X, label=y, params=p), 1)
    assert not os.path.exists(tmp_path / "b")


def test_emit_validates_schema_and_log_is_bounded():
    obs.configure(enabled=True)
    with pytest.raises(ValueError, match="unregistered event type"):
        obs.emit("no_such_event", x=1)
    with pytest.raises(ValueError, match="missing required field"):
        obs.emit("train_iter", iteration=1)
    with pytest.raises(ValueError, match="unregistered field"):
        obs.emit("resume", iteration=1, path="p", bogus=2)
    with pytest.raises(ValueError, match="got bool"):
        obs.emit("train_iter", iteration=True, duration_s=0.1,
                 rows_per_s=1.0)
    log = obs_events.EventLog(capacity=4)
    for i in range(7):
        log.emit("resume", iteration=i, path=f"p{i}")
    assert log.dropped == 3
    assert [r["iteration"] for r in log.snapshot()] == [3, 4, 5, 6]


def test_metrics_exposition_parses_and_refuses_bad_lines():
    reg = obs.MetricsRegistry()
    reg.counter("requests", "served requests").inc(3)
    reg.gauge("device_memory_bytes", "stats", device="0",
              stat="peak_bytes_in_use").set(7)
    h = reg.histogram("latency_seconds", "request latency", base=1.0,
                      n_buckets=2)
    for v in (0.5, 1.5, 9.25):
        h.observe(v)
    parsed = parse_prometheus(reg.to_prometheus())
    assert parsed["lgbmtpu_requests_total"] == [("", 3.0)]
    assert [v for _, v in parsed["lgbmtpu_latency_seconds_bucket"]] == \
        [1.0, 2.0, 3.0]
    for bad in ("lgbmtpu_x{a=1} 2", "lgbmtpu x 1", "# NOTE x",
                'lgbmtpu_h_bucket{le="1"} 3\nlgbmtpu_h_bucket{le="2"} 1'):
        with pytest.raises(ValueError):
            parse_prometheus(bad)


def test_obs_server_serves_metrics_health_and_status():
    """ObsServer on an ephemeral port: /metrics (the exposition, parsed),
    /healthz and /statusz, as the reference's tests read them."""
    obs.configure(enabled=True)
    obs.METRICS.counter("train_iterations", "iterations").inc(2)
    http_server.add_status_section("train", lambda: {"iterations": 2})
    srv = http_server.ObsServer(port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            body = r.read().decode()
        assert parse_prometheus(body)["lgbmtpu_train_iterations_total"] \
            == [("", 2.0)]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.read() == b"ok\n"
        with urllib.request.urlopen(base + "/statusz", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["telemetry"]["enabled"] is True
        assert doc["train"] == {"iterations": 2}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        srv.close()
        http_server.remove_status_section("train")
    assert [e["phase"] for e in obs.EVENTS.snapshot()
            if e["type"] == "obs_server"] == ["start", "stop"]
    # obs_port=0 starts nothing
    assert http_server.maybe_start(lt.Config({"obs_port": 0})) is None


def test_periodic_flush_rewrites_the_files(tmp_path):
    obs.configure(enabled=True, metrics_out=str(tmp_path))
    owned = obs.start_periodic_flush(0.05)
    try:
        assert owned and not obs.start_periodic_flush(0.05)
        obs.emit("resume", iteration=1, path="p")
        deadline = 200
        while deadline and not os.path.exists(tmp_path / "events.jsonl"):
            import time
            time.sleep(0.01)
            deadline -= 1
    finally:
        obs.stop_periodic_flush(owned)
    assert os.path.exists(tmp_path / "metrics.prom")


def test_memory_sample_and_timer_on_the_cpu():
    """Without CUDA there is no device-memory reading (the gauges stay
    away); the timer's scopes accumulate, begin_run archives them, and
    time_op times CPU tensors by the host clock."""
    assert memory.sample() == [] and memory.watermark() == {}
    reg = obs.MetricsRegistry()
    assert memory.update_gauges(reg) == [] and reg.to_json() == {}
    TIMER.begin_run()
    x = torch.ones(8)
    with TIMER.scope("unit", block_on=lambda: x * 2):
        pass

    @timed("unit", block=True)
    def f():
        return [x + 1, {"y": x}]
    f()
    assert TIMER.snapshot()["unit"]["count"] == 2
    TIMER.begin_run()
    assert TIMER.last_run["unit"][1] == 2 and TIMER.snapshot() == {}
    assert time_op(torch.add, x, x, reps=3) >= 0.0


def _serve_stream(server_mod, p1, p2, params, X):
    """A publish (warm-up included), three single-row flushes, a shed of a
    stopped one-slot queue, a shadow canary and its rollback."""
    srv = server_mod.PredictServer(params, model=p1)
    try:
        for i in range(3):
            srv.predict(X[i])
        mb = server_mod.MicroBatcher(srv.registry, queue_max=1, start=False)
        mb.submit_async(X[0])
        with pytest.raises(server_mod.ServeOverload):
            mb.submit_async(X[1])
        mb.start()
        mb.close(drain=True)
        ro = srv.ensure_rollout()
        ro.start(p2, shadow=True)
        ro.rollback()
    finally:
        srv.close()


SERVE_COMPARED = ("model", "version", "mode", "reason", "rows", "bucket",
                  "requests", "n_trees", "num_class", "queued", "limit",
                  "chunked")


def test_serving_stream_matches_reference(tmp_path):
    """The same two model files served by both packages: the same serving
    events in the same order (engine_upload, predict_batch, serve_publish,
    serve_flush, serve_shed, canary_start, serve_retire, canary_rollback),
    the same field names and the same versions, models, buckets, rows and
    reasons; the reference's compile events filtered."""
    from lightgbm_tpu import server as ref_server
    from lightgbm_tpu_torch import server
    X, y = _data()
    paths = []
    for rounds in (2, 3):
        p = {**BASE, **CPU}
        path = str(tmp_path / f"m{rounds}.txt")
        lt.train(p, lt.Dataset(X, label=y, params=p), rounds).save_model(path)
        paths.append(path)
    streams = []
    for mod, o, extra in ((ref_server, ref_obs, {}), (server, obs, CPU)):
        o.configure(enabled=True)
        _serve_stream(mod, *paths, {"verbosity": -1,
                                    "serve_max_batch_rows": 8, **extra},
                      X.astype(np.float64))
        streams.append([(e["type"],
                         sorted(k for k in e if k not in ("ts", "type")),
                         {k: e[k] for k in SERVE_COMPARED if k in e})
                        for e in o.EVENTS.snapshot()
                        if e["type"] not in ("compile", "obs_server")])
    ref, mine = streams
    assert mine == ref
    types = [t for t, _, _ in mine]
    for t in ("engine_upload", "predict_batch", "serve_publish",
              "serve_flush", "serve_shed", "canary_start", "serve_retire",
              "canary_rollback"):
        assert t in types, t
    assert types.count("serve_flush") == 4
