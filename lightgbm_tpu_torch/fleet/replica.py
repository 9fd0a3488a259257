"""ReplicaPool: N serving replicas behind a least-outstanding balancer.

Port of ``lightgbm_tpu/fleet/replica.py`` (host code, copied and adapted:
a replica's placement is an explicit ``torch.device`` instead of a jax
device).

Two replica flavors, one pool interface:

- :class:`Replica` — **in-process engine replica**: its own ModelRegistry +
  MicroBatcher (server.py), device tables placed on its own
  ``torch.device``: ``cuda:i mod device_count``, so on a one-card host
  every replica shares the card and on a multi-card host they spread over
  the cards; the CPU when the parameters ask for it. On the CPU the
  replicas bound capacity via ``serve_flush_interval_us`` pacing.
- :class:`WorkerReplica` — **worker process** speaking the newline protocol
  (``python -m lightgbm_tpu_torch.fleet.worker``), bound with SO_REUSEPORT
  so any
  number of workers share one public port and the kernel spreads raw client
  connections; the pool additionally keeps a private routed connection per
  worker plus a ``/healthz`` probe against the worker's obs endpoint.

The balancer is deliberately tiny: pick the healthy replica with the fewest
outstanding requests (ties -> lowest id). Outstanding counts are maintained
by the pool itself (bump at route, drop via the request's completion
callback), so they track *in-flight* work, not queue snapshots. A
background probe loop re-checks health every ``fleet_health_s`` and emits a
``replica_health`` event on every transition; an unhealthy replica is
routed around until it probes clean again. All waiting in the probe loop
happens on the stop event, bounded and interruptible.
"""
from __future__ import annotations

import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import log, obs
from ..log import LightGBMError


def replica_devices(n: int, conf) -> List[torch.device]:
    """Device of each of ``n`` in-process replicas: ``cuda:i mod
    device_count`` (several replicas share a card; a multi-card host
    spreads them), or the CPU when the parameters ask for it
    (``device_type=cpu``). Nothing drops to the CPU on its own."""
    from ..basic import resolve_device
    base = resolve_device(conf)
    if base.type != "cuda":
        return [base] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


class Replica:
    """One in-process serving replica: registry + microbatcher + device."""

    def __init__(self, rid: int, conf, device: torch.device,
                 admission=None):
        from ..server import MicroBatcher, ModelRegistry
        self.rid = int(rid)
        self.device = device
        self.registry = ModelRegistry(device=device)
        self.batcher = MicroBatcher(
            self.registry,
            batch_window_us=conf.serve_batch_window_us,
            queue_max=conf.serve_queue_max,
            max_batch_rows=conf.serve_max_batch_rows,
            trace=conf.serve_trace,
            trace_sample=conf.serve_trace_sample,
            flush_interval_us=conf.serve_flush_interval_us,
            admission=admission)
        self.healthy = True
        self.outstanding = 0
        self.routed = 0

    def publish(self, booster, name: str, warmup_sizes=(1,)) -> int:
        sm = self.registry.publish(name, booster, warmup_sizes=warmup_sizes)
        return sm.version

    def submit_async(self, x, **kw):
        return self.batcher.submit_async(x, **kw)

    def probe(self) -> bool:
        """Liveness: the scheduler thread must be running."""
        th = self.batcher._thread
        return th is not None and th.is_alive()

    def stats(self) -> Dict:
        return {"id": self.rid, "kind": "inproc", "healthy": self.healthy,
                "outstanding": self.outstanding, "routed": self.routed,
                "device": str(self.device),
                "scheduler": self.batcher.snapshot(),
                "models": self.registry.models()}

    def close(self) -> None:
        self.batcher.close()


class WorkerReplica:
    """One SO_REUSEPORT worker process + the pool's routed connection to it.

    The worker prints ``FLEET_WORKER_READY port=<p> ctl_port=<c>
    obs_port=<q> pid=<pid>`` once serving; the pool probes
    ``http://127.0.0.1:<q>/healthz`` and routes protocol lines over a
    private connection to ``ctl_port`` (serialized per worker — coalescing
    happens inside the worker across kernel-balanced direct connections on
    the shared data port, which cannot address a specific worker)."""

    START_TIMEOUT_S = 120.0

    def __init__(self, rid: int, model_path: str, port: int,
                 params: Sequence[str] = ()):
        self.rid = int(rid)
        self.healthy = False
        self.outstanding = 0
        self.routed = 0
        cmd = [sys.executable, "-m", "lightgbm_tpu_torch.fleet.worker",
               model_path, str(int(port))] + list(params)
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, text=True)
        self.port, self.ctl_port, self.obs_port, self.pid = \
            self._wait_ready()
        # the routed control connection targets the worker's PRIVATE port:
        # connections to the shared SO_REUSEPORT data port are balanced by
        # the kernel across all workers, so they cannot address one worker
        self._sock = socket.create_connection(("127.0.0.1", self.ctl_port),
                                              timeout=30.0)
        self._rfile = self._sock.makefile("r")
        self._io_lock = threading.Lock()
        self.healthy = True

    def _wait_ready(self) -> Tuple[int, int, int]:
        deadline = time.monotonic() + self.START_TIMEOUT_S
        out = self._proc.stdout
        while time.monotonic() < deadline:
            line = out.readline()
            if not line:
                raise LightGBMError(
                    f"fleet worker {self.rid} exited before ready "
                    f"(rc={self._proc.poll()})")
            if line.startswith("FLEET_WORKER_READY"):
                kv = dict(p.split("=", 1) for p in line.split()[1:])
                return (int(kv["port"]),
                        int(kv.get("ctl_port", kv["port"])),
                        int(kv.get("obs_port", 0)),
                        int(kv.get("pid", 0)))
        raise LightGBMError(f"fleet worker {self.rid} not ready within "
                            f"{self.START_TIMEOUT_S}s")

    def request(self, line: str) -> str:
        """One routed protocol line -> one response line."""
        with self._io_lock:
            self._sock.sendall((line.rstrip("\n") + "\n").encode())
            resp = self._rfile.readline()
        if not resp:
            raise LightGBMError(f"fleet worker {self.rid} connection closed")
        return resp.rstrip("\n")

    def predict(self, x) -> Tuple[int, np.ndarray]:
        row = np.asarray(x, dtype=np.float64).reshape(-1)
        resp = self.request(",".join("%.17g" % v for v in row))
        if resp.startswith("error:"):
            raise LightGBMError(resp)
        ver, vals = resp.split("\t", 1)
        return int(ver), np.array([float(v) for v in vals.split(",")])

    def publish(self, model_path: str, name: str = "default") -> int:
        resp = self.request(f"!publish {model_path}")
        if not resp.startswith("ok version="):
            raise LightGBMError(f"worker {self.rid} publish failed: {resp}")
        return int(resp.split("version=", 1)[1].split()[0])

    def probe(self) -> bool:
        if self._proc.poll() is not None:
            return False
        if self.obs_port <= 0:
            return True
        import urllib.request
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.obs_port}/healthz",
                    timeout=2.0) as r:
                return r.status == 200
        except Exception:
            return False

    def stats(self) -> Dict:
        return {"id": self.rid, "kind": "process", "healthy": self.healthy,
                "outstanding": self.outstanding, "routed": self.routed,
                "port": self.port, "ctl_port": self.ctl_port,
                "obs_port": self.obs_port, "pid": self.pid}

    def close(self) -> None:
        try:
            with self._io_lock:
                self._sock.sendall(b"!quit\n")
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._proc.poll() is None:
            try:
                self._proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                self._proc.terminate()
                self._proc.wait(timeout=5.0)


class ReplicaPool:
    """N replicas + least-outstanding routing + background health probes."""

    def __init__(self, conf, admission=None, model=None,
                 name: str = "default", start_probe: bool = True):
        self.conf = conf
        self.name = name
        self.mode = getattr(conf, "fleet_mode", "inproc")
        n = max(int(getattr(conf, "fleet_replicas", 1)), 1)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self.stats_counters = {"routed": 0, "probe_rounds": 0,
                               "health_flips": 0}
        if self.mode == "process":
            if not isinstance(model, str):
                raise ValueError("process-mode fleet needs a model file path")
            port = int(getattr(conf, "fleet_worker_port", 0)) or \
                _free_reuseport()
            params = _worker_params(conf)
            self.replicas: List = [WorkerReplica(i, model, port, params)
                                   for i in range(n)]
            self.public_port = port
        else:
            devices = replica_devices(n, conf)
            self.replicas = [Replica(i, conf, device=devices[i],
                                     admission=admission)
                             for i in range(n)]
            self.public_port = 0
        interval = float(getattr(conf, "fleet_health_s", 2.0))
        if start_probe and interval > 0:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, args=(interval,),
                name="lgbm-fleet-probe", daemon=True)
            self._probe_thread.start()

    def __len__(self) -> int:
        return len(self.replicas)

    # ---- routing ----

    def pick(self):
        """Healthy replica with the fewest outstanding requests (fail-open
        to the full set when every probe is red, so a flapping prober can
        not take the whole fleet dark)."""
        with self._lock:
            live = [r for r in self.replicas if r.healthy] or self.replicas
            r = min(live, key=lambda r: (r.outstanding, r.rid))
            r.outstanding += 1
            r.routed += 1
            self.stats_counters["routed"] += 1
            return r

    def _done(self, replica) -> None:
        with self._lock:
            replica.outstanding = max(replica.outstanding - 1, 0)

    def submit_async(self, x, on_done=None, **kw):
        """Route one request (in-process pools): returns the _Request."""
        r = self.pick()

        def _release(req, _r=r, _cb=on_done):
            self._done(_r)
            if _cb is not None:
                _cb(req)

        try:
            return r.submit_async(x, on_done=_release, **kw)
        except BaseException:
            self._done(r)
            raise

    def predict_versioned(self, x, model: str = "default",
                          timeout: Optional[float] = None):
        if self.mode == "process":
            r = self.pick()
            try:
                ver, out = r.predict(x)
            finally:
                self._done(r)
            return out, ver
        req = self.submit_async(x, model=model)
        out = req.result(timeout)
        return out, req.version

    # ---- publish fan-out ----

    def publish_all(self, model, name: Optional[str] = None,
                    warmup_sizes=(1,), path: Optional[str] = None) -> int:
        """Publish one artifact to every replica; returns the (common)
        version. In-process replicas each build+warm their own engine from
        the shared Booster; workers re-read the shared artifact path."""
        name = name or self.name
        t0 = time.perf_counter()
        if self.mode == "process":
            if path is None:
                raise ValueError("process-mode publish needs the artifact "
                                 "path every worker can read")
            version = 0
            for r in self.replicas:
                version = r.publish(path, name)
        else:
            from ..basic import Booster
            if isinstance(model, (str, bytes)):
                model = Booster(model_file=model)
            version = 0
            for r in self.replicas:
                version = r.publish(model, name, warmup_sizes=warmup_sizes)
        obs.emit("fleet_publish", model=name, version=int(version),
                 replicas=len(self.replicas),
                 duration_s=time.perf_counter() - t0)
        return int(version)

    # ---- health ----

    def _probe_loop(self, interval: float) -> None:
        """Background health prober. The only wait is on the stop event,
        bounded and interruptible — the scheduler-loop discipline."""
        while not self._stop.wait(interval):
            self.check_health()

    def check_health(self) -> int:
        """Probe every replica once; returns the healthy count. Emits a
        ``replica_health`` event on every transition."""
        flips = []
        healthy = 0
        for r in self.replicas:
            try:
                ok = bool(r.probe())
                err = ""
            except Exception as e:
                ok, err = False, f"{type(e).__name__}: {e}"
            healthy += int(ok)
            if ok != r.healthy:
                with self._lock:
                    r.healthy = ok
                    self.stats_counters["health_flips"] += 1
                flips.append((r.rid, ok, err))
        with self._lock:
            self.stats_counters["probe_rounds"] += 1
        for rid, ok, err in flips:
            log.warning(f"fleet replica {rid} "
                        f"{'recovered' if ok else 'unhealthy'} {err}")
            obs.emit("replica_health", replica=str(rid), healthy=ok,
                     replicas=len(self.replicas), error=err)
        if obs.enabled():
            obs.METRICS.gauge("fleet_healthy_replicas",
                              "replicas passing the health probe").set(healthy)
        return healthy

    # ---- introspection / lifecycle ----

    def snapshot(self) -> Dict:
        with self._lock:
            counters = dict(self.stats_counters)
        return {"mode": self.mode, "replicas": [r.stats()
                                                for r in self.replicas],
                "public_port": self.public_port, **counters}

    def close(self) -> None:
        self._stop.set()
        th = self._probe_thread
        if th is not None and th.is_alive():
            th.join(timeout=5.0)
        for r in self.replicas:
            try:
                r.close()
            except Exception as e:
                log.warning(f"fleet replica {r.rid} close failed "
                            f"({type(e).__name__}: {e})")


def _free_reuseport() -> int:
    """Pick a port that can be bound with SO_REUSEPORT by every worker."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        if hasattr(socket, "SO_REUSEPORT"):
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _worker_params(conf) -> List[str]:
    """Serve knobs forwarded to worker processes as key=value args."""
    keys = ("serve_batch_window_us", "serve_queue_max",
            "serve_max_batch_rows", "serve_flush_interval_us",
            "serve_slo_ms", "serve_slo_target", "serve_slo_window",
            "telemetry", "device_type")
    out = []
    for k in keys:
        v = getattr(conf, k, None)
        if v is None:
            continue
        if isinstance(v, bool):
            v = int(v)
        out.append(f"{k}={v}")
    return out
