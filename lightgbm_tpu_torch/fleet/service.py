"""FleetServer: the multi-replica serving facade (``task=serve`` when
``fleet_replicas > 1``).

Port of ``lightgbm_tpu/fleet/service.py`` (host code, copied and adapted).

Same duck-typed surface the line protocol (server.handle_line) drives on a
single PredictServer — ``predict_versioned`` / ``publish`` / ``stats`` /
``ensure_rollout`` / ``fleet_stats`` — but backed by a
:class:`~.replica.ReplicaPool` behind the least-outstanding balancer, with
one shared :class:`~.store.ArtifactStore` (when ``fleet_store`` is set) so
a publish writes the artifact once and every replica builds from the same
bytes.

Canary/shadow rollout runs at the pool level for in-process fleets: the
candidate is published under the shadow name on EVERY replica, so whichever
replica the balancer picks can serve either side; promote re-homes each
replica's warmed candidate engine in place (no rebuild anywhere). Process
mode (SO_REUSEPORT workers) does not support pool-level rollout — each
worker is a full PredictServer, so drive ``!canary`` against a worker
directly, or use inproc mode.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import Config, params_to_config
from ..log import LightGBMError
from ..obs import http_server as obs_http
from ..obs import slo
from .replica import ReplicaPool
from .store import ArtifactStore


class PoolBackend:
    """RolloutManager backend fanning transitions across an inproc pool."""

    def __init__(self, fleet: "FleetServer"):
        self.fleet = fleet

    def publish_candidate(self, model, cname: str) -> int:
        f = self.fleet
        from ..basic import Booster
        if isinstance(model, (str, bytes)):
            model = Booster(model_file=model)
        path = None
        if f.store is not None:
            _, path = f.store.put(cname, model)
        return f.pool.publish_all(model, name=cname,
                                  warmup_sizes=f._warmup_sizes(), path=path)

    def promote(self, name: str, cname: str) -> int:
        from .rollout import promote_version
        version = 0
        for r in self.fleet.pool.replicas:
            version = promote_version(r.registry, name, cname)
        return version

    def drop(self, cname: str) -> None:
        for r in self.fleet.pool.replicas:
            r.registry.unpublish(cname)

    def submit(self, x, **kw):
        return self.fleet.pool.submit_async(x, **kw)

    def current_version(self, name: str) -> int:
        try:
            return self.fleet.pool.replicas[0].registry.current(name).version
        except KeyError:
            return 0


class FleetServer:
    """ReplicaPool + admission + rollout behind one server-shaped object.

    >>> fs = FleetServer(params, model=booster)   # publish to every replica
    >>> y, v = fs.predict_versioned(x_row)        # balanced + coalesced
    >>> fs.ensure_rollout().start(candidate)      # fleet-wide canary
    >>> fs.close()
    """

    def __init__(self, params=None, model=None, name: str = "default",
                 start: bool = True):
        conf = params if isinstance(params, Config) \
            else params_to_config(params)
        self.conf = conf
        self.name = name
        from .admission import AdmissionController
        self.admission = AdmissionController.from_config(conf)
        self.store = ArtifactStore(conf.fleet_store) \
            if conf.fleet_store else None
        self.online = None   # protocol parity: !learn answers "no trainer"
        self.rollout = None
        model_path: Optional[str] = None
        if conf.fleet_mode == "process":
            # workers load their model at spawn, so resolve a path now:
            # either the caller handed one, or the store writes the artifact
            if isinstance(model, str) and os.path.exists(model):
                model_path = model
            elif model is not None and self.store is not None:
                _, model_path = self.store.put(name, model)
            else:
                raise LightGBMError(
                    "process-mode fleet needs a model file path (or a "
                    "Booster plus fleet_store to write it into)")
        self.pool = ReplicaPool(conf, admission=self.admission,
                                model=model_path, name=name,
                                start_probe=start)
        slo.TRACKER.configure(slo_ms=conf.serve_slo_ms,
                              target=conf.serve_slo_target,
                              window=conf.serve_slo_window)
        self._obs_http = obs_http.maybe_start(conf)
        obs_http.add_status_section("fleet", self.fleet_stats)
        if model is not None and conf.fleet_mode != "process":
            self.publish(model, name=name)

    def _warmup_sizes(self) -> Tuple[int, ...]:
        """1 + every power-of-two bucket up to serve_max_batch_rows (same
        policy as PredictServer: the first flush of any size finds its
        bucket's blocks in each replica's caching allocator)."""
        sizes = [1]
        b = 2
        while b <= self.conf.serve_max_batch_rows:
            sizes.append(b)
            b <<= 1
        return tuple(sizes)

    # ---- publish ----

    def publish(self, model, name: Optional[str] = None) -> int:
        """Publish to every replica; writes the artifact into the shared
        store first when one is configured. Returns the new version."""
        name = name or self.name
        path = model if (isinstance(model, str) and os.path.exists(model)) \
            else None
        if self.store is not None:
            _, path = self.store.put(name, model)
        return self.pool.publish_all(model, name=name,
                                     warmup_sizes=self._warmup_sizes(),
                                     path=path)

    # ---- request path ----

    def submit(self, x, **kw):
        ro = self.rollout
        if ro is not None and ro.active:
            return ro.submit(x, **kw)
        return self.pool.submit_async(x, **kw)

    def predict(self, x, model: str = "default", raw_score: bool = False,
                pred_leaf: bool = False,
                timeout: Optional[float] = None) -> np.ndarray:
        if self.pool.mode == "process":
            out, _ = self.pool.predict_versioned(x, model=model)
            return out
        return self.submit(x, model=model, raw_score=raw_score,
                           pred_leaf=pred_leaf).result(timeout)

    def predict_versioned(self, x, model: str = "default",
                          timeout: Optional[float] = None
                          ) -> Tuple[np.ndarray, int]:
        if self.pool.mode == "process":
            return self.pool.predict_versioned(x, model=model)
        req = self.submit(x, model=model)
        out = req.result(timeout)
        return out, req.version

    # ---- continuous training (protocol parity with PredictServer) ----

    def attach_online(self, trainer) -> None:
        """Attach an OnlineTrainer/OnlineTrainerGroup so the !learn and
        !label protocol commands feed it through this facade; its refit
        publishes go through :meth:`publish` (fanning to every replica)."""
        self.online = trainer
        if hasattr(trainer, "statusz"):
            obs_http.add_status_section("online", trainer.statusz)

    # ---- rollout ----

    def ensure_rollout(self, name: Optional[str] = None):
        if self.pool.mode == "process":
            raise LightGBMError(
                "pool-level canary rollout needs fleet_mode=inproc; "
                "process-mode workers each run their own rollout (send "
                "!canary to a worker directly)")
        if self.rollout is None:
            from .rollout import RolloutManager
            self.rollout = RolloutManager(PoolBackend(self), self.conf,
                                          name=name or self.name)
        return self.rollout

    # ---- introspection / lifecycle ----

    def stats(self) -> Dict:
        out = {"fleet": self.pool.snapshot()}
        if self.pool.mode != "process" and self.pool.replicas:
            out["models"] = self.pool.replicas[0].registry.models()
        s = slo.TRACKER.snapshot()
        if s:
            out["slo"] = s
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        if self.rollout is not None:
            out["rollout"] = self.rollout.snapshot()
        if self.online is not None and hasattr(self.online, "statusz"):
            out["online"] = self.online.statusz()
        return out

    def fleet_stats(self) -> Dict:
        out = {"mode": self.pool.mode, "replicas": len(self.pool),
               "pool": self.pool.snapshot()}
        if self.store is not None:
            out["store"] = self.store.snapshot()
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        if self.rollout is not None:
            out["rollout"] = self.rollout.snapshot()
        return out

    def close(self) -> None:
        self.rollout = None
        self.pool.close()
        if self.online is not None:
            obs_http.remove_status_section("online")
        obs_http.remove_status_section("fleet")
        obs_http.stop(self._obs_http)
        self._obs_http = None
