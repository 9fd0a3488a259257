"""Serving fleet: multi-replica scale-out, SLO admission, canary rollout.

Port of ``lightgbm_tpu/fleet`` (host code, copied and adapted).

This package is the deployment layer in front of the single-process serving
stack (server.py): it owns *how many* serving replicas exist and *which*
model version traffic should trust, while every replica stays the same
registry + microbatcher + engine sandwich the rest of the repo tests.

- :mod:`~.replica`   ReplicaPool — N in-process engine replicas, each on a
  ``torch.device`` of its own (``cuda:i mod device_count``, so several
  replicas share one card) or SO_REUSEPORT worker processes, with
  a least-outstanding-requests front balancer and /healthz probes.
- :mod:`~.admission` AdmissionController — per-model latency SLO budgets off
  the obs/slo burn rate; shed or degrade-to-smaller-bucket, don't queue.
- :mod:`~.rollout`   RolloutManager — canary/shadow deployment of candidate
  versions with streaming PSI/KS comparison, auto-promote, auto-rollback.
- :mod:`~.drift`     StreamingComparator — the PSI/KS windows.
- :mod:`~.store`     ArtifactStore — the shared versioned model-file store
  every replica reads behind its ModelRegistry.
- :mod:`~.service`   FleetServer — the facade `task=serve` uses when
  ``fleet_replicas > 1``; protocol-compatible with PredictServer.
- :mod:`~.worker`    ``python -m lightgbm_tpu_torch.fleet.worker`` process
  entry.

Imports are lazy (PEP 562): server.py pulls the AdmissionController out of
this package while service.py pulls PredictServer out of server.py, and the
module-level indirection is what keeps that cycle unwound.
"""
from __future__ import annotations

_EXPORTS = {
    "AdmissionController": ".admission",
    "StreamingComparator": ".drift",
    "ArtifactStore": ".store",
    "Replica": ".replica",
    "ReplicaPool": ".replica",
    "WorkerReplica": ".replica",
    "RolloutManager": ".rollout",
    "ServerBackend": ".rollout",
    "FleetServer": ".service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod, __name__), name)
