"""Background load and warm-up of the CUDA kernels (cold-start overlap).

Port of ``lightgbm_tpu/prewarm.py``. On the TPU the work that a cold start
pays before the first tree is the XLA compile of the fused train step,
which the reference lowers ahead of time on a thread while the Dataset's
bulk ingest runs. On the card the same place holds the kernel library:
``ops/cuda_lib.load`` builds it with nvcc (or loads the cached
``_build/*.so``) at the first kernel launch, and each kernel's function is
loaded at its own first launch. Everything that work needs is fixed the
moment ``Dataset.construct`` has its mappers and EFB plan, before the bulk
encode, so ``maybe_start`` runs it on a daemon thread from there:

- loads (or builds) the library;
- records the ``step_spec`` the Dataset and the parameters predict for the
  trainer (its class, k, n, f, bundles, CEGB, forced splits, the fused
  front, the quantized histograms, the grower);
- launches each kernel that spec's path runs once on a tiny input
  (``hist_kernels.warm``), on a stream of its own, counting those launches
  in ``hist_kernels.WARM_LAUNCHES``, apart from every path's launch count.

``adopt`` joins the thread when the trainer is created (the barrier before
the first launch) and compares the prediction with the trainer's own
spec: ``aot_prewarm`` says ``adopted`` or ``miss``. A failed worker (the
armed ``prewarm_compile`` point, a build error) is a miss: training then
loads the library at its first launch as it does without the prewarm, and
a build error fails that launch. ``prewarm=0`` turns it off.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from . import obs
from .config import BOOSTING
from .log import debug, info

class PrewarmHandle:
    """One background warm-up: ``join`` is the barrier before the first
    launch; ``spec``, ``kernels`` and ``result`` are written by the worker
    before its thread ends, so a thread that joined sees them."""

    def __init__(self) -> None:
        self.spec: Optional[Dict[str, Any]] = None
        self.kernels: Tuple[str, ...] = ()
        self.result: Dict[str, Any] = {}
        self._thread: Optional[threading.Thread] = None

    def join(self, timeout: Optional[float] = None) -> "PrewarmHandle":
        if self._thread is not None:
            self._thread.join(timeout)
        return self

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()


def _spec(cls_name: str, k: int, n: int, f: int, bundle: bool,
          path, shards: int = 1) -> Dict[str, Any]:
    return {"class": cls_name, "k": int(k), "n": int(n), "f": int(f),
            "shards": int(shards),
            "bundle": bool(bundle), "cegb": path.cegb,
            "forced": path.forced, "fused": path.fused,
            "quantized": path.quant,
            "grower": "depthwise" if path.depthwise else "lossguide"}


def step_spec(gbdt) -> Dict[str, Any]:
    """What shapes the trainer's kernel path, read off the trainer."""
    ts = gbdt.train_set
    plan = gbdt._shard_plan
    return _spec(type(gbdt).__name__, gbdt.num_tree_per_iteration,
                 ts.num_data, ts.num_features, ts.bundle_meta is not None,
                 gbdt.path, plan.num_shards if plan is not None else 1)


def _shard_devices(conf, dataset):
    """The shard count the trainer of ``conf`` on ``dataset`` will have
    and the distinct devices its kernels run on (reference: the prewarm's
    sharded avals follow the published plan)."""
    from .parallel.mesh import local_devices
    plan = dataset.shard_plan
    if plan is not None:
        devs = list(plan.devices)
    elif str(conf.tree_learner).lower() in ("data", "data_parallel",
                                             "voting") and \
            len(local_devices(dataset.device.type)) > 1:
        devs = local_devices(dataset.device.type)
    else:
        devs = [dataset.device]
    uniq = []
    for d in devs:
        if d not in uniq:
            uniq.append(d)
    return len(devs), uniq


def expected_spec(conf, dataset) -> Tuple[Dict[str, Any], Any, int]:
    """The spec and the ``KernelPath`` that the trainer of ``conf`` on
    ``dataset`` will have, with its padded bin count, from the Dataset's
    metadata (its mappers and EFB plan; the bins need not exist yet). The
    trainer decides its path by the same ``models/gbdt.kernel_path``."""
    from .basic import TRAINERS
    from .config import boosting_kind
    from .models.gbdt import forced_split_arrays, kernel_path, padded_bins
    from .objectives import create_objective
    num_bins = dataset.column_bins()[0]
    f = len(num_bins)
    B = padded_bins(int(num_bins.max()) if f else 1)
    cls = TRAINERS[boosting_kind(conf.boosting)]
    obj = create_objective(conf.objective, conf)
    k = obj.num_model_per_iteration if obj is not None else int(
        conf.num_class)
    weighted = dataset.weight_np is not None
    path = kernel_path(
        conf, f, B, k,
        fused_obj=obj is not None and obj.fuses(weighted),
        const_hess_obj=obj is not None and obj.constant_hessian(weighted),
        custom_grad=cls._custom_grad,
        forced=forced_split_arrays(conf, dataset, log=False) is not None,
        log=False)
    spec = _spec(cls.__name__, k, dataset.num_data, f,
                 dataset.bundle_meta is not None, path,
                 _shard_devices(conf, dataset)[0])
    return spec, path, B


# below this the ingest is far shorter than the library load it would
# hide, and a Dataset that is constructed but never trained (a valid set,
# a serialization round trip) would spend a warm-up for nothing
MIN_PREWARM_ROWS = 200_000
# a CPU Dataset has no library to load; False runs the worker there too,
# on the kernels' plain versions (the CPU tests drive the machinery so)
CUDA_ONLY = True


def _skip_reason(conf, dataset) -> Optional[str]:
    if not conf.prewarm:
        return "prewarm=0"
    n = int(dataset.num_data or 0)
    if n < MIN_PREWARM_ROWS:
        return f"num_data={n} < {MIN_PREWARM_ROWS} (nothing to hide behind)"
    if str(conf.boosting).lower() not in BOOSTING:
        return f"boosting={conf.boosting} (unknown booster)"
    if str(conf.tree_learner).lower() in ("feature", "feature_parallel"):
        return f"tree_learner={conf.tree_learner} (feature tiles differ)"
    if conf.num_machines > 1:
        return "num_machines>1"
    if dataset.label_np is None:
        return "no label (nothing to train)"
    if CUDA_ONLY and (dataset.device is None
                      or dataset.device.type != "cuda"):
        return "device_type=cpu (no kernel library to load)"
    return None


def maybe_start(conf, dataset) -> Optional[PrewarmHandle]:
    """Start the background load and warm-up when the configuration is in
    scope. Called by Dataset.construct once the mappers and the EFB plan
    are fixed, before the bulk ingest it is meant to hide behind."""
    reason = _skip_reason(conf, dataset)
    tele = obs.enabled()
    if reason is not None:
        if tele:
            obs.emit("aot_prewarm", phase="skipped", reason=reason)
        debug("kernel prewarm skipped: %s", reason)
        return None
    handle = PrewarmHandle()
    def _worker():
        t0 = time.perf_counter()
        try:
            # chaos point: a failed warm-up must degrade to loading at the
            # first launch (an adoption miss), never break training
            from .utils import faults
            faults.fault_point("prewarm_compile")
            import torch
            from .ops import cuda_lib, hist_kernels
            spec, path, B = expected_spec(conf, dataset)
            handle.spec, handle.kernels = spec, path.kernels
            t1 = time.perf_counter()
            # every distinct device the shards' kernels run on (one
            # without a plan)
            devices = _shard_devices(conf, dataset)[1]
            load_s, warmed = 0.0, {}
            for dev in devices:
                if dev.type == "cuda":
                    if not load_s:
                        cuda_lib.load()
                        load_s = time.perf_counter() - t1
                    stream = torch.cuda.Stream(dev)
                    with torch.cuda.stream(stream):
                        w = hist_kernels.warm(path.kernels, dev, B,
                                              path.const_hess)
                    stream.synchronize()
                else:
                    w = hist_kernels.warm(path.kernels, dev, B,
                                          path.const_hess)
                for name, cnt in w.items():
                    warmed[name] = warmed.get(name, 0) + cnt
            handle.result.update(load_s=load_s, warmed=warmed,
                                 built=bool(cuda_lib.BUILD_INFO.get("built")),
                                 duration_s=time.perf_counter() - t0)
            if tele:
                obs.emit("aot_prewarm", phase="compiled",
                         duration_s=float(handle.result["duration_s"]))
        except BaseException as e:   # a miss at adoption
            handle.result["error"] = e
            if tele:
                obs.emit("aot_prewarm", phase="error", reason=str(e)[:200],
                         duration_s=time.perf_counter() - t0)

    th = threading.Thread(target=_worker, daemon=True, name="kernel-prewarm")
    handle._thread = th
    if tele:
        obs.emit("aot_prewarm", phase="started")
    th.start()
    return handle


def adopt(handle: PrewarmHandle, gbdt) -> bool:
    """Join the background warm-up (the barrier before the first launch)
    and report whether it warmed this trainer's path: True when it ran and
    its spec is the trainer's."""
    t0 = time.perf_counter()
    handle.join()
    wait = time.perf_counter() - t0
    tele = obs.enabled()
    err = handle.result.get("error")
    if err is not None:
        if tele:
            obs.emit("aot_prewarm", phase="miss",
                     reason=f"background warm-up failed: {str(err)[:160]}")
        debug("kernel prewarm unusable (%r); loading at the first launch",
              err)
        return False
    if handle.spec != step_spec(gbdt):
        if tele:
            obs.emit("aot_prewarm", phase="miss", reason="spec mismatch")
        info("the prewarmed kernels do not match the trainer's path; "
             "its own kernels load at their first launch")
        return False
    if tele:
        obs.emit("aot_prewarm", phase="adopted", duration_s=float(wait))
        obs.METRICS.counter("aot_prewarm_hits",
                            "prewarmed kernel paths adopted").inc()
    debug("adopted the prewarmed kernel path (barrier wait %.3fs)", wait)
    return True
