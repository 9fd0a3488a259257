"""The port's lint: static and runtime checks of lightgbm_tpu_torch.

The counterpart of ``lightgbm_tpu/analysis``. Run
``LGBMTPU_LINT_ONLY=1 python -m lightgbm_tpu_torch.analysis`` (torch-free
and jax-free; add ``--dynamic`` for the non-finite smoke on the card,
``--device cpu`` to run it on the CPU), or use :func:`analyze_source` / :func:`analyze_paths`
in-process. The suppression comment is the reference's,
``# tpu-lint: disable=<rule>``, so one comment serves both linters.

Rules that carry over as they are, scoped to the port's files:
``non-atomic-artifact-write``, ``collective-divergence``,
``collective-order``, ``lock-order``, ``unlocked-shared-state``,
``telemetry-schema``, ``nonfinite-policy-literal``,
``swallowed-device-error`` (the port's device calls added to the
reference's) and ``unregistered-param``. Rules redone for torch:
``host-sync-in-jit`` (host syncs in the level, step and iteration loops),
``dtype-drift`` (an f64 numpy array reaching the card unasked),
``wire-dtype`` (a raw ``torch.distributed`` collective outside the
multihost.py codec), ``nonaddressable-access`` (a rank materializing a
tensor of another rank's rows), ``collective-consistency`` (axis names
against ``parallel/mesh.py``) and the dynamic ``nonfinite-policy-smoke``,
which trains on the device the caller names.

Rules with no counterpart, because the port has no jit: it compiles
nothing at run time (no ``torch.compile``, no ``torch.jit.script`` or
``torch.jit.trace``; its kernels are built once by nvcc), so nothing
retraces, donates a buffer or lowers a program:

- ``retrace-hazard``: a jit wrapper built per call, an unhashable static
  argument, Python control flow on a traced value;
- ``donation-safety``: a buffer read after ``donate_argnums`` handed it to
  XLA;
- ``unsharded-transfer``: a ``jax.device_put`` with no placement in the
  mesh modules (the port's mesh places every block with an explicit
  ``.to(device)``, ``parallel/mesh.py``);
- ``compile-budget`` and its ``budget_probe.py``: XLA lowerings counted
  against ``LOWERING_BUDGET.json``.

tests/test_torch_analysis.py keeps that reason true: the port's tree holds
no ``torch.compile``, ``torch.jit.script``, ``torch.jit.trace`` and no
``jax``. ``collectivewatch`` (the runtime ledger of collectives) is the
port's ``parallel/collectivewatch.py``, re-exported here; ``lockwatch``
(the runtime lock-order watchdog) is this package's stdlib-only module,
loaded by file path before any port lock exists.
"""
from .core import (AnalysisResult, BaselineEntry, Finding, ModuleContext,
                   Rule, all_rules, analyze_paths, analyze_source,
                   changed_files, event_schemas, load_baseline, main,
                   nonfinite_policies, register, registered_params,
                   render_human, render_json, render_sarif,
                   unconsumed_params)

__all__ = [
    "AnalysisResult", "BaselineEntry", "Finding", "ModuleContext", "Rule",
    "all_rules", "analyze_paths", "analyze_source", "changed_files",
    "event_schemas", "load_baseline", "main", "nonfinite_policies",
    "register", "registered_params", "render_human", "render_json",
    "render_sarif", "unconsumed_params", "collectivewatch",
]


def __getattr__(name):
    # the port's runtime ledger of collectives, imported on first use so
    # the lint itself stays free of the parallel package
    if name == "collectivewatch":
        from ..parallel import collectivewatch
        return collectivewatch
    raise AttributeError(name)
