"""Rule: collective-consistency — mesh axis names vs the declared mesh.

The port's shard sums (``ops/grow.py`` ``_psum``/``_hist_allreduce``) and
their cross-rank step (``_xsum``) take their axis from ``GrowParams``
(``axis_name``, ``feature_axis_name``), which the learners copy from the
mesh itself (``mesh.axis_names``); the mesh axes the port ever creates are
declared as constants in ``parallel/mesh.py`` (``DATA_AXIS = "data"``,
``FEATURE_AXIS = "feature"``). A string LITERAL given as an axis name —
``axis_name="dta"``, ``Mesh(devices, ("data", "feat"))``, a ``mesh_axis``
parameter, a comparison ``gp.axis_name == "rows"`` — that is not in that set
can never match a live mesh: the data-parallel learner then re-plans on
another axis, or the consistency fence refuses the plan, but only on the
sharded path, which single-device tests never execute. This rule catches
the typo'd axis on every run. Non-literal axis names (``mesh.axis_names[0]``,
``gp.axis_name``) are the blessed idiom and are skipped.

The reference's second check, a host callback inside a ``shard_map`` body,
has no counterpart: the port has no shard_map; its shard sums run in the
host's level loop, whose syncs ``host-sync-in-jit`` audits.
"""
from __future__ import annotations

from ..core import ModuleContext, Rule, register


@register
class CollectiveConsistency(Rule):
    name = "collective-consistency"
    severity = "error"
    description = ("mesh axis-name literal not declared in "
                   "parallel/mesh.py")
    rationale = ("a typo'd axis only fails on the sharded path the "
                 "single-device tests don't run")

    def check_module(self, ctx: ModuleContext) -> None:
        if ctx.facts is None or ctx.repo_facts is None:
            return
        axes = ctx.repo_facts.mesh_axes
        for use in ctx.facts.axis_uses:
            if use.axis not in axes:
                ctx.report(
                    self, use.line,
                    f"{use.where}={use.axis!r} names an axis not declared "
                    f"in parallel/mesh.py (known: {', '.join(sorted(axes))})"
                    "; it fails on the sharded path only — use the mesh's "
                    "declared axis constant")
