"""Rules: nonfinite-policy-literal (static) + nonfinite-policy-smoke (dynamic).

The ``nonfinite_policy`` knob has exactly three legal values (validated at
config time). Two complementary guards:

- **nonfinite-policy-literal** (AST): any string literal bound or compared
  to ``nonfinite_policy`` — ``params["nonfinite_policy"] = "clamp"``,
  ``{"nonfinite_policy": "skip"}``, ``conf.nonfinite_policy == "Fatal"`` —
  must be one of the registered values. A typo'd policy string otherwise
  survives until config validation at run time (or, in a comparison, forever:
  the branch is silently dead). The legal set is parsed out of config.py's
  validation tuple, so adding a policy there updates the rule automatically.

- **nonfinite-policy-smoke** (dynamic, ``--dynamic`` only): the reference's
  end-to-end check on the port — trains a tiny model under each policy
  with an objective that turns NaN mid-run and asserts fatal aborts /
  warn_skip_tree skips / clip completes. It imports the port (and
  therefore torch) and trains on the device the caller names
  (``--device``, ``cuda`` unless the caller asks for ``cpu`` as the tests
  do), so it never
  runs in the plain AST pass.
"""
from __future__ import annotations

import ast

from ..astwalk import walk
from typing import List

from ..core import (Finding, ModuleContext, Rule, nonfinite_policies,
                    register)

_KEY = "nonfinite_policy"


@register
class NonfinitePolicyLiteral(Rule):
    name = "nonfinite-policy-literal"
    severity = "error"
    description = ("string literal bound/compared to nonfinite_policy is "
                   "not a registered policy value")
    rationale = ("a typo'd policy string dies at config validation at best; "
                 "in a comparison it silently dead-codes the branch")

    def check_module(self, ctx: ModuleContext) -> None:
        legal = nonfinite_policies()
        for node in walk(ctx.tree):
            # {"nonfinite_policy": "<lit>"} in any dict literal
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value == _KEY:
                        self._check_value(ctx, v, legal)
            # params["nonfinite_policy"] = "<lit>"
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant):
                for t in node.targets:
                    if _is_key_target(t):
                        self._check_value(ctx, node.value, legal)
            # <expr>.nonfinite_policy == "<lit>"  /  in ("<lit>", ...)
            elif isinstance(node, ast.Compare) and _mentions_key(node.left):
                for comp in node.comparators:
                    for sub in walk(comp):
                        if isinstance(sub, ast.Constant):
                            self._check_value(ctx, sub, legal)
            # f(nonfinite_policy="<lit>")
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == _KEY:
                        self._check_value(ctx, kw.value, legal)

    def _check_value(self, ctx: ModuleContext, node: ast.AST, legal) -> None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value not in legal:
            ctx.report(self, node,
                       f"{node.value!r} is not a registered "
                       f"nonfinite_policy (legal: "
                       f"{', '.join(sorted(legal))})")


def _is_key_target(t: ast.AST) -> bool:
    return (isinstance(t, ast.Subscript)
            and isinstance(t.slice, ast.Constant)
            and t.slice.value == _KEY) or \
           (isinstance(t, ast.Attribute) and t.attr == _KEY)


def _mentions_key(node: ast.AST) -> bool:
    for sub in walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == _KEY:
            return True
        if isinstance(sub, ast.Constant) and sub.value == _KEY:
            return True
    return False


@register
class NonfinitePolicySmoke(Rule):
    name = "nonfinite-policy-smoke"
    severity = "error"
    kind = "dynamic"
    description = ("end-to-end behavioral check of the three "
                   "nonfinite_policy modes (imports torch; --dynamic only)")
    rationale = ("the policies guard against mid-run NaN poisoning; only a "
                 "live training run proves each one still does its job")

    ROUNDS = 5
    NAN_FROM = 3      # fobj call number at which gradients turn NaN
    NAN_ROWS = 5      # rows poisoned (partial, so clip can continue)

    def check_module(self, ctx: ModuleContext) -> None:
        return   # dynamic-only

    def run_dynamic(self, device: str = "cuda") -> List[Finding]:
        import numpy as np

        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch import log

        def make_fobj():
            state = {"n": 0}

            def fobj(preds, ds):
                state["n"] += 1
                # the port's Dataset keeps its label on the device;
                # get_label() is the numpy copy fobj gets
                y = np.asarray(ds.get_label(), dtype=np.float64)
                g = np.asarray(preds, dtype=np.float64) - y
                h = np.ones_like(g)
                if state["n"] >= self.NAN_FROM:
                    g[:self.NAN_ROWS] = np.nan
                return g, h

            return fobj

        rng = np.random.RandomState(0)
        X = rng.rand(400, 6)
        y = X @ rng.rand(6) + 0.1 * rng.randn(400)

        def run_policy(policy):
            params = {"verbosity": -1, "num_leaves": 7,
                      "min_data_in_leaf": 5, "objective": "none",
                      "nonfinite_policy": policy, "device_type": device}
            return lgb.train(params, lgb.Dataset(X, label=y),
                             num_boost_round=self.ROUNDS, fobj=make_fobj())

        def finding(msg: str) -> Finding:
            return Finding(rule=self.name, path="<dynamic>", line=0,
                           message=f"[{device}] {msg}",
                           severity=self.severity)

        out: List[Finding] = []
        # fatal: must abort with LightGBMError
        try:
            run_policy("fatal")
            out.append(finding("fatal: training completed (expected "
                               "LightGBMError)"))
        except log.LightGBMError:
            pass
        # warn_skip_tree: completes, poisoned iterations grow no trees
        try:
            bst = run_policy("warn_skip_tree")
            if bst.num_trees() != self.NAN_FROM - 1:
                out.append(finding(f"warn_skip_tree: {bst.num_trees()} "
                                   f"trees, expected {self.NAN_FROM - 1}"))
        except Exception as e:   # noqa: BLE001 - report, don't crash the lint
            out.append(finding(f"warn_skip_tree: raised "
                               f"{type(e).__name__}: {e}"))
        # clip: completes with every tree and finite predictions
        try:
            bst = run_policy("clip")
            pred = bst.predict(X)
            if bst.num_trees() != self.ROUNDS:
                out.append(finding(f"clip: {bst.num_trees()} trees, "
                                   f"expected {self.ROUNDS}"))
            elif not np.isfinite(np.asarray(pred)).all():
                out.append(finding("clip: non-finite predictions"))
        except Exception as e:   # noqa: BLE001
            out.append(finding(f"clip: raised {type(e).__name__}: {e}"))
        return out
