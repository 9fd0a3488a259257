"""Rule: unregistered-param — config keys read but never registered.

``config.py``'s ``_PARAMS`` registry is the single source of truth for the
parameter surface; ``tests/test_params_consumed.py`` already proves every
REGISTERED param is consumed somewhere. This rule closes the opposite gap: a
``params["knob"]`` / ``params.get("knob")`` / ``conf.knob`` /
``getattr(conf, "knob")`` read whose key was never registered. Such a read
always sees the hard-coded fallback (or raises AttributeError on a Config),
because ``Config.update`` routes unknown user keys into ``conf.extra`` — the
knob looks wired up but can never be set. The registry (names + every alias)
is extracted by AST-parsing config.py, never by importing it.

The opposite gap, a registered key read nowhere, is
:func:`registered_not_consumed`: every key of the port's ``_PARAMS`` must
be read outside ``config.py`` or be listed in ``models/gbdt.py``
``UNCONSUMED`` (accepted, warned about when set, with the reason it has no
effect on the card) or in :data:`NO_EFFECT` (accepted silently, as the
reference accepts it). tests/test_torch_analysis.py holds the port to it.

Config variables are recognized conservatively: names assigned from
``params_to_config(...)`` / ``Config(...)`` / ``<conf>.copy()`` in the same
function, and parameters annotated ``: Config``. (A bare name like ``conf``
is NOT assumed to be a Config — efb.py uses ``conf`` for a conflict matrix.)
"""
from __future__ import annotations

import ast
import os
import re

from ..astwalk import walk
from typing import List, Set

from ..core import (PKG_DIR, ModuleContext, Rule, register,
                    registered_params, unconsumed_params)

# Config's own API surface (methods/attrs that are not params)
_CONFIG_API = {"extra", "update", "copy", "to_dict", "str2map", "from_cli"}
_PARAM_DICT_RECEIVERS = {"params"}

# registered parameters that the port reads nowhere and, like the
# reference, accepts without a warning; each with the reason it has no
# effect on the card
NO_EFFECT = {
    "histogram_impl": "names one of the reference's XLA histogram "
                      "lowerings (auto, onehot, scatter, pallas); the "
                      "port's histograms are its CUDA kernels whatever "
                      "it names",
}


@register
class UnregisteredParam(Rule):
    name = "unregistered-param"
    severity = "error"
    description = ("params[...]/params.get(...)/conf.<attr> key not "
                   "declared in config.py's _PARAMS registry")
    rationale = ("an unregistered key silently lands in conf.extra; the "
                 "knob reads as wired but user settings never reach it")

    def check_module(self, ctx: ModuleContext) -> None:
        if ctx.relpath.endswith("lightgbm_tpu_torch/config.py"):
            return   # the registry itself
        known = registered_params()
        if not known:
            return   # config.py unavailable (fixture runs): stay silent
        for node in walk(ctx.tree):
            # params["key"] / params.get("key")
            if isinstance(node, ast.Subscript) and \
                    _is_params_dict(node.value):
                key = node.slice
                if isinstance(key, ast.Constant) and \
                        isinstance(key.value, str) and key.value not in known:
                    self._flag(ctx, node, key.value)
            elif isinstance(node, ast.Call):
                f = node.func
                # NOT .pop(): its dominant in-tree use is the sklearn wrapper
                # scrubbing estimator-level kwargs OUT of the dict before it
                # reaches the engine — flagging that would punish the cure
                if isinstance(f, ast.Attribute) and \
                        f.attr in ("get", "setdefault") and \
                        _is_params_dict(f.value) and node.args:
                    key = node.args[0]
                    if isinstance(key, ast.Constant) and \
                            isinstance(key.value, str) and \
                            key.value not in known:
                        self._flag(ctx, node, key.value,
                                   via=f.attr + "()")
        for fn in walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_config_vars(ctx, fn, known)

    def _check_config_vars(self, ctx: ModuleContext, fn: ast.AST,
                           known: Set[str]) -> None:
        conf_vars = _config_vars(fn)
        if not conf_vars:
            return
        for node in walk(fn):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in conf_vars:
                attr = node.attr
                if attr.startswith("_") or attr in _CONFIG_API:
                    continue
                if attr not in known:
                    self._flag(ctx, node, attr, via="attribute")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "getattr" and len(node.args) >= 2 and \
                    isinstance(node.args[0], ast.Name) and \
                    node.args[0].id in conf_vars and \
                    isinstance(node.args[1], ast.Constant) and \
                    isinstance(node.args[1].value, str):
                attr = node.args[1].value
                if not attr.startswith("_") and attr not in _CONFIG_API \
                        and attr not in known:
                    self._flag(ctx, node, attr, via="getattr")

    def _flag(self, ctx: ModuleContext, node: ast.AST, key: str,
              via: str = "subscript") -> None:
        ctx.report(self, node,
                   f"config key {key!r} (via {via}) is not registered in "
                   "config.py _PARAMS (nor as an alias); register it or "
                   "the setting silently lands in conf.extra")


def _is_params_dict(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id in _PARAM_DICT_RECEIVERS
    return isinstance(node, ast.Attribute) and \
        node.attr in _PARAM_DICT_RECEIVERS


def _config_vars(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    args = fn.args
    for p in args.posonlyargs + args.args + args.kwonlyargs:
        ann = p.annotation
        if isinstance(ann, ast.Name) and ann.id == "Config":
            out.add(p.arg)
        elif isinstance(ann, ast.Constant) and ann.value == "Config":
            out.add(p.arg)
    for node in walk(fn):
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            continue
        f = node.value.func
        name = f.id if isinstance(f, ast.Name) else \
            f.attr if isinstance(f, ast.Attribute) else ""
        from_ctor = name in ("params_to_config", "Config")
        from_copy = (name == "copy" and isinstance(f, ast.Attribute)
                     and isinstance(f.value, ast.Name)
                     and f.value.id in out)
        if from_ctor or from_copy:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def registered_not_consumed(pkg_dir: str = PKG_DIR) -> List[str]:
    """Keys of ``config.py``'s ``_PARAMS`` that no other module of the
    package reads (an attribute ``.name``, a string ``"name"`` or a keyword
    ``name=``, the reference's sweep, tests/test_params_consumed.py) and
    that neither ``models/gbdt.py UNCONSUMED`` nor :data:`NO_EFFECT`
    lists."""
    blobs = []
    for root, _dirs, files in os.walk(pkg_dir):
        if os.sep + "analysis" in root[len(pkg_dir):]:
            continue
        for fn in files:
            if fn.endswith(".py") and fn != "config.py":
                with open(os.path.join(root, fn)) as fh:
                    blobs.append(fh.read())
    src = "\n".join(blobs)
    unconsumed = unconsumed_params(os.path.join(pkg_dir, "models",
                                                "gbdt.py"))
    tree = ast.parse(open(os.path.join(pkg_dir, "config.py")).read())
    canonical = set()
    for node in walk(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "_PARAMS"
                   for t in targets) and isinstance(node.value, ast.Dict):
                canonical.update(k.value for k in node.value.keys
                                 if isinstance(k, ast.Constant))
    missing = []
    for name in sorted(canonical):
        if name in unconsumed or name in NO_EFFECT:
            continue
        pat = re.compile(r"\.\s*" + re.escape(name) + r"\b|[\"']"
                         + re.escape(name) + r"[\"']|\b" + re.escape(name)
                         + r"\s*=")
        if not pat.search(src):
            missing.append(name)
    return missing
