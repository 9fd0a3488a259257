"""Rule: dtype-drift — float64 numpy arrays reaching the card unasked.

On a TPU the reference's hazard was jax narrowing f64 to f32 at upload. Torch
narrows nothing: ``torch.from_numpy(a).to(dev)`` and ``torch.as_tensor(a,
device=dev)`` keep numpy's float64 on the card. So the hazard turns around:
an array built with numpy's float64 default (``np.zeros(n)``,
``np.asarray(values)``) or an explicit f64 that reaches the card without a
dtype doubles its bytes and runs the kernels' neighbours in f64 arithmetic
(an H100 does f64 at a fraction of its f32 rate), and where the kernel
wrappers expect f32 it either raises on the card only or takes a slow
path — silently, with no difference on the CPU where the tests run.

The rule flags an upload without a dtype:

- ``torch.as_tensor(x, device=...)`` / ``torch.tensor(x, device=...)``
  / ``torch.asarray(x, device=...)`` with no ``dtype=``, and
- ``torch.from_numpy(x).to(...)`` / ``.cuda()`` (or ``torch.as_tensor(x)``
  then ``.to(dev)``) with no dtype in the ``.to``,

whose ``x`` is a numpy construction with no dtype or with float64 — inline,
or a local assigned from one earlier in the same function. Deliberate f64
on the card (the leaf sums' f64 tables, serving's tree-order sum, exact
binning) suppresses inline with a comment stating the precision
requirement. Host-only numpy in f64 (model text, metrics) is never flagged:
only the upload is the decision.
"""
from __future__ import annotations

import ast

from ..astwalk import walk
from typing import Dict, Optional

from ..core import ModuleContext, Rule, register

_NP_CTORS = {"zeros", "ones", "empty", "full", "array", "asarray",
             "zeros_like", "ones_like", "full_like", "empty_like"}
_LIKE = {"zeros_like", "ones_like", "full_like", "empty_like"}
_UPLOADERS = {"as_tensor", "tensor", "asarray"}


def _dtype_pos(ctor: str) -> int:
    """Positional index of ``dtype`` for the numpy constructors matched."""
    return {"full": 2, "full_like": 2}.get(ctor, 1)


def _is_f64_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value in ("float64", "f8",
                                                         "double"):
        return True
    return isinstance(node, ast.Attribute) and node.attr in ("float64",
                                                             "double")


def _is_dtype_expr(node: ast.AST) -> bool:
    """A positional ``.to`` argument that is a dtype (``torch.float32``)."""
    return isinstance(node, ast.Attribute) and (
        node.attr.startswith(("float", "int", "uint", "bool", "bfloat",
                              "complex")) or node.attr in ("half", "double",
                                                           "long"))


@register
class DtypeDrift(Rule):
    name = "dtype-drift"
    severity = "error"
    description = ("a float64 numpy array (numpy's default or explicit) "
                   "uploaded to the device with no dtype")
    rationale = ("torch keeps f64 on the card: twice the bytes and f64 "
                 "arithmetic where f32 was meant, visible only on the card")

    def check_module(self, ctx: ModuleContext) -> None:
        if not ctx.torch_aliases or not ctx.numpy_aliases:
            return
        for fn in walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                    ctx.mentions_device_api(fn):
                self._check_function(ctx, fn)

    def _f64_source(self, ctx: ModuleContext, node: ast.AST,
                    f64_vars: Dict[str, int]) -> Optional[str]:
        """Why ``node`` is an f64 numpy array, or None."""
        if isinstance(node, ast.Name) and node.id in f64_vars:
            return (f"{node.id}, built with numpy's float64 (line "
                    f"{f64_vars[node.id]})")
        if isinstance(node, ast.Call):
            how = self._np_f64_ctor(ctx, node)
            if how:
                return how
        return None

    def _np_f64_ctor(self, ctx: ModuleContext, node: ast.Call) \
            -> Optional[str]:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "astype" and \
                node.args and _is_f64_expr(node.args[0]):
            return "an .astype(float64)"
        if not (ctx.is_np_attr(f) and f.attr in _NP_CTORS):
            return None
        for kw in node.keywords:
            if kw.arg == "dtype":
                return f"np.{f.attr}(dtype=float64)" \
                    if _is_f64_expr(kw.value) else None
        pos = _dtype_pos(f.attr)
        if len(node.args) > pos:
            return f"np.{f.attr}(..., float64)" \
                if _is_f64_expr(node.args[pos]) else None
        if f.attr in _LIKE:
            return None        # keeps its argument's dtype
        if f.attr in ("array", "asarray") and node.args:
            a = node.args[0]
            if not isinstance(a, (ast.List, ast.Tuple, ast.ListComp)):
                return None    # keeps the dtype of what it converts
            if isinstance(a, (ast.List, ast.Tuple)) and all(
                    isinstance(e, ast.Constant) and
                    isinstance(e.value, (bool, int)) for e in a.elts):
                return None    # integers: int64, not float64
        return f"np.{f.attr}(...) with numpy's float64 default"

    def _check_function(self, ctx: ModuleContext, fn: ast.AST) -> None:
        f64_vars: Dict[str, int] = {}
        for node in sorted((n for n in walk(fn) if isinstance(n, ast.Assign)),
                           key=lambda n: n.lineno):
            if isinstance(node.value, ast.Call) and \
                    self._np_f64_ctor(ctx, node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        f64_vars.setdefault(t.id, node.lineno)
        for node in walk(fn):
            if not isinstance(node, ast.Call):
                continue
            src = self._upload_source(ctx, node)
            if src is None:
                continue
            why = self._f64_source(ctx, src, {
                k: v for k, v in f64_vars.items() if v <= node.lineno})
            if why:
                ctx.report(self, node,
                           f"{why} reaches the device with no dtype: torch "
                           "keeps f64 on the card (twice the bytes, f64 "
                           "arithmetic); pass dtype=, or suppress with a "
                           "comment stating the precision requirement")

    def _upload_source(self, ctx: ModuleContext, node: ast.Call) \
            -> Optional[ast.AST]:
        """The numpy operand of an upload with no dtype, or None."""
        f = node.func
        kws = {kw.arg for kw in node.keywords}
        # torch.as_tensor(x, device=d) with no dtype
        if ctx.is_torch_attr(f) and f.attr in _UPLOADERS and \
                "device" in kws and "dtype" not in kws and \
                len(node.args) == 1:
            return node.args[0]
        # torch.from_numpy(x).to(d) / .cuda(), no dtype in the .to
        if isinstance(f, ast.Attribute) and f.attr in ("to", "cuda"):
            inner = f.value
            if not (isinstance(inner, ast.Call) and
                    ctx.is_torch_attr(inner.func) and
                    inner.func.attr in ("from_numpy",) + tuple(_UPLOADERS)
                    and inner.args):
                return None
            if "dtype" in kws or any(_is_dtype_expr(a) for a in node.args):
                return None
            if f.attr == "to" and not node.args and "device" not in kws:
                return None
            if any(kw.arg == "dtype" for kw in inner.keywords):
                return None
            return inner.args[0]
        return None
