"""Fast, memoized AST traversal shared by the facts pass and every rule.

``ast.walk`` pays two layers of generator overhead (``iter_child_nodes``
on top of ``iter_fields``) per node, per call — and with ~15 rules plus
the facts pass each re-walking the same module trees, generic
traversal dominated whole-repo lint time once the scan surface passed a
hundred modules.  The analyzer never mutates a parsed tree, so each
subtree's node list can be computed once and cached on its root node.

``walk(node)`` yields nodes in the same breadth-first order as
``ast.walk`` and may be used as a drop-in replacement anywhere inside
``lightgbm_tpu_torch.analysis``.  Do not use it on trees that are mutated
between walks.
"""

from ast import AST
from typing import Iterator

# cache attribute set on walked roots; name-mangled so it can never
# collide with a real AST field
_CACHE = "_tpu_lint_walk_cache"


def walk(node: AST) -> Iterator[AST]:
    cached = getattr(node, _CACHE, None)
    if cached is None:
        # breadth-first, matching ast.walk: the list doubles as the queue
        cached = [node]
        append = cached.append
        i = 0
        while i < len(cached):
            n = cached[i]
            i += 1
            for f in n._fields:
                v = getattr(n, f, None)
                if v.__class__ is list:
                    for x in v:
                        if isinstance(x, AST):
                            append(x)
                elif isinstance(v, AST):
                    append(v)
        setattr(node, _CACHE, cached)
    return iter(cached)
