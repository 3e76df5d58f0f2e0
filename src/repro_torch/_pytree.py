"""A tiny pytree helper over tuples, lists and dicts.

Partials of the apps are tensors or small nested containers of tensors
(k-means: ``(sums, counts)``).  ``tree_map`` and ``tree_leaves`` cover
exactly that: tuples, lists and dicts recurse, everything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more trees of the same structure.

    >>> tree_map(lambda a, b: a + b, (1, [2, {"x": 3}]), (10, [20, {"x": 30}]))
    (11, [22, {'x': 33}])
    """
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, *parts) for parts in zip(tree, *rest, strict=True)]
        return type(tree)(out)
    if isinstance(tree, dict):
        for r in rest:
            if r.keys() != tree.keys():
                raise ValueError(f"dict keys differ: {sorted(tree)} vs {sorted(r)}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in traversal order.

    >>> tree_leaves({"a": (1, 2), "b": [3]})
    [1, 2, 3]
    """
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]
