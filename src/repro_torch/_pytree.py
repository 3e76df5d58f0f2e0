"""A tiny pytree helper over tuples, lists, dicts and registered dataclasses.

Partials of the apps are tensors or small nested containers of tensors
(k-means: ``(sums, counts)``).  ``tree_map`` and ``tree_leaves`` cover
exactly that: tuples, lists and dicts recurse, everything else is a leaf.
A dataclass registered with :func:`register_dataclass` (the optimizer's
``AdamWState``, as the JAX package registers its own with
``jax.tree_util.register_dataclass``) recurses too, over its fields in
declaration order; :func:`dataclass_fields` gives them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["dataclass_fields", "register_dataclass", "tree_map", "tree_leaves"]

_DATACLASSES: set[type] = set()


def register_dataclass(cls: type) -> type:
    """Make instances of the dataclass ``cls`` tree nodes (a decorator)."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls.__name__} is not a dataclass")
    _DATACLASSES.add(cls)
    return cls


def dataclass_fields(node: Any) -> list[str] | None:
    """The field names of a registered dataclass instance, else None."""
    if type(node) in _DATACLASSES:
        return [f.name for f in dataclasses.fields(node)]
    return None


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more trees of the same structure.

    >>> tree_map(lambda a, b: a + b, (1, [2, {"x": 3}]), (10, [20, {"x": 30}]))
    (11, [22, {'x': 33}])
    """
    names = dataclass_fields(tree)
    if names is not None:
        return type(tree)(**{
            n: tree_map(fn, getattr(tree, n), *(getattr(r, n) for r in rest)) for n in names
        })
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
    names = dataclass_fields(tree)
    if names is not None:
        return [leaf for n in names for leaf in tree_leaves(getattr(tree, n))]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]
