"""Nested dicts of tensors as pytrees.

Leaves are visited in JAX's order for dicts (sorted keys), so a sum over the
leaves runs in the order the JAX package's ``tree_leaves`` gives.  ``None``
is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def unflatten_like(tree, flat: list) -> Any:
    """A tree of ``tree``'s structure holding ``flat`` (in ``leaves`` order)."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)
