"""Nested dicts of tensors as pytrees.

Leaves are visited in JAX's order for dicts (sorted keys), so a sum over the
leaves runs in the order the JAX package's ``tree_leaves`` gives.  ``None``
is an empty subtree, as in JAX.  :func:`flatten_with_path` also walks
NamedTuples (``TrainState``), tuples and lists, as JAX does, and names each
leaf by the path the JAX checkpointer writes.
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


def map_with_path(fn: Callable, tree) -> Any:
    """A tree of ``tree``'s structure (NamedTuples, tuples and lists
    included) whose leaves are ``fn(path, leaf)``, called in JAX's leaf
    order: sorted dict keys, a NamedTuple's fields in declaration order,
    sequence indices.  A path segment is what the JAX checkpointer's
    ``_path_key`` spells: a dict key, a sequence index, or a NamedTuple
    field name (``step``, ``params``, ``opt_state``, ``comp_state``)."""
    def build(t, path):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k], path + (str(k),)) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f), path + (f,))
                             for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x, path + (str(i),))
                           for i, x in enumerate(t))
        return fn(path, t)

    return build(tree, ())


def flatten_with_path(tree) -> list[tuple[tuple[str, ...], Any]]:
    """``(path, leaf)`` for every leaf, in JAX's leaf order (see
    :func:`map_with_path`)."""
    out = []
    map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out
