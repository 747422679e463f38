"""Weights made from the seed, on the device, in a few large calls.

The benchmark makes the weights and hands the same tensors to the program
and to the reference; it takes from the program only the layout (keys,
shapes and dtypes of its parameter tree).  One ``torch.randn`` a dtype fills
a flat buffer from a generator on the card; each leaf is a view of it,
scaled by 1/sqrt(fan-in) (norm scales are ones, biases zeros).  The same
seed on the same device gives the same values, so the reference of a
training cell makes its own copy again after the window.

Fan-in, by the leaf's key: ``wq``/``wk``/``wv`` (..., d, heads, head_dim)
read d; ``wo`` (..., heads, head_dim, d) reads heads x head_dim; ``embed``
(vocab, d) is scaled by d; any other matrix (..., in, out) reads ``in``.
"""
from __future__ import annotations

import math

import torch

# elements a ``normal_`` call fills (the generator runs on across calls)
CHUNK = 1 << 30


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(dotted path, leaf) pairs of a nested dict, in key order."""
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out.extend(flatten(tree[k], f"{prefix}{k}."))
        return out
    return [(prefix[:-1], tree)]


def unflatten(pairs: list[tuple[str, object]]) -> dict:
    out: dict = {}
    for path, leaf in pairs:
        node = out
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def init_kind(path: str, shape: tuple) -> tuple[str, float]:
    """("normal", scale), ("ones", 1) or ("zeros", 0) for a leaf."""
    key = path.split(".")[-1]
    if key in ("bq", "bk", "bv"):
        return "zeros", 0.0
    if "norm" in key:
        return "ones", 1.0
    if key in ("wq", "wk", "wv"):
        fan = shape[-3]
    elif key == "wo":
        fan = shape[-3] * shape[-2]
    elif key == "embed":
        fan = shape[-1]
    else:
        fan = shape[-2]
    return "normal", 1.0 / math.sqrt(fan)


def make_weights(layout, seed: int, device) -> dict:
    """Tensors for every leaf of ``layout`` (a nested dict of leaves with
    ``shape`` and ``dtype``), from ``seed``: views of one buffer a dtype."""
    leaves = flatten(layout)
    by_dtype: dict = {}
    for path, leaf in leaves:
        by_dtype.setdefault(leaf.dtype, []).append((path, tuple(leaf.shape)))
    out = []
    for i, (dt, items) in enumerate(sorted(by_dtype.items(),
                                           key=lambda kv: str(kv[0]))):
        n = sum(math.prod(s) for _, s in items)
        gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 1_000_003 + i) % (1 << 63))
        flat = torch.empty(n, device=device, dtype=dt)
        for part in flat.split(CHUNK):
            part.normal_(generator=gen)
        at = 0
        for path, shape in items:
            size = math.prod(shape)
            view = flat[at:at + size].view(shape)
            at += size
            kind, scale = init_kind(path, shape)
            if kind == "ones":
                view.fill_(1.0)
            elif kind == "zeros":
                view.zero_()
            else:
                view.mul_(scale)
            out.append((path, view))
    order = {p: i for i, (p, _) in enumerate(leaves)}
    out.sort(key=lambda pl: order[pl[0]])
    return unflatten(out)
