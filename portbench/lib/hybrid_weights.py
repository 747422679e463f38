"""Weights of a hybrid Mamba-2 / attention model made from the seed.

Every leaf but three comes from ``lib.weights.make_weights``.  The Mamba-2
mixer's per-head vectors are drawn by Mamba-2's published initialisation,
so the random model's decays lie where a trained model's start: ``A_log`` =
log A with A uniform in [1, 16]; ``dt_bias`` the inverse softplus of a dt
log-uniform in [0.001, 0.1] (at least 1e-4); ``D_skip`` ones.  A state
dropped between prefill chunks then shows in the logits: the slowest heads
keep a token for about a hundred positions.  The same seed on the same
device gives the same values.

``embedding_multiplier``: the embedding is drawn at ``make_weights``'s
scale over it, so the scaled rows enter the residual stream at the norm
every other configuration's do (1).  At ``make_weights``'s own scale the
tied head would read each position's own token back: its logit, the
multiplier times the row's squared norm, clears the ~100,000 others by
about five of their standard deviations, every position would serve its
input token again, and no dropped state or lower precision could move the
comparison.
"""
from __future__ import annotations

import math

import torch

from portbench.kinds.common import sub_seed
from portbench.lib import weights

MAMBA_VECTORS = ("A_log", "dt_bias", "D_skip")
A_RANGE = (1.0, 16.0)
DT_RANGE = (0.001, 0.1)
DT_FLOOR = 1e-4


def mamba_vector(key: str, shape: tuple, gen: torch.Generator,
                 device) -> torch.Tensor:
    """One of :data:`MAMBA_VECTORS`, float32, drawn from ``gen``."""
    if key == "D_skip":
        return torch.ones(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    if key == "A_log":
        lo, hi = A_RANGE
        return torch.log(lo + (hi - lo) * u)
    lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
    dt = torch.exp(lo + (hi - lo) * u).clamp(min=DT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))       # softplus(dt_bias) = dt


def make_weights(layout, seed: int, device,
                 embedding_multiplier: float = 1.0) -> dict:
    """Tensors for every leaf of ``layout``, from ``seed``."""
    pairs = weights.flatten(layout)
    rest = [(p, leaf) for p, leaf in pairs
            if p.split(".")[-1] not in MAMBA_VECTORS]
    made = dict(weights.flatten(weights.make_weights(
        weights.unflatten(rest), seed, device)))
    made["embed"].div_(embedding_multiplier)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    for path, leaf in pairs:
        key = path.split(".")[-1]
        if key in MAMBA_VECTORS:
            made[path] = mamba_vector(key, tuple(leaf.shape), gen, device)
    return weights.unflatten([(p, made[p]) for p, _ in pairs])
