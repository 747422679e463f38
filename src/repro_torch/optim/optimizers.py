"""Optimizers on nested dicts of tensors, the JAX package's
``optim/optimizers.py`` in torch.

* ``adamw``    — AdamW with decoupled weight decay and bias correction;
  moment dtype configurable (fp32 default, bf16 for memory-tight configs).
* ``adafactor`` — factored second moment for >=2-D parameters (row/col
  statistics, Shazeer & Stern 2018).

API mirrors the JAX package's: ``opt.init(params) -> state``,
``opt.update(grads, state, params, lr) -> (updates, state)`` where updates
are ADDED to params.  Each update runs the same operations in the same order
and dtypes as there.  AdamW writes its new moments into the state's own
tensors (the JAX step donates the state; at 2.7B parameters a second copy of
both moments would not fit the card beside the rest of the step), so the
returned state holds the same tensors as the one passed in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(
        sum(l.float().square().sum() for l in leaves(tree))
    )


def clip_by_global_norm(tree, max_norm: float, *, inplace: bool = False):
    """(tree scaled to a global norm of at most ``max_norm``, the norm).

    ``inplace`` writes the scaled leaves into the given ones (the train
    step owns its gradients, and a second copy of a bf16 model's gradients
    would sit beside the first through the optimizer); the numbers are the
    same either way."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(g):
        if inplace and g.dtype == torch.float32:
            return g.mul_(scale)
        if inplace:
            return g.copy_((g.float() * scale).to(g.dtype))
        return (g.float() * scale).to(g.dtype)

    return tree_map(clip, tree), norm


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (updates, new_state)


def _count(params) -> torch.Tensor:
    dev = leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    moment_dtype=torch.float32,
) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

        return {
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "count": _count(params),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.float()
        bc1 = 1.0 - b1**c
        bc2 = 1.0 - b2**c

        def upd(g, m, v, p):
            g32 = g.float()
            # m32 = m * b1 + g * (1 - b1), v32 = v * b2 + g^2 * (1 - b2),
            # written into m and v (fp32 moments alias their fp32 view)
            m32 = m.float().mul_(b1).add_(g32 * (1 - b1))
            v32 = v.float().mul_(b2).add_(g32.square().mul_(1 - b2))
            den = (v32 / bc2).sqrt_().add_(eps)
            step = (m32 / bc1).div_(den)
            del den
            step.add_(weight_decay * p.float())
            for dst, src in ((m, m32), (v, v32)):
                if src is not dst:
                    dst.copy_(src)
            return step.mul_(-lr).to(p.dtype)

        updates = tree_map(upd, grads, state["m"], state["v"], params)
        return updates, {"m": state["m"], "v": state["v"], "count": count}

    return Optimizer("adamw", init, update)


def adafactor(
    eps: float = 1e-30,
    decay: float = 0.8,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Factored second-moment optimizer (no first moment)."""

    def _factored(p) -> bool:
        return p.ndim >= 2

    def init(params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {
                    "vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
                }
            return {"v": torch.zeros(p.shape, **f32)}

        return {"f": _map_leaves(one, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.float()
        beta = 1.0 - c ** (-decay)  # increasing-decay schedule

        def upd(g, s, p):
            g32 = g.float()
            g2 = g32.square() + eps
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                rfac = vr / torch.clamp(denom, min=eps)
                step = g32 / (
                    torch.sqrt(rfac)[..., None] * torch.sqrt(vc)[..., None, :]
                    + eps
                )
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                step = g32 / (torch.sqrt(v) + eps)
                new_s = {"v": v}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(step.square().mean() + 1e-30)
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr * step).to(p.dtype), new_s

        out = _map_leaves(upd, grads, state["f"], params)
        updates = _map_leaves(lambda t: t[0], out)
        new_f = _map_leaves(lambda t: t[1], out)
        return updates, {"f": new_f, "count": count}

    return Optimizer("adafactor", init, update)


def _map_leaves(fn, tree, *rest):
    """``tree_map`` down to ``tree``'s leaves only: the matching entries of
    ``rest`` (adafactor's per-leaf ``{"v"}`` / ``{"vr", "vc"}`` dicts, or
    ``(update, state)`` pairs) are handed to ``fn`` whole."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
