"""Plain reference of the encoder-decoder (the seamless-m4t backbone as the
port states it), and of its training step.

The model: frames (B, S_src, F) through a linear frontend and
``encoder_layers`` pre-norm layers (RMSNorm, bidirectional self-attention
with RoPE, RMSNorm, SwiGLU), a final encoder norm; target tokens through an
embedding and ``layers`` decoder layers (causal self-attention with RoPE,
cross-attention over the memory without RoPE, SwiGLU, each behind its
RMSNorm), a final norm and an untied head; the loss is the mean next-token
cross-entropy over every target token.  Weights come in the benchmark's
tree (``encoder``/``decoder`` stacked on a leading layer axis).

The step is the program's contract: the gradient of the mean loss over the
whole batch, clipped to a global norm of ``clip``, then AdamW (b1 0.9, b2
0.95, eps 1e-8, decoupled weight decay 0.1 on every leaf, bias correction)
at the cosine warm-up schedule's rate.  It runs in blocks of ``rows_per_block``
rows, each layer recomputed in the backward pass, so that it fits beside the
optimizer state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (
    Precision, attention, rmsnorm, rope, swiglu,
)


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _self_attn(pr, p, x, pos, theta, causal):
    b, s, _ = x.shape
    q = pr.mm(x, p["wq"].flatten(1)).view(b, s, *p["wq"].shape[1:])
    k = pr.mm(x, p["wk"].flatten(1)).view(b, s, *p["wk"].shape[1:])
    v = pr.mm(x, p["wv"].flatten(1)).view(b, s, *p["wv"].shape[1:])
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    o = attention(pr, q, k, v, causal=causal)
    return pr.mm(o.flatten(2), p["wo"].flatten(0, 1))


def _cross_attn(pr, p, x, mem):
    b, s, _ = x.shape
    q = pr.mm(x, p["wq"].flatten(1)).view(b, s, *p["wq"].shape[1:])
    k = pr.mm(mem, p["wk"].flatten(1)).view(b, mem.shape[1],
                                            *p["wk"].shape[1:])
    v = pr.mm(mem, p["wv"].flatten(1)).view(b, mem.shape[1],
                                            *p["wv"].shape[1:])
    o = attention(pr, q, k, v, causal=False)
    return pr.mm(o.flatten(2), p["wo"].flatten(0, 1))


def loss_sum(w: dict, frames, tokens, labels, dims: dict,
             pr: Precision) -> torch.Tensor:
    """Sum of the next-token cross-entropy over the rows given."""
    eps, theta = dims["norm_eps"], dims["rope_theta"]
    h = pr.mm(frames.float(), w["frontend"])
    pos = torch.arange(h.shape[1], device=h.device)

    def enc(hh, lp):
        n = rmsnorm(hh, lp["norm1"], eps)
        hh = hh + _self_attn(pr, lp["attn"], n, pos, theta, causal=False)
        n = rmsnorm(hh, lp["norm2"], eps)
        m = lp["mlp"]
        return hh + swiglu(pr, n, m["wg"], m["wu"], m["wd"])

    for i in range(dims["encoder_layers"]):
        h = checkpoint(enc, h, _layer(w["encoder"], i), use_reentrant=False)
    mem = rmsnorm(h, w["enc_norm"], eps)

    x = w["embed"][tokens].float()
    tpos = torch.arange(x.shape[1], device=x.device)

    def dec(xx, lp, mm):
        n = rmsnorm(xx, lp["norm1"], eps)
        xx = xx + _self_attn(pr, lp["self"], n, tpos, theta, causal=True)
        n = rmsnorm(xx, lp["norm2"], eps)
        xx = xx + _cross_attn(pr, lp["cross"], n, mm)
        n = rmsnorm(xx, lp["norm3"], eps)
        m = lp["mlp"]
        return xx + swiglu(pr, n, m["wg"], m["wu"], m["wd"])

    for i in range(dims["layers"]):
        x = checkpoint(dec, x, _layer(w["decoder"], i), mem,
                       use_reentrant=False)
    x = rmsnorm(x, w["final_norm"], eps)
    logits = pr.mm(x, w["head"])
    return F.cross_entropy(logits.flatten(0, 1), labels.flatten().long(),
                           reduction="sum")


def cosine_lr(step: int, base: float, warmup: int, total: int,
              min_ratio: float = 0.1) -> float:
    """The cosine schedule with linear warm-up, at ``step`` (from 0)."""
    warm = min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return base * warm * (min_ratio + (1 - min_ratio) * cos)


def _leaves(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_leaves(v, f"{prefix}{k}."))
        else:
            out.append((f"{prefix}{k}", v))
    return out


def train_steps(w: dict, batches: list, dims: dict, opt: dict,
                pr: Precision, rows_per_block: int = 2) -> dict:
    """The reference's steps from weights ``w`` (leaves updated in place),
    one a batch of ``batches``.  Returns each step's loss, the first step's
    clipped gradient norm by leaf, and every leaf's change over the steps
    as a norm; the start values are copied first."""
    leaves = _leaves(w)
    for _, t in leaves:
        t.requires_grad_(True)
    start = {n: t.detach().clone() for n, t in leaves}
    m = {n: torch.zeros_like(t) for n, t in leaves}
    v = {n: torch.zeros_like(t) for n, t in leaves}
    losses, first_grad = [], {}
    for step, batch in enumerate(batches):
        rows = batch["tokens"].shape[0]
        count = batch["tokens"].numel()
        grads = {n: torch.zeros_like(t) for n, t in leaves}
        total = 0.0
        for r0 in range(0, rows, rows_per_block):
            sl = slice(r0, r0 + rows_per_block)
            loss = loss_sum(w, batch["frames"][sl], batch["tokens"][sl],
                            batch["labels"][sl], dims, pr) / count
            gs = torch.autograd.grad(loss, [t for _, t in leaves])
            for (n, _), g in zip(leaves, gs):
                grads[n].add_(g)
            total += float(loss.detach())
            del gs, loss
        losses.append(total)
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(opt["clip"] / torch.clamp(norm, min=1e-9),
                                max=1.0)
            for g in grads.values():
                g.mul_(scale)
            if step == 0:
                first_grad = {n: float(g.norm()) for n, g in grads.items()}
            lr = cosine_lr(step, opt["lr"], opt["warmup"], opt["total_steps"])
            c = step + 1
            bc1, bc2 = 1 - opt["b1"] ** c, 1 - opt["b2"] ** c
            for n, t in leaves:
                g = grads[n]
                m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[n].mul_(opt["b2"]).add_(g.square(), alpha=1 - opt["b2"])
                upd = (m[n] / bc1) / ((v[n] / bc2).sqrt() + opt["eps"])
                upd.add_(t, alpha=opt["weight_decay"])
                t.add_(upd, alpha=-lr)
        del grads
    with torch.no_grad():
        change = {n: float((t - start[n]).norm()) for n, t in leaves}
    return {"losses": losses, "first_grad": first_grad, "change": change}
