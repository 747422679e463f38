"""Mixture-of-experts FFN: grouped GShard-style capacity dispatch.

The torch counterpart of the JAX package's ``models/moe.py`` (its einsum
path).  Tokens are dispatched within fixed-size groups, so the dispatch
mask is ``(groups, group, E, C)`` with ``C = ceil(top_k * group / E * cf)``.
Routing is fp32: softmax over the experts, top-k, gates renormalised over
the k choices.  Each (token, choice) takes the next free slot of its expert,
counted token-major and choice-minor across the group; a choice past the
expert's capacity is dropped.  Everything is differentiable (one-hot
dispatch, no sorts), so one path serves training and serving.

The explicit all-to-all expert parallelism (``impl="ep_a2a"``) needs a mesh,
and the port has none yet (ROADMAP.md, 'Distributed'): it takes the einsum
path, as the JAX package does when no mesh context is set.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import _init_dense, dtype_of


def init_moe(gen: torch.Generator, d_model: int, moe: MoEConfig,
             dtype) -> dict:
    """Router (fp32, whatever ``dtype``) and the experts' SwiGLU weights,
    stacked on a leading expert axis."""
    E, Fe = moe.num_experts, moe.d_ff_expert
    return {
        "router": _init_dense(gen, (d_model, E), d_model, torch.float32),
        "wg": _init_dense(gen, (E, d_model, Fe), d_model, dtype),
        "wu": _init_dense(gen, (E, d_model, Fe), d_model, dtype),
        "wd": _init_dense(gen, (E, Fe, d_model), Fe, dtype),
    }


def capacity(moe: MoEConfig, group: int) -> int:
    return max(
        1, int(math.ceil(moe.top_k * group / moe.num_experts
                         * moe.capacity_factor))
    )


def group_size(moe: MoEConfig, n_tok: int) -> int:
    """Tokens per dispatch group: ``moe.group_size``, or all the tokens in
    one group when there are fewer or they do not divide evenly."""
    group = min(moe.group_size, n_tok)
    return group if n_tok % group == 0 else n_tok


def route(p, xg: torch.Tensor, moe: MoEConfig):
    """fp32 routing of grouped tokens xg (g, group, D): the router's
    probabilities (g, group, E), the renormalised gates and the chosen
    experts (g, group, k), each token's top choice first."""
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, moe.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx


def moe_ffn(p, x: torch.Tensor, moe: MoEConfig, compute_dtype):
    """x: (B, S, D) -> (y, aux_loss)."""
    cdt = dtype_of(compute_dtype)
    B, S, D = x.shape
    n_tok = B * S
    group = group_size(moe, n_tok)
    g = n_tok // group
    E, k = moe.num_experts, moe.top_k
    C = capacity(moe, group)

    xg = x.reshape(g, group, D)
    probs, gate_vals, expert_idx = route(p, xg, moe)

    # -- capacity assignment --------------------------------------------------
    oh_e = F.one_hot(expert_idx, E).float()                    # (g, s, k, E)
    oh_flat = oh_e.reshape(g, group * k, E)
    pos = (torch.cumsum(oh_flat, dim=1) - oh_flat).reshape(g, group, k, E)
    pos_tok = (pos * oh_e).sum(-1)        # (g, s, k) slot in the chosen expert
    keep = pos_tok < C
    # a dropped choice takes the extra class C, which is cut off: it one-hots
    # to nothing (JAX's one_hot of an out-of-range index)
    slot = torch.where(keep, pos_tok, torch.full_like(pos_tok, C)).long()
    oh_c = F.one_hot(slot, C + 1)[..., :C].float()             # (g, s, k, C)

    dispatch = torch.einsum("gske,gskc->gsec", oh_e, oh_c)
    combine = torch.einsum("gske,gskc,gsk->gsec", oh_e, oh_c, gate_vals)

    # -- expert compute -------------------------------------------------------
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(cdt), xg.to(cdt))
    gph = torch.einsum("egcd,edf->egcf", expert_in, p["wg"].to(cdt))
    uph = torch.einsum("egcd,edf->egcf", expert_in, p["wu"].to(cdt))
    h = F.silu(gph) * uph
    expert_out = torch.einsum("egcf,efd->egcd", h, p["wd"].to(cdt))

    # -- combine --------------------------------------------------------------
    y = torch.einsum("gsec,egcd->gsd", combine.to(cdt), expert_out)
    y = y.reshape(B, S, D)

    # -- load-balance auxiliary loss (Switch/GShard): the fraction of tokens
    # whose top choice is each expert times its mean router probability
    me = probs.mean(dim=(0, 1))
    ce = oh_e[:, :, 0, :].mean(dim=(0, 1))
    aux = moe.router_aux_loss * E * (me * ce).sum()
    return y, aux
