"""Mixture-of-experts FFN: grouped GShard-style capacity dispatch.

The torch counterpart of the JAX package's ``models/moe.py`` (its einsum
path).  Tokens are dispatched within fixed-size groups, so the dispatch
mask is ``(groups, group, E, C)`` with ``C = ceil(top_k * group / E * cf)``.
Routing is fp32: softmax over the experts, top-k, gates renormalised over
the k choices.  Each (token, choice) takes the next free slot of its expert,
counted token-major and choice-minor across the group; a choice past the
expert's capacity is dropped.  Everything is differentiable (one-hot
dispatch, no sorts), so one path serves training and serving.

``impl="ep_a2a"`` runs the explicit all-to-all expert parallelism
(``repro_torch.dist.ep_a2a.moe_ffn_ep_a2a``) when a sharding context
(``models.sharding.use_sharding``) carries a mesh on which
``ep_a2a_feasible`` holds, and the einsum path otherwise: without a context
(single-rank runs, the pipeline executor's stages, the compressed step) or
on an infeasible mesh.  That is the JAX package's rule; the two paths agree
at capacity parity.  :data:`EP_CALLS` counts the calls of each path, so a
run can show which one its MoE layers took.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import _init_dense, dtype_of, proj
from repro_torch.models.sharding import rank_view

# moe_ffn calls by path since the last reset: "ep_a2a" and "einsum"
EP_CALLS: dict[str, int] = {}


def reset_ep_calls() -> None:
    EP_CALLS.clear()


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


def moe_axes(moe: MoEConfig) -> dict:
    """The logical axes of :func:`init_moe`'s leaves.  Expert weights get
    their own logical axes, so rule overrides can re-shard them without
    touching the global "embed"/"ffn" activations; ``impl="ep_a2a"`` lays
    the experts over ``data`` and their FFN width over ``model``."""
    if moe.impl == "ep_a2a":
        return {
            "router": ("embed", None),
            "wg": ("experts_ep", "expert_embed", "expert_ffn_ep"),
            "wu": ("experts_ep", "expert_embed", "expert_ffn_ep"),
            "wd": ("experts_ep", "expert_ffn_ep", "expert_embed"),
        }
    return {
        "router": ("embed", "experts"),
        "wg": ("experts", "expert_embed", "expert_ffn"),
        "wu": ("experts", "expert_embed", "expert_ffn"),
        "wd": ("experts", "expert_ffn", "expert_embed"),
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
    logits = proj(xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, moe.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx


def assign(probs, gate_vals, expert_idx, E: int, C: int):
    """Capacity assignment of routed groups: each (token, choice) takes the
    next free slot of its expert, counted token-major and choice-minor
    across the group; a choice past capacity ``C`` is dropped.  Returns
    the one-hot choices (g, s, k, E) and the fp32 dispatch and combine
    masks (g, s, E, C)."""
    g, group, k = expert_idx.shape
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
    return oh_e, dispatch, combine


def moe_ffn(p, x: torch.Tensor, moe: MoEConfig, compute_dtype):
    """x: (B, S, D) -> (y, aux_loss)."""
    if moe.impl == "ep_a2a":
        from repro_torch.models.sharding import current_ctx

        ctx = current_ctx()
        if ctx is not None and ctx.rank is None:
            from repro_torch.dist.ep_a2a import (
                ep_a2a_feasible,
                moe_ffn_ep_a2a,
            )

            if ep_a2a_feasible(x.shape, moe, ctx.mesh):
                EP_CALLS["ep_a2a"] = EP_CALLS.get("ep_a2a", 0) + 1
                return moe_ffn_ep_a2a(p, x, moe, compute_dtype, ctx.mesh)
    EP_CALLS["einsum"] = EP_CALLS.get("einsum", 0) + 1
    cdt = dtype_of(compute_dtype)
    B, S, D = x.shape
    n_tok = B * S
    group = group_size(moe, n_tok)
    g = n_tok // group
    E = moe.num_experts
    C = capacity(moe, group)

    xg = x.reshape(g, group, D)
    probs, gate_vals, expert_idx = route(p, xg, moe)
    oh_e, dispatch, combine = assign(probs, gate_vals, expert_idx, E, C)
    # a dry-run rank's experts (routing ran over all E); else all E
    dispatch, combine = rank_view().experts(dispatch, combine,
                                            p["wg"].shape[0])

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
