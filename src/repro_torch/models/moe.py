"""Mixture-of-experts FFN: grouped GShard-style capacity dispatch.

The torch counterpart of the JAX package's ``models/moe.py`` (its einsum
path).  Tokens are dispatched within fixed-size groups, so the dispatch
mask is ``(groups, group, E, C)`` with ``C = ceil(top_k * group / E * cf)``.
Routing is fp32: softmax over the experts, top-k, gates renormalised over
the k choices.  Each (token, choice) takes the next free slot of its expert,
counted token-major and choice-minor across the group; a choice past the
expert's capacity is dropped.  Everything is differentiable (one-hot
dispatch, no sorts).

Where no choice can drop, serving takes a second path, the dropless one:
the same routing, then the routed (token, choice) rows sorted by expert and
each expert's SwiGLU over its rows alone (``repro_torch.kernels.moe_experts``:
hand-written kernels on the card, the plain version on the CPU), then the
gate-weighted combine.  ``moe_ffn``
takes it when all of these hold, and the einsum path otherwise:
``capacity(moe, group) >= group`` (a token picks k distinct experts, so an
expert gets at most ``group`` choices and none overflows); autograd is off
(the serve engine's ``inference_mode``: the path has no backward); the
rank view is the whole (:data:`~repro_torch.models.sharding.WHOLE`, not a
dry-run rank's); the compute is bf16 or the call is on the CPU (the kernels
take bf16 alone, so an fp32 call on the card keeps the einsum path); and
the ep_a2a branch did not take the call.  The two paths compute the same
function there, in the same dtypes, and share the routing and the aux
loss.

A rank that holds part of the experts (``moe.held_experts`` of the
``num_experts`` the router scores, from ``held_offset``: expert parallelism
with this rank's share alone, its exchange with the others left out) routes
over all of them and computes the choices that land on its own: the
dropless kernels drop the others from their tiles (:func:`held_choices`),
the einsum path keeps their dispatch columns alone.  The result is this
rank's part of the layer's output.

``impl="ep_a2a"`` runs the explicit all-to-all expert parallelism
(``repro_torch.dist.ep_a2a.moe_ffn_ep_a2a``) when a sharding context
(``models.sharding.use_sharding``) carries a mesh on which
``ep_a2a_feasible`` holds, and the einsum path otherwise: without a context
(single-rank runs, the pipeline executor's stages, the compressed step) or
on an infeasible mesh.  That is the JAX package's rule; the two paths agree
at capacity parity.  :data:`EP_CALLS` counts the calls of each path, so a
run can show which one its MoE layers took.  The einsum and dropless paths,
from routing to combine, are the ``torch.profiler`` range ``moe.ffn``
(``obs.record.prange``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_experts.ops import moe_experts
from repro_torch.models.layers import _init_dense, dtype_of, proj
from repro_torch.models.sharding import WHOLE, rank_view

# moe_ffn calls by path since the last reset: "ep_a2a", "einsum" and
# "dropless"
EP_CALLS: dict[str, int] = {}


def reset_ep_calls() -> None:
    EP_CALLS.clear()


def init_moe(gen: torch.Generator, d_model: int, moe: MoEConfig,
             dtype) -> dict:
    """Router (fp32, whatever ``dtype``) and the experts' SwiGLU weights,
    stacked on a leading expert axis."""
    E, Fe = moe.num_experts, moe.d_ff_expert
    held = moe.held_experts or E
    p = {
        "router": _init_dense(gen, (d_model, E), d_model, torch.float32),
        "wg": _init_dense(gen, (held, d_model, Fe), d_model, dtype),
        "wu": _init_dense(gen, (held, d_model, Fe), d_model, dtype),
        "wd": _init_dense(gen, (held, Fe, d_model), Fe, dtype),
    }
    if moe.score_bias:
        p["router_bias"] = torch.zeros((E,), dtype=torch.float32,
                                       device=gen.device)
    return p


def moe_axes(moe: MoEConfig) -> dict:
    """The logical axes of :func:`init_moe`'s leaves.  Expert weights get
    their own logical axes, so rule overrides can re-shard them without
    touching the global "embed"/"ffn" activations; ``impl="ep_a2a"`` lays
    the experts over ``data`` and their FFN width over ``model``."""
    bias = {"router_bias": ("experts",)} if moe.score_bias else {}
    if moe.impl == "ep_a2a":
        return bias | {
            "router": ("embed", None),
            "wg": ("experts_ep", "expert_embed", "expert_ffn_ep"),
            "wu": ("experts_ep", "expert_embed", "expert_ffn_ep"),
            "wd": ("experts_ep", "expert_ffn_ep", "expert_embed"),
        }
    return bias | {
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
    probabilities (g, group, E; the sigmoid scores where ``moe.scoring`` is
    "sigmoid"), the renormalised gates and the chosen experts (g, group,
    k), each token's top choice first.  Sigmoid scoring chooses by the
    scores plus ``router_bias`` where ``moe.score_bias`` and gates by the
    scores alone, normalised over the k (+1e-20), as DeepSeek-V3's
    ``noaux_tc``; the gates times ``moe.routed_scaling``."""
    logits = proj(xg.float(), p["router"])
    if moe.scoring == "sigmoid":
        probs = torch.sigmoid(logits)
        pick = probs + p["router_bias"] if moe.score_bias else probs
        expert_idx = torch.topk(pick, moe.top_k, dim=-1).indices
        gate_vals = probs.gather(-1, expert_idx)
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = torch.topk(probs, moe.top_k, dim=-1)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
    if moe.routed_scaling != 1.0:
        gate_vals = gate_vals * moe.routed_scaling
    return probs, gate_vals, expert_idx


def held_choices(expert_idx: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    """Each choice's index among the experts this rank holds
    (``moe.held_offset`` ..  + ``held_experts``), -1 where another rank
    holds it; the choices themselves where the rank holds every expert."""
    if not moe.held_experts:
        return expert_idx
    local = expert_idx - moe.held_offset
    held = (local >= 0) & (local < moe.held_experts)
    return torch.where(held, local, torch.full_like(local, -1))


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
    # here, not at the top: repro_torch.obs imports dist.ep_a2a, which
    # imports this module
    from repro_torch.obs.record import prange

    cdt = dtype_of(compute_dtype)
    B, S, D = x.shape
    n_tok = B * S
    group = group_size(moe, n_tok)
    g = n_tok // group
    E = moe.num_experts
    C = capacity(moe, group)
    # the kernels take bf16 alone: an fp32 call on the card keeps the
    # einsum path (the plain version on the CPU takes both)
    dropless = (C >= group and not torch.is_grad_enabled()
                and rank_view() is WHOLE
                and (cdt == torch.bfloat16 or x.device.type == "cpu"))
    path = "dropless" if dropless else "einsum"
    EP_CALLS[path] = EP_CALLS.get(path, 0) + 1
    held = moe.held_experts or E
    if dropless and p["wg"].shape[0] != held:
        raise ValueError(f"moe_ffn: {p['wg'].shape[0]} experts' weights for "
                         f"{held} experts held")

    with prange("moe.ffn"):
        xg = x.reshape(g, group, D)
        probs, gate_vals, expert_idx = route(p, xg, moe)
        if dropless:
            # every routed (token, choice) over its expert's rows alone
            y = moe_experts(xg.reshape(n_tok, D).to(cdt),
                            gate_vals.reshape(n_tok, -1),
                            held_choices(expert_idx.reshape(n_tok, -1), moe),
                            p["wg"].to(cdt), p["wu"].to(cdt),
                            p["wd"].to(cdt), partial=moe.held_experts > 0)
        else:
            _, dispatch, combine = assign(probs, gate_vals, expert_idx, E, C)
            if moe.held_experts:
                lo = moe.held_offset
                dispatch = dispatch[:, :, lo:lo + held]
                combine = combine[:, :, lo:lo + held]
            # a dry-run rank's experts (routing ran over all E); else all E
            dispatch, combine = rank_view().experts(dispatch, combine,
                                                    p["wg"].shape[0])

            # -- expert compute -----------------------------------------------
            expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(cdt),
                                     xg.to(cdt))
            gph = torch.einsum("egcd,edf->egcf", expert_in, p["wg"].to(cdt))
            uph = torch.einsum("egcd,edf->egcf", expert_in, p["wu"].to(cdt))
            h = F.silu(gph) * uph
            expert_out = torch.einsum("egcf,efd->egcd", h, p["wd"].to(cdt))

            # -- combine ------------------------------------------------------
            y = torch.einsum("gsec,egcd->gsd", combine.to(cdt), expert_out)
        y = y.reshape(B, S, D)

    # -- load-balance auxiliary loss (Switch/GShard): the fraction of tokens
    # whose top choice is each expert times its mean router probability
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx[:, :, 0], E).float().mean(dim=(0, 1))
    aux = moe.router_aux_loss * E * (me * ce).sum()
    return y, aux
