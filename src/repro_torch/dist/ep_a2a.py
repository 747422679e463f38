"""Expert-parallel MoE FFN with explicit all-to-all dispatch.

The torch counterpart of the JAX package's ``dist/ep_a2a.py``.  The einsum
MoE (``repro_torch.models.moe.moe_ffn``) holds every expert where the
tokens are.  Here the experts are sharded over ``data`` (expert
parallelism) and their FFN width over ``model``: each data rank routes its
own batch rows, and only the *routed* capacity slots move, in two
all-to-alls (dispatch, return).  Routing, capacity assignment and the expert
FFN math are the einsum path's, and each rank's tokens form whole routing
groups of the einsum path's global size (:func:`ep_a2a_feasible`), so the
two paths assign the same capacities and drop the same choices.

The JAX version is one ``shard_map`` body run on every device of the mesh.
Here one process runs that body's phases over every rank of the port's
logical-rank mesh in turn (``repro_torch.dist.mesh``): route and dispatch on
each rank, the all-to-all over ``data``, the local expert FFN (wg/wu split
by column over ``model``, wd by row, a ``psum`` over ``model``), the return
all-to-all, the combine, and the aux loss from the ``pmean`` over ``data``
of each rank's means.  A rank's weights are its shards
(``models.sharding.shards``): views where the rank shares the weights'
device, so on one card nothing is copied but the exchanged slots.

``moe_a2a_bytes`` is the simulator-facing twin: the per-rank payload of one
dispatch (or return) all-to-all, which ``repro_torch.core.estimator`` prices
and ``mesh.TRAFFIC["all_to_all"]`` counts as executed.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.moe import assign, capacity, group_size, route
from repro_torch.models.sharding import P, shards


def ep_a2a_feasible(
    x_shape, moe: MoEConfig, mesh,
    data_axis: str = "data", model_axis: str = "model",
) -> bool:
    """Whether the explicit-EP layout divides evenly on this mesh.

    Requires: experts and batch divisible by the data-axis size, expert FFN
    width divisible by the model-axis size (when present), and each shard's
    local tokens forming whole *global-size* routing groups — the per-shard
    grouping must reproduce the einsum path's global grouping exactly, or
    the two paths would assign different capacities and drop different
    tokens.
    """
    sizes = mesh.sizes
    dp = sizes.get(data_axis, 0)
    if dp < 1:
        return False
    tp = sizes.get(model_axis, 1)
    B, S, _ = x_shape
    if moe.num_experts % dp or B % dp or moe.d_ff_expert % tp:
        return False
    group = group_size(moe, B * S)
    n_loc = (B // dp) * S
    return n_loc % group == 0


def moe_ffn_ep_a2a(
    p, x: torch.Tensor, moe: MoEConfig, compute_dtype, mesh,
    data_axis: str = "data", model_axis: str = "model",
):
    """x: (B, S, D), its rows split over ``data`` -> (y, aux_loss), both on
    x's device.

    Parameter layout (the ``impl == "ep_a2a"`` axes of ``moe.moe_axes``):
    router replicated; wg/wu ``P(data, None, model)``; wd
    ``P(data, model, None)`` — experts over ``data``, FFN width over
    ``model`` (Megatron column/row split, one psum over ``model``).
    """
    cdt = dtype_of(compute_dtype)
    sizes = mesh.sizes
    if data_axis not in sizes:
        raise ValueError(f"mesh axes {mesh.axis_names} have no "
                         f"{data_axis!r} axis")
    dp = sizes[data_axis]
    tp = sizes.get(model_axis, 1)
    B, S, D = x.shape
    E, Fe = moe.num_experts, moe.d_ff_expert
    if B % dp or E % dp or Fe % tp:
        raise ValueError(
            f"batch {B} and {E} experts must divide over {dp} data ranks "
            f"and the expert width {Fe} over {tp} model ranks")
    n_loc = (B // dp) * S
    # the einsum path's GLOBAL group size — shards must tile it exactly
    # (guaranteed by ep_a2a_feasible) so capacities match across impls
    group = group_size(moe, B * S)
    if n_loc % group:
        raise ValueError(
            f"local tokens {n_loc} (x {tuple(x.shape)} over {dp} data "
            f"ranks) not a multiple of the global group {group}; gate on "
            "ep_a2a_feasible before dispatching here")
    g = n_loc // group
    C = capacity(moe, group)
    e_loc = E // dp
    model = model_axis if model_axis in sizes else None

    router = shards(p["router"], P(), mesh)
    wg = shards(p["wg"], P(data_axis, None, model), mesh)
    wu = shards(p["wu"], P(data_axis, None, model), mesh)
    wd = shards(p["wd"], P(data_axis, model, None), mesh)
    xs = shards(x, P(data_axis, None, None), mesh)
    coords = mesh.coords()

    # -- routing + capacity on each rank: the einsum path's math -----------
    combine, me, ce, expert_in = {}, {}, {}, {}
    for c in coords:
        xg = xs[c].reshape(g, group, D)
        probs, gate_vals, expert_idx = route({"router": router[c]}, xg, moe)
        oh_e, dispatch, combine[c] = assign(probs, gate_vals, expert_idx,
                                            E, C)
        me[c] = probs.mean(dim=(0, 1))
        ce[c] = oh_e[:, :, 0, :].mean(dim=(0, 1))
        ein = torch.einsum("gsec,gsd->egcd", dispatch.to(cdt), xg.to(cdt))
        expert_in[c] = ein.reshape(dp, e_loc, g, C, D)

    # -- dispatch a2a: route capacity slots to their expert's shard ---------
    if dp > 1:
        expert_in = mesh.all_to_all(expert_in, data_axis, 0, 0)

    # -- local expert FFN (column/row split over the model axis) ------------
    out = {}
    for c in coords:
        # dim 0 now indexes the source data shard; fold into the group dim
        ein = expert_in[c].transpose(0, 1).reshape(e_loc, dp * g, C, D)
        gph = torch.einsum("egcd,edf->egcf", ein, wg[c].to(cdt))
        uph = torch.einsum("egcd,edf->egcf", ein, wu[c].to(cdt))
        h = torch.nn.functional.silu(gph) * uph
        out[c] = torch.einsum("egcf,efd->egcd", h, wd[c].to(cdt))
    del expert_in
    if tp > 1:
        out = mesh.psum(out, model_axis)

    # -- return a2a: capacity slots back to their token's shard -------------
    out = {c: o.reshape(e_loc, dp, g, C, D).transpose(0, 1)
           for c, o in out.items()}
    if dp > 1:
        out = mesh.all_to_all(out, data_axis, 0, 0)

    # -- combine, and the aux loss from the GLOBAL means (shards hold equal
    # token counts, so the pmean of the local means is exact)
    me, ce = mesh.pmean(me, data_axis), mesh.pmean(ce, data_axis)
    # y is the same on every model rank of a data rank: read it at model
    # (and any other axis) 0
    di = mesh.axis_names.index(data_axis)
    home = [tuple(d if i == di else 0 for i in range(len(mesh.axis_names)))
            for d in range(dp)]
    ys = [torch.einsum("gsec,egcd->gsd", combine[c].to(cdt),
                       out[c].reshape(E, g, C, D)).reshape(B // dp, S, D)
          for c in home]
    y = torch.cat([t.to(x.device) for t in ys])
    aux = moe.router_aux_loss * E * (me[home[0]] * ce[home[0]]).sum()
    return y, aux.to(x.device)


# ---------------------------------------------------------------------------
# Simulator-facing byte accounting
# ---------------------------------------------------------------------------


def a2a_payload_bytes(
    num_experts: int,
    top_k: int,
    capacity_factor: float,
    group_size: int,
    tokens_local: int,
    d_model: int,
    itemsize: int = 4,
) -> float:
    """Per-rank payload of ONE dispatch (or return) all-to-all.

    Each rank ships its full dispatched-capacity tensor ``(E, groups, C,
    D)`` through the a2a (the ring model's ``(g-1)/g`` wire factor is
    applied by ``repro_torch.core.hardware.wire_bytes``).  Takes primitives
    rather than a MoEConfig so graph-node annotations
    (``repro_torch.core.strategy.moe_a2a_node_meta``) can round-trip
    through it.
    """
    group = min(group_size, tokens_local)
    if tokens_local % group:
        group = tokens_local
    g = tokens_local // group
    cap = max(1, int(math.ceil(top_k * group / num_experts * capacity_factor)))
    return float(num_experts * g * cap * d_model * itemsize)


def moe_a2a_bytes(
    moe: MoEConfig, n_tokens_local: int, d_model: int, itemsize: int = 4
) -> float:
    """:func:`a2a_payload_bytes` for a :class:`MoEConfig`."""
    return a2a_payload_bytes(
        moe.num_experts, moe.top_k, moe.capacity_factor, moe.group_size,
        n_tokens_local, d_model, itemsize,
    )
