"""Pipeline parallelism over the ``stage`` axis of a logical-rank mesh.

The torch counterpart of the JAX package's ``dist/pp.py``.  Two executors
share one schedule source (``repro_torch.dist.schedules``):

``make_scheduled_body`` / ``pipeline_stage_shard_map`` — the scheduled
executor.  It runs the *same* (stage, microbatch, phase) step table the
simulator's ``repro_torch.core.strategy.pipeline_graph`` turns into a
DataflowGraph: one tick per row of the schedule's ``ExecutorPlan``, each
stage rank doing its scheduled forward or backward step.  A forward step
runs the rank's layer chunk on its input (the model's embedding first, on
the first virtual stage) and keeps the chunk's autograd graph; the chunk's
backward step is ``torch.autograd.backward`` on the outputs kept from that
forward, seeded with the cotangent that arrived over the wire (or from the
loss on the last virtual stage), accumulating into the chunk's parameter
gradients — the counterpart of the reference's per-chunk ``jax.vjp``.
Activations and cotangents cross virtual-stage boundaries through
``mesh.ppermute`` at the start of the tick after they were produced, only
where the plan marks the receive valid (the reference's ``overlap`` mode:
no dead exchange is issued).  GPipe, 1F1B and interleaved-1F1B all run
through it.

``pipeline_step_shard_map`` — the forward wavefront (backward by autograd
through the hops), kept as the cheap path when only outputs are needed.

The mesh's ranks run one after another in this single-controller process
(``repro_torch.dist.mesh``); a stage rank's parameters are views of the
model's layer stack on the rank's device, copied there if it is another.

Byte-accounting twins: ``boundary_bytes`` / ``pipeline_transfer_bytes`` /
``schedule_transfer_bytes`` give the exact bytes each table moves, which is
what the executors' hops add to ``mesh.TRAFFIC["ppermute"]``.
"""
from __future__ import annotations

import torch

from repro_torch.dist import mesh as Mesh_
from repro_torch.dist.schedules import (
    DO_BWD,
    DO_BWD_LAST,
    DO_FWD,
    NOOP,
    PipelineSchedule,
    build_executor_plan,
)
from repro_torch.models.layers import dtype_of
from repro_torch.tree import leaves, tree_map


def _layer_trees(params_local) -> list:
    """A stacked-layer tree (or one stacked tensor) as per-layer views:
    ``unbind``, whose gradient is one ``stack``."""
    if torch.is_tensor(params_local):
        return list(params_local.unbind(0))
    from repro_torch.models.transformer import unbind_layers

    return unbind_layers(params_local)


def _stage_apply(params_local, x, layer_fn):
    """Run a stage's layer slice in order (the reference's scan)."""
    for p_layer in _layer_trees(params_local):
        x = layer_fn(p_layer, x)
    return x


def pipeline_step_shard_map(params, xs: torch.Tensor, layer_fn, mesh,
                            axis_name: str = "stage"):
    """Forward a stack of layers through the ``axis_name`` ranks.

    ``params``: tree of per-layer stacked leaves, leading dim L divisible by
    the stage count S; stage s runs layers [s L/S, (s+1) L/S).  ``xs``:
    microbatched inputs (M, batch, d).  Tick t, stage s works on
    microbatch t - s and hands its output to stage s + 1.  Returns the
    last stage's outputs (M, batch, d); differentiable through the hops.
    """
    S = mesh.size(axis_name)
    M = xs.shape[0]
    lead = {int(leaf.shape[0]) for leaf in leaves(params)}
    assert len(lead) == 1, f"per-layer leaves disagree on layer count: {lead}"
    (L,) = lead
    assert L % S == 0, f"layers {L} % stages {S} != 0"
    per = L // S
    devices = mesh.group_devices(axis_name, (0,) * len(mesh.shape))
    local = [tree_map(lambda p, s=s: p[s * per:(s + 1) * per].to(devices[s]),
                      params) for s in range(S)]
    buf: list = [None] * S
    ys: list = [None] * M
    for t in range(M + S - 1):
        out: list = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            x_in = xs[m].to(devices[0]) if s == 0 else buf[s]
            out[s] = _stage_apply(local[s], x_in, layer_fn)
            if s == S - 1:
                ys[m] = out[s]
        buf = Mesh_.ppermute(out, devices,
                             [(i, i + 1) for i in range(S - 1)
                              if out[i] is not None])
    return torch.stack(ys)


# ---------------------------------------------------------------------------
# Scheduled executor: fwd AND bwd driven by the shared step table
# ---------------------------------------------------------------------------


def _device_major(leaf, n_stages: int, vstages: int, axis: int = 0):
    """(L, ...) layer stack -> (S*v, L/(S*v), ...) with device-major rows:
    row ``s*v + c`` holds the layers of virtual stage ``k = s + c*S``, so
    stage s's rows are its v chunks in local-chunk order.  ``axis`` selects
    the layer dimension (residual trees carry a leading replica axis)."""
    x = leaf.movedim(axis, 0)
    L = x.shape[0]
    V = n_stages * vstages
    per_chunk = L // V
    resh = x.reshape((vstages, n_stages, per_chunk) + tuple(x.shape[1:]))
    out = resh.movedim(0, 1).reshape((V, per_chunk) + tuple(x.shape[1:]))
    return out.movedim((0, 1), (axis, axis + 1))


def _layer_major(leaf, n_stages: int, vstages: int, axis: int = 0):
    """Inverse of :func:`_device_major`: (S*v, Lc, ...) -> (L, ...)."""
    x = leaf.movedim((axis, axis + 1), (0, 1))
    V = n_stages * vstages
    per_chunk = x.shape[1]
    resh = x.reshape((n_stages, vstages, per_chunk) + tuple(x.shape[2:]))
    out = resh.movedim(0, 1).reshape((V * per_chunk,) + tuple(x.shape[2:]))
    return out.movedim(0, axis)


def arrange_params_for_schedule(params, schedule: PipelineSchedule, axis=0):
    """Reorder a stacked-layer tree into the executor's device-major rows."""
    return tree_map(
        lambda p: _device_major(p, schedule.n_stages, schedule.vstages, axis),
        params)


def unarrange_params_for_schedule(tree, schedule: PipelineSchedule, axis=0):
    """Map executor-layout leaves (e.g. grads) back to layer-major."""
    return tree_map(
        lambda p: _layer_major(p, schedule.n_stages, schedule.vstages, axis),
        tree)


def chunk_layers(schedule: PipelineSchedule, n_layers: int, stage: int,
                 chunk: int) -> slice:
    """The layer-major rows of ``stage``'s local ``chunk`` (virtual stage
    ``stage + chunk * S``)."""
    per = n_layers // schedule.n_vstages
    k = stage + chunk * schedule.n_stages
    return slice(k * per, (k + 1) * per)


# Extended per-tick actions: the plan's base actions split by whether the
# step's virtual stage is the first (runs ``first_fn`` on raw model inputs)
# and/or the last (seeds the backward from ``loss_fn``).
(
    X_NOOP,
    X_FWD,
    X_FWD_FIRST,
    X_BWD,
    X_BWD_LAST,
    X_BWD_FIRST,
    X_BWD_FIRST_LAST,
) = range(7)


def _extended_actions(plan) -> list[list[int]]:
    out = []
    for t in range(plan.n_ticks):
        row = []
        for s in range(len(plan.action[t])):
            a, first = plan.action[t][s], plan.is_first[t][s]
            if a == NOOP:
                row.append(X_NOOP)
            elif a == DO_FWD:
                row.append(X_FWD_FIRST if first else X_FWD)
            elif a == DO_BWD:
                row.append(X_BWD_FIRST if first else X_BWD)
            else:
                assert a == DO_BWD_LAST
                row.append(X_BWD_FIRST_LAST if first else X_BWD_LAST)
        out.append(row)
    return out


def _stage_apply_aux(params_local, x, layer_fn):
    """This stage's layers in order; layers emit ``(h, aux)`` (aux: a scalar
    contribution to the total loss, e.g. MoE router balance)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_layer in _layer_trees(params_local):
        x, a = layer_fn(p_layer, x)
        aux = aux + a
    return x, aux


def _grad_leaves(tree):
    """Fresh leaves sharing ``tree``'s storage, whose ``.grad`` collects one
    rank's gradient of them."""
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def _grads_of(tree):
    return tree_map(lambda t: t.grad if t.grad is not None
                    else torch.zeros_like(t), tree)


def make_scheduled_body(schedule: PipelineSchedule, layer_fn, devices,
                        first_fn=None, loss_fn=None):
    """Compile a schedule into the tick loop over one stage group's ranks.

    Returns ``body(chunks, first_params, last_params, xs, loss_inputs) ->
    (loss, aux, outs, gchunks, gfirst, glast)``.  ``devices`` are the S
    stage ranks' devices; ``chunks[s][c]`` is stage s's local chunk c (a
    tree of stacked per-layer leaves on ``devices[s]``).  ``xs`` and
    ``loss_inputs`` are trees of (M, ...) microbatched leaves.

    Args:
      layer_fn: ``(per_layer_params, h) -> (h, aux)``, one layer; ``aux``
        is its scalar contribution to the total loss (0.0 for plain
        stacks), whose cotangent is seeded with 1.0 in the backward.
      first_fn: ``(first_params, xs_m) -> h`` applied by the first virtual
        stage only (embedding).  None: identity on the ``xs`` leaf.
      loss_fn: ``(last_params, y, loss_inputs_m) -> scalar`` contribution
        of one microbatch, evaluated (and its backward seeded) by the last
        virtual stage.  Default ``0.5 * sum(y**2)``.

    ``loss`` sums the microbatches' ``loss_fn`` values and ``aux`` the
    layers' aux values; ``outs`` stacks the last virtual stage's outputs;
    ``gchunks[s][c]`` is the gradient of ``chunks[s][c]``; ``gfirst`` and
    ``glast`` those of the first and last parameters (each held by one
    rank: the reference's psum over the stage axis adds zeros elsewhere).
    """
    if first_fn is None:
        first_fn = lambda fp, x: x  # noqa: E731
    if loss_fn is None:
        loss_fn = lambda lp, y, lm: 0.5 * torch.sum(y.float() ** 2)  # noqa: E731

    plan = build_executor_plan(schedule)
    acts = _extended_actions(plan)
    S, M = schedule.n_stages, schedule.n_microbatches
    V = schedule.n_vstages
    assert len(devices) == S, (len(devices), S)
    d_first = devices[schedule.device_of(0)]
    d_last = devices[schedule.device_of(V - 1)]

    def body(chunks, first_params, last_params, xs, loss_inputs):
        cl = [[_grad_leaves(c) for c in row] for row in chunks]
        first = _grad_leaves(tree_map(lambda t: t.to(d_first), first_params))
        last = _grad_leaves(tree_map(lambda t: t.to(d_last), last_params))

        def xs_at(m):
            return tree_map(lambda a: a[m].to(d_first), xs)

        def loss_at(m):
            if loss_inputs is None:
                return None
            return tree_map(lambda a: a[m].to(d_last), loss_inputs)

        x_in = [dict() for _ in range(S)]    # (chunk, mb) -> activation
        g_in = [dict() for _ in range(S)]    # (chunk, mb) -> cotangent
        kept = [dict() for _ in range(S)]    # (chunk, mb) -> (x, y, aux)
        fwd_snd: list = [None] * S
        bwd_snd: list = [None] * S
        outs: list = [None] * M
        loss = torch.zeros((), dtype=torch.float32, device=d_last)
        aux = torch.zeros((), dtype=torch.float32, device=d_last)

        for t in range(plan.n_ticks):
            # 1. exchange: last tick's sends arrive where the plan says the
            # receive is valid
            for snd, table, valid, chunk_t, mb_t, src_of in (
                (fwd_snd, x_in, plan.recv_fwd_valid, plan.recv_fwd_chunk,
                 plan.recv_fwd_mb, lambda s: (s - 1) % S),
                (bwd_snd, g_in, plan.recv_bwd_valid, plan.recv_bwd_chunk,
                 plan.recv_bwd_mb, lambda s: (s + 1) % S),
            ):
                perm = [(src_of(s), s) for s in range(S) if valid[t][s]]
                if not perm:
                    continue
                inc = Mesh_.ppermute(snd, devices, perm)
                for _src, s in perm:
                    table[s][(chunk_t[t][s], mb_t[t][s])] = inc[s]
            fwd_snd = [None] * S
            bwd_snd = [None] * S

            # 2. each stage rank's scheduled step
            for s in range(S):
                a = acts[t][s]
                if a == X_NOOP:
                    continue
                c, m = plan.chunk[t][s], plan.microbatch[t][s]
                if a in (X_FWD, X_FWD_FIRST):
                    if a == X_FWD_FIRST:
                        x = None
                        h = first_fn(first, xs_at(m))
                    else:
                        x = h = x_in[s].pop((c, m)).requires_grad_()
                    y, a_ = _stage_apply_aux(cl[s][c], h, layer_fn)
                    kept[s][(c, m)] = (x, y, a_)
                    if plan.is_last[t][s]:
                        outs[m] = y.detach()
                    aux = aux + a_.detach().to(d_last)
                    fwd_snd[s] = y.detach()
                    continue
                x, y, a_ = kept[s].pop((c, m))
                inputs = leaves(cl[s][c])
                if x is not None:
                    inputs.append(x)
                if a in (X_BWD_FIRST, X_BWD_FIRST_LAST):
                    inputs += leaves(first)
                if a in (X_BWD_LAST, X_BWD_FIRST_LAST):
                    inputs += leaves(last)
                    lval = loss_fn(last, y, loss_at(m))
                    loss = loss + lval.detach()
                    outputs, seeds = [lval + a_], None
                else:
                    outputs, seeds = [y], [g_in[s].pop((c, m))]
                    if a_.requires_grad:
                        outputs.append(a_)
                        seeds.append(torch.ones_like(a_))
                torch.autograd.backward(outputs, seeds, inputs=inputs)
                if x is not None:
                    bwd_snd[s] = x.grad
                del x, y, a_, outputs, seeds

        return (loss, aux, torch.stack(outs),
                [[_grads_of(c) for c in row] for row in cl],
                _grads_of(first), _grads_of(last))

    return body


def stage_chunks(block_params, schedule: PipelineSchedule, devices):
    """``chunks[s][c]``: stage s's local chunk c of a layer-major stack,
    as views (on ``devices[s]``; copied there if it is another device)."""
    (n_layers,) = {int(leaf.shape[0]) for leaf in leaves(block_params)}
    return [[tree_map(lambda p, sl=chunk_layers(schedule, n_layers, s, c):
                      p[sl].to(devices[s]), block_params)
             for c in range(schedule.vstages)]
            for s in range(schedule.n_stages)]


def merge_chunks(gchunks, schedule: PipelineSchedule, device):
    """Inverse of :func:`stage_chunks` for gradient trees: the layer-major
    stack on ``device``."""
    S, v = schedule.n_stages, schedule.vstages
    order = [gchunks[k % S][k // S] for k in range(S * v)]
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                    *order)


def pipeline_stage_shard_map(first_params, block_params, last_params, xs,
                             loss_inputs, layer_fn, mesh,
                             schedule: PipelineSchedule, first_fn=None,
                             loss_fn=None, axis_name: str = "stage"):
    """Execute a staged pipeline step table — forward and scheduled backward
    — over the ``axis_name`` ranks of ``mesh`` (the group through rank 0).

    ``block_params``: layer-major stacked leaves, leading dim divisible by
    ``S * v``.  Returns ``(loss, aux, outs, (gfirst, gblocks, glast))``
    with ``gblocks`` layer-major, as the reference's.
    """
    S = mesh.size(axis_name)
    assert S == schedule.n_stages, (S, schedule.n_stages)
    M, V = schedule.n_microbatches, schedule.n_vstages
    lead = {int(p.shape[0]) for p in leaves(block_params)}
    assert len(lead) == 1, f"per-layer leaves disagree on layer count: {lead}"
    (L,) = lead
    assert L % V == 0, f"layers {L} % virtual stages {V} != 0"
    for leaf in leaves(xs):
        assert int(leaf.shape[0]) == M, (tuple(leaf.shape), M)
    devices = mesh.group_devices(axis_name, (0,) * len(mesh.shape))
    body = make_scheduled_body(schedule, layer_fn, devices,
                               first_fn=first_fn, loss_fn=loss_fn)
    loss, aux, outs, gchunks, gfirst, glast = body(
        stage_chunks(block_params, schedule, devices), first_params,
        last_params, xs, loss_inputs)
    gblocks = merge_chunks(gchunks, schedule, leaves(block_params)[0].device)
    return loss, aux, outs, (gfirst, gblocks, glast)


def pipeline_schedule_shard_map(params, xs: torch.Tensor, layer_fn, mesh,
                                schedule: PipelineSchedule, loss_fn=None,
                                axis_name: str = "stage"):
    """The homogeneous-stack wrapper over :func:`pipeline_stage_shard_map`
    (no embedding or head, loss on the final activation): ``layer_fn(p, x)
    -> x``; ``loss_fn(y) -> scalar`` (default ``0.5 * sum(y**2)``).
    Returns ``(loss, outs, grads)`` with layer-major grads."""
    def lf(p, x):
        return layer_fn(p, x), 0.0

    wrapped = None
    if loss_fn is not None:
        wrapped = lambda lp, y, lm: loss_fn(y)  # noqa: E731
    loss, _aux, outs, (_gf, gblocks, _gl) = pipeline_stage_shard_map(
        {}, params, {}, xs, None, lf, mesh, schedule,
        first_fn=None, loss_fn=wrapped, axis_name=axis_name)
    return loss, outs, gblocks


# ---------------------------------------------------------------------------
# Simulator-facing byte accounting
# ---------------------------------------------------------------------------


def boundary_bytes(activation_shape, dtype="float32") -> float:
    """Bytes one microbatch's activation moves across ONE stage boundary."""
    n = 1
    for d in activation_shape:
        n *= int(d)
    return float(n * dtype_of(dtype).itemsize)


def pipeline_transfer_bytes(n_stages: int, n_microbatches: int,
                            activation_shape, dtype="float32",
                            backward: bool = True) -> float:
    """Total stage-boundary traffic of one wavefront step: every microbatch
    crosses each of the S - 1 boundaries once, and once more in gradients
    with ``backward``."""
    hop = boundary_bytes(activation_shape, dtype)
    hops = (n_stages - 1) * n_microbatches
    return hop * hops * (2 if backward else 1)


def schedule_transfer_bytes(schedule: PipelineSchedule, activation_shape,
                            dtype="float32") -> float:
    """Scheduled-executor twin: every microbatch crosses each of the
    ``S*v - 1`` virtual-stage boundaries once per direction."""
    return schedule.comm_bytes(boundary_bytes(activation_shape, dtype))


def schedule_span_names(schedule: PipelineSchedule) -> list[tuple[str, str]]:
    """(node-uid, device) pairs of one scheduled step, in table order: the
    names and devices ``core.strategy.pipeline_graph`` gives its compute
    and collective-permute nodes."""
    from repro_torch.dist.schedules import FWD

    V = schedule.n_vstages
    out: list[tuple[str, str]] = []
    for step in schedule.steps():
        k, m = step.vstage, step.microbatch
        out.append((step.name, f"stage{step.stage}"))
        if step.phase == FWD and k < V - 1:
            out.append((f"sendF{k}.{m}", "link:pp"))
        elif step.phase != FWD and k > 0:
            out.append((f"sendB{k}.{m}", "link:pp"))
    return out
