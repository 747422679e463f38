"""Train-step factory: loss -> grad -> (compressed) reduce -> clip ->
optimizer, with microbatch gradient accumulation; data-parallel, compressed
and pipelined over a logical-rank mesh.

The torch counterpart of the JAX package's ``train/step.py``.  The JAX step
is a pure function that ``jit`` compiles with the state donated; here it is
eager PyTorch that updates the state's tensors in place (parameters,
moments, error-feedback residuals) and returns a ``TrainState`` holding
them, so a 2.7B-parameter state and its optimizer moments fit one card once.
The numbers follow the JAX step: fp32 gradient and metric sums over the
microbatches, their mean, global-norm clipping, the optimizer's update added
in fp32 and cast to the parameter dtype.

Compressed data parallelism (``compression="int8"``) threads the
error-feedback residuals of ``repro_torch.dist.compress`` through
``TrainState.comp_state`` (leaves ``(dp, *param_shape)``, one residual per
data rank), as the reference does.  The JAX step runs one body per device
under ``shard_map``; here one process runs each rank of a
``repro_torch.dist.mesh`` mesh in turn and reduces over the ranks
(:func:`make_sharded_train_step`, :func:`make_pipeline_train_step`).  On one
card the ranks share it, so a step's wall time is the ranks' work one after
another, not a multi-card time.

The step's phases are ``torch.profiler`` ranges through
``obs.record.prange`` (``train_step.forward``, ``.backward``,
``.optimizer``; the pipeline step's ``train_step.pipeline`` and
``.reduce``), so a profile of a step says where its device time goes; with
no profiler running each costs a flag read.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.build import Model
from repro_torch.obs.record import prange
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.tree import leaves, tree_map, unflatten_like


class TrainState(NamedTuple):
    step: torch.Tensor       # i32 scalar on the parameters' device
    params: Any
    opt_state: Any
    # error-feedback residuals for compressed data-parallel training: None
    # when compression is off, else a tree matching params with f32 leaves
    # of shape (dp, *param_shape), one residual per data-parallel rank
    comp_state: Any = None


def _normalize_compression(compression: Optional[str]) -> Optional[str]:
    if compression in (None, "", "none"):
        return None
    if compression != "int8":
        raise ValueError(
            f"executable compression scheme must be 'int8' (got "
            f"{compression!r}; topk is byte-accounting-only, see "
            f"repro_torch.dist.compress)"
        )
    return compression


def init_state(model: Model, gen: torch.Generator, optimizer: Optimizer,
               compression: Optional[str] = None,
               dp: int = 1) -> TrainState:
    """Random parameters from ``gen`` (on its device), a fresh optimizer
    state and, with compression, zero residuals for ``dp`` data ranks.
    The parameters are leaves that require grad."""
    params = tree_map(lambda p: p.requires_grad_(), model.init(gen))
    dev = leaves(params)[0].device
    comp = None
    if _normalize_compression(compression):
        from repro_torch.dist.compress import init_feedback_state

        comp = init_feedback_state(params, dp)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      optimizer.init(params), comp)


def abstract_state(model: Model, optimizer: Optimizer, seed: int = 0,
                   compression: Optional[str] = None, dp: int = 1):
    """``(state, axes)``: the full :class:`TrainState`'s shapes and dtypes
    (``models.build.ShapeDtype`` leaves), :func:`init_state` run on fake
    tensors, and the parameters' logical axes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.build import ShapeDtype

    with FakeTensorMode():
        state = init_state(model, torch.Generator().manual_seed(seed),
                           optimizer, compression, dp)

    def shape(t):
        return ShapeDtype(tuple(t.shape), t.dtype)

    return (TrainState(shape(state.step), tree_map(shape, state.params),
                       tree_map(shape, state.opt_state),
                       tree_map(shape, state.comp_state)),
            model.param_axes())


def _split_microbatches(batch: dict, accum: int) -> dict:
    def split(x):
        b = x.shape[0]
        assert b % accum == 0, f"batch {b} % accum {accum} != 0"
        return x.reshape((accum, b // accum) + tuple(x.shape[1:]))

    return {k: split(v) for k, v in batch.items()}


def _split_ranks(batch: dict, n: int) -> list[dict]:
    """The batch's rows in ``n`` consecutive blocks, one a data rank (the
    reference's ``P(data)`` split of the leading axis)."""
    b = {v.shape[0] for v in batch.values()}
    (B,) = b
    assert B % n == 0, f"batch {B} % data ranks {n} != 0"
    k = B // n
    return [{kk: v[r * k:(r + 1) * k] for kk, v in batch.items()}
            for r in range(n)]


def _rank_params(params, device):
    """A rank's view of the parameters: the tensors themselves on their
    device, else a copy on ``device`` whose gradient is the rank's."""
    return tree_map(lambda p: p if p.device == device
                    else p.detach().to(device).requires_grad_(), params)


def _apply_update(state: TrainState, grads, loss, metrics, comp_state,
                  schedule, optimizer: Optimizer, max_grad_norm: float):
    """The steps' shared tail: clip, optimizer, fp32 add in place."""
    params = state.params
    with prange("train_step.optimizer"):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm,
                                           inplace=True)
        lr = schedule(state.step)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              params, lr)
        del grads
        with torch.no_grad():
            for p, u in zip(leaves(params), leaves(updates)):
                p.copy_((p.float() + u.float()).to(p.dtype))
    out_metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   **(metrics or {})}
    return (TrainState(state.step + 1, params, opt_state, comp_state),
            out_metrics)


def make_train_step(
    model: Model,
    optimizer: Optimizer,
    schedule,
    grad_accum: int = 1,
    max_grad_norm: float = 1.0,
    compression: Optional[str] = None,
    axis_name: Optional[str] = None,
    overlap_buckets: int = 0,
    mesh=None,
):
    """Returns train_step(state, batch) -> (state, metrics).

    grad_accum > 1 runs the microbatches in order, accumulating the gradient
    (and the model's metrics, ``ce`` and ``aux``) in fp32, then applies the
    optimizer once to their mean.  The step's metrics are the loss, grad
    norm and learning rate beside the model's, as in the JAX step.  The
    step consumes ``state``: its tensors are updated in place and belong to
    the returned state.

    With ``compression``, the gradient mean runs through
    ``dist.compress.compressed_psum``: quantize, reduce the dequantized
    payload, carry each rank's residual in ``state.comp_state``.
    ``axis_name=None`` runs the identical numerics on one rank (dp = 1).
    With ``axis_name`` (and the ``mesh`` holding that axis), the batch's
    rows are split over the axis's ranks, each rank computes its gradient,
    and the mean over the ranks (compressed, or a bucketed pmean) is what
    the optimizer applies; the loss and metrics are the ranks' mean.
    ``overlap_buckets >= 2`` reduces reverse-order buckets of leaves
    (bit-identical numerics).
    """
    compression = _normalize_compression(compression)
    if axis_name is not None and mesh is None:
        raise ValueError(f"axis_name={axis_name!r} needs the mesh that "
                         "holds it (repro_torch.dist.mesh)")

    def grad_fn(params, microbatch):
        flat = leaves(params)
        with prange("train_step.forward"):
            loss, metrics = model.loss(params, microbatch)
        with prange("train_step.backward"):
            grads = torch.autograd.grad(loss, flat)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    def local_grads(params, batch):
        """(loss, metrics, flat fp32-summed mean grads) of one rank."""
        if grad_accum == 1:
            return grad_fn(params, batch)
        micro = _split_microbatches(batch, grad_accum)
        gsum = msum = None
        lsum = 0.0
        for i in range(grad_accum):
            l, m, g = grad_fn(params, {k: v[i] for k, v in micro.items()})
            if gsum is None:
                # 0 + g: the first microbatch's fp32 gradient is the sum
                gsum = [x.float() for x in g]
                msum = {k: v.float() for k, v in m.items()}
            else:
                for a, b in zip(gsum, g):
                    a.add_(b.float())
                msum = {k: msum[k] + v.float() for k, v in m.items()}
            del g
            lsum = lsum + l
        grads = [g.div_(grad_accum) for g in gsum]
        return lsum / grad_accum, \
            {k: s / grad_accum for k, s in msum.items()}, grads

    def train_step(state: TrainState, batch: dict):
        params = state.params
        comp_state = state.comp_state
        if axis_name is None:
            loss, metrics, grads = local_grads(params, batch)
            grads = unflatten_like(params, grads)
            if compression is not None:
                from repro_torch.dist.compress import compressed_psum

                # the rank's residual: the (1, ...) state's only row
                res = tree_map(lambda r: r[0], comp_state)
                grads, _ = compressed_psum(grads, None, res,
                                           buckets=overlap_buckets,
                                           inplace=True)
            return _apply_update(state, grads, loss, metrics, comp_state,
                                 schedule, optimizer, max_grad_norm)

        from repro_torch.dist import compress as C
        from repro_torch.dist import mesh as M
        from repro_torch.models.sharding import use_sharding

        others = {a: 0 for a in mesh.axis_names if a != axis_name}
        coord = tuple(others.get(a, 0) for a in mesh.axis_names)
        devices = mesh.group_devices(axis_name, coord)
        losses, mets, rank_grads = [], [], []
        # each rank's body runs without the sharding context, as the
        # reference's shard_map body does: its MoE layers take the einsum
        # path on the rank's rows
        with use_sharding(None):
            for dev, shard in zip(devices, _split_ranks(batch,
                                                        len(devices))):
                rp = _rank_params(params, dev)
                l, m, g = local_grads(rp, {k: v.to(dev)
                                           for k, v in shard.items()})
                losses.append(l)
                mets.append(m)
                rank_grads.append(unflatten_like(params, g))
        with prange("train_step.reduce"):
            if compression is not None:
                res = [tree_map(lambda x, r=r: x[r], comp_state)
                       for r in range(len(devices))]
                means, _ = C.compressed_psum(rank_grads, devices, res,
                                             buckets=overlap_buckets,
                                             inplace=True)
            else:
                means = C.bucketed_pmean(rank_grads, devices,
                                         buckets=overlap_buckets)
            del rank_grads
            loss = M.pmean(losses, devices)[0]
            metrics = {k: M.pmean([m[k] for m in mets], devices)[0]
                       for k in mets[0]}
        return _apply_update(state, means[0], loss, metrics, comp_state,
                             schedule, optimizer, max_grad_norm)

    return train_step


def _nested_add(acc, new):
    """``acc + new`` over nested lists and dicts of tensors, in place;
    ``acc=None`` starts the sum."""
    if acc is None:
        return new
    if isinstance(acc, list):
        return [_nested_add(a, n) for a, n in zip(acc, new)]
    if isinstance(acc, dict):
        return {k: _nested_add(acc[k], new[k]) for k in acc}
    return acc.add_(new)


def _nested_div(acc, n: int) -> None:
    """Divide every tensor of nested lists and dicts by ``n``, in place."""
    for x in (acc.values() if isinstance(acc, dict) else acc):
        if torch.is_tensor(x):
            x.div_(n)
        else:
            _nested_div(x, n)


def _stage_rows(gchunks_s: list):
    """A stage's local rows: its chunks' trees concatenated in local-chunk
    order (the reference's device-major rows; one chunk: itself)."""
    if len(gchunks_s) == 1:
        return gchunks_s[0]
    return tree_map(lambda *xs: torch.cat(xs), *gchunks_s)


def make_pipeline_train_step(
    model: Model,
    optimizer: Optimizer,
    schedule,
    mesh,
    plan,
    grad_accum: int = 1,
    max_grad_norm: float = 1.0,
    compression: Optional[str] = None,
    data_axis: str = "data",
    stage_axis: str = "stage",
    overlap_buckets: int = 0,
):
    """Train step executing the REAL model through the pipeline schedule on
    the (data x stage) mesh.

    Each data replica runs its rows of the batch through the scheduled
    pipeline executor (``dist.pp.make_scheduled_body`` with the model's own
    embed/block/head stage callables from ``models.pipeline``) over its
    stage ranks; then the gradients are mean-reduced over ``data_axis`` —
    a (bucketed) pmean, or int8 ``compressed_psum`` with the error-feedback
    residuals carried in ``TrainState.comp_state``: each stage quantizes
    the block rows it owns (its chunks, in local order, as the reference's
    device-major rows) and the embedding/final-norm/head gradients (merged:
    a tied table's two paths summed) once a replica.  Clip and optimizer
    run once on the merged gradients, as the reference's tail.

    ``grad_accum > 1`` runs ``grad_accum`` pipeline passes a replica: the
    step trains the mean over ``grad_accum * plan.microbatches``
    microbatches.  The TrainState layout is the plain step's.  The executor
    always elides the exchanges no rank receives (the reference's
    ``overlap_comm=True``, bit-identical), so there is no such option.
    """
    from repro_torch.dist import compress as C
    from repro_torch.dist import mesh as Mesh_
    from repro_torch.dist import pp as _pp
    from repro_torch.models.pipeline import (
        merge_grads,
        partition_params,
        stage_fns,
    )
    from repro_torch.models.sharding import use_sharding

    cfg = model.cfg
    compression = _normalize_compression(compression)
    sched = plan.make_schedule()
    M, A, v = plan.microbatches, grad_accum, plan.vstages
    sizes = mesh.sizes
    assert sizes.get(stage_axis) == plan.pp, (sizes, plan.pp)
    dp = sizes.get(data_axis, 1)
    first_fn, layer_fn, loss_fn = stage_fns(cfg, M)

    def coord(d, s):
        c = {data_axis: d, stage_axis: s}
        return tuple(c.get(a, 0) for a in mesh.axis_names)

    stage_devs = [[mesh.device(coord(d, s)) for s in range(plan.pp)]
                  for d in range(dp)]
    data_devs = [[stage_devs[d][s] for d in range(dp)]
                 for s in range(plan.pp)]
    bodies = [_pp.make_scheduled_body(sched, layer_fn, stage_devs[d],
                                      first_fn=first_fn, loss_fn=loss_fn)
              for d in range(dp)]

    def extras_grads(gf, gl):
        merged = merge_grads(cfg, gf, None, gl)
        del merged["blocks"]
        return merged

    def train_step(state: TrainState, batch: dict):
        # the stages run without the sharding context, as the reference's
        # shard_map body does: MoE layers take the einsum path
        with use_sharding(None):
            return pipeline_step(state, batch)

    def pipeline_step(state: TrainState, batch: dict):
        params = state.params
        first, blocks, last = partition_params(cfg, params)
        (B,) = {v_.shape[0] for v_ in batch.values()}
        assert B % (dp * A * M) == 0, (
            f"batch {B} % (dp {dp} * grad_accum {A} * microbatches {M}) "
            "!= 0")
        ce, aux, g_extras, g_rows = [], [], [], []
        with prange("train_step.pipeline"):
            for d, shard in enumerate(_split_ranks(batch, dp)):
                chunks = _pp.stage_chunks(blocks, sched, stage_devs[d])
                split = {k: x.reshape((A, M, -1) + tuple(x.shape[1:]))
                         for k, x in shard.items()}
                sums = None
                for a in range(A):
                    xs = {"tokens": split["tokens"][a]}
                    li = {k: x[a] for k, x in split.items() if k != "tokens"}
                    c_, x_, _outs, gch, gf, gl = bodies[d](chunks, first,
                                                           last, xs, li)
                    sums = _nested_add(sums, [c_, x_, gch, gf, gl])
                    del gch, gf, gl
                if A > 1:
                    _nested_div(sums, A)
                c_, x_, gch, gf, gl = sums
                ce.append(c_)
                aux.append(x_)
                g_extras.append(extras_grads(gf, gl))
                g_rows.append([_stage_rows(gch[s]) for s in range(plan.pp)])
                del gch, gf, gl, sums

        comp_state = state.comp_state
        with prange("train_step.reduce"):
            devs0 = data_devs[0]
            if compression is not None:
                res_extras = [tree_map(lambda r, d=d: r[d],
                                       {k: x for k, x in comp_state.items()
                                        if k != "blocks"})
                              for d in range(dp)]
                mean_extras, _ = C.compressed_psum(
                    g_extras, devs0, res_extras, buckets=overlap_buckets,
                    inplace=True)
            else:
                mean_extras = C.bucketed_pmean(g_extras, devs0,
                                               buckets=overlap_buckets)
            per = plan.layers_per_vstage
            mean_rows = []
            for s in range(plan.pp):
                rows = [g_rows[d][s] for d in range(dp)]
                if compression is None:
                    means = C.bucketed_pmean(rows, data_devs[s],
                                             buckets=overlap_buckets)
                    mean_rows.append(means[0])
                    continue
                # each data rank's residual views of stage s's chunks
                res = [[tree_map(lambda r, d=d, q=_pp.chunk_layers(
                            sched, cfg.num_layers, s, c): r[d][q],
                                 comp_state["blocks"]) for c in range(v)]
                       for d in range(dp)]
                means, new_res = C.compressed_psum(
                    rows, data_devs[s], [_stage_rows(r) for r in res],
                    buckets=overlap_buckets, inplace=True)
                if v > 1:     # the rows were a copy: write them back
                    for d in range(dp):
                        for c, views in enumerate(res[d]):
                            tree_map(lambda t, x, c=c: t.copy_(
                                x[c * per:(c + 1) * per]), views, new_res[d])
                mean_rows.append(means[0])
            del g_rows, g_extras
            dev = leaves(params)[0].device
            gblocks = _pp.merge_chunks(
                [[tree_map(lambda x, c=c: x[c * per:(c + 1) * per],
                           mean_rows[s]) for c in range(v)]
                 for s in range(plan.pp)], sched, dev)
            ce_m = Mesh_.pmean(ce, devs0)[0]
            aux_m = Mesh_.pmean(aux, devs0)[0]
        grads = dict(mean_extras[0])
        grads["blocks"] = gblocks
        loss = ce_m + aux_m
        return _apply_update(state, grads, loss, {"ce": ce_m, "aux": aux_m},
                             comp_state, schedule, optimizer, max_grad_norm)

    return train_step


def make_sharded_train_step(
    model: Model,
    optimizer: Optimizer,
    schedule,
    mesh,
    grad_accum: int = 1,
    max_grad_norm: float = 1.0,
    compression: Optional[str] = None,
    axis_name: str = "data",
    pipeline=None,
    overlap_buckets: int = 0,
):
    """The train step for a mesh — the launcher's entry point.

    Dense training returns the plain step on the whole batch (the
    reference's GSPMD step: the same mean); under the launcher's sharding
    context (``models.sharding.use_sharding``) its ``ep_a2a`` MoE layers
    run expert-parallel over the mesh.  Compressed training needs each
    rank's gradient, so the step splits the batch over ``axis_name``'s
    ranks (:func:`make_train_step` with ``axis_name``).  With a ``pipeline``
    plan (``models.pipeline.PipelinePlan``) the step runs the real model
    through the scheduled pipeline executor on the (data x stage) mesh
    (:func:`make_pipeline_train_step`).  One entry point, every strategy.
    """
    if pipeline is not None:
        return make_pipeline_train_step(
            model, optimizer, schedule, mesh, pipeline,
            grad_accum=grad_accum, max_grad_norm=max_grad_norm,
            compression=compression, data_axis=axis_name,
            overlap_buckets=overlap_buckets,
        )
    compression = _normalize_compression(compression)
    return make_train_step(
        model, optimizer, schedule,
        grad_accum=grad_accum, max_grad_norm=max_grad_norm,
        compression=compression,
        axis_name=axis_name if compression else None,
        overlap_buckets=overlap_buckets, mesh=mesh,
    )


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step


def run_timed_step(step_fn, state, batch, recorder, name: str, **labels):
    """Execute one train step under a recorder interval.

    The measurement boundary is the ``float(metrics["loss"])`` host sync, as
    in the JAX package: the copy to the host goes through the stream that
    ran the step, after everything the step queued on it.

    Returns ``(state, metrics, loss, dt_seconds)``.
    """
    iv = recorder.interval(name, "host", kind="train-step", **labels)
    state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])  # host sync: the step is truly done
    dt = iv.stop()
    return state, metrics, loss, dt
