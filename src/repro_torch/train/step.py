"""Train-step factory, single device: loss -> grad -> clip -> optimizer, with
microbatch gradient accumulation.

The torch counterpart of the single-device part of the JAX package's
``train/step.py``.  The JAX step is a pure function that ``jit`` compiles
with the state donated; here it is eager PyTorch that updates the state's
tensors in place (parameters, moments) and returns a ``TrainState`` holding
them, so a 2.7B-parameter state and its optimizer moments fit one card once.
The numbers follow the JAX step: fp32 gradient and metric sums over the
microbatches, their mean, global-norm clipping, the optimizer's update added
in fp32 and cast to the parameter dtype.

The step's phases are ``torch.profiler`` ranges (``train_step.forward``,
``.backward``, ``.optimizer``), so a profile of a step says where its
device time goes.

Compressed data parallelism, the pipeline step and the sharded step need the
distributed executors, which are not ported (ROADMAP.md, "Distributed"):
asking for them raises.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.models.build import Model
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.tree import leaves, tree_map, unflatten_like

_DIST = "the distributed executors (ROADMAP.md, 'Distributed')"


class TrainState(NamedTuple):
    step: torch.Tensor       # i32 scalar on the parameters' device
    params: Any
    opt_state: Any
    # error-feedback residuals of compressed data parallelism; always None
    # here, since compression is not ported
    comp_state: Any = None


def _no_compression(compression: Optional[str]) -> None:
    if compression not in (None, "", "none"):
        raise NotImplementedError(
            f"compression {compression!r} needs {_DIST}, not ported yet"
        )


def init_state(model: Model, gen: torch.Generator, optimizer: Optimizer,
               compression: Optional[str] = None) -> TrainState:
    """Random parameters from ``gen`` (on its device) and a fresh optimizer
    state.  The parameters are leaves that require grad."""
    _no_compression(compression)
    params = tree_map(lambda p: p.requires_grad_(), model.init(gen))
    dev = leaves(params)[0].device
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      optimizer.init(params), None)


def _split_microbatches(batch: dict, accum: int) -> dict:
    def split(x):
        b = x.shape[0]
        assert b % accum == 0, f"batch {b} % accum {accum} != 0"
        return x.reshape((accum, b // accum) + tuple(x.shape[1:]))

    return {k: split(v) for k, v in batch.items()}


def make_train_step(
    model: Model,
    optimizer: Optimizer,
    schedule,
    grad_accum: int = 1,
    max_grad_norm: float = 1.0,
    compression: Optional[str] = None,
    axis_name: Optional[str] = None,
    overlap_buckets: int = 0,
):
    """Returns train_step(state, batch) -> (state, metrics).

    grad_accum > 1 runs the microbatches in order, accumulating the gradient
    (and the model's metrics, ``ce`` and ``aux``) in fp32, then applies the
    optimizer once to their mean.  The step's metrics are the loss, grad
    norm and learning rate beside the model's, as in the JAX step.  The step consumes ``state``: its tensors are updated in
    place and belong to the returned state.
    """
    _no_compression(compression)
    if axis_name is not None or overlap_buckets:
        raise NotImplementedError(f"a mesh axis and bucketed reduction need "
                                  f"{_DIST}, not ported yet")

    def grad_fn(params, microbatch):
        flat = leaves(params)
        with record_function("train_step.forward"):
            loss, metrics = model.loss(params, microbatch)
        with record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, flat)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        if grad_accum == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
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
            loss = lsum / grad_accum
            metrics = {k: s / grad_accum for k, s in msum.items()}

        with record_function("train_step.optimizer"):
            grads = unflatten_like(params, grads)
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
        return (TrainState(state.step + 1, params, opt_state,
                           state.comp_state), out_metrics)

    return train_step


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
