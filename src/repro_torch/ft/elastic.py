"""Elastic re-meshing: resume on a different device count.

``plan_remesh`` maps a desired chip budget to the nearest feasible
(pod, data, model) mesh while holding the model axis fixed (TP width is
baked into kernels/fusions; the data/pod axes absorb node loss), and reports
the global-batch feasibility.  ``apply_remesh`` moves an existing TrainState
onto the new mesh by re-resolving every leaf's sharding under the new
sharding context — combined with deterministic data (``repro_torch.data``)
and the newest checkpoint (``repro_torch.ckpt``) this is the full
node-failure recovery path:

    detect (heartbeat) -> plan_remesh -> restore ckpt -> apply_remesh -> resume

``plan_remesh`` is a copy of the JAX package's.  ``apply_remesh`` places
each leaf on the new mesh of logical ranks (``repro_torch.dist.mesh``)
through ``models.sharding.tree_specs`` and ``shards``, the port's
counterpart of ``jax.device_put(x, NamedSharding)``: each leaf becomes
every rank's piece of it.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.sharding import ShardingCtx, shards, tree_specs
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    dropped_chips: int
    batch_divisible: bool
    note: str = ""

    @property
    def new_chips(self) -> int:
        n = 1
        for s in self.new_shape:
            n *= s
        return n


def plan_remesh(
    old_shape: tuple[int, ...],
    axis_names: tuple[str, ...],
    available_chips: int,
    global_batch: int,
) -> RemeshPlan:
    """Shrink (or grow) the data/pod axes to fit ``available_chips``.

    The model axis is preserved; the data-like axes are reduced to the
    largest product that fits.  Raises if even one data slice cannot fit.
    """
    sizes = dict(zip(axis_names, old_shape))
    model = sizes.get("model", 1)
    if available_chips < model:
        raise ValueError(
            f"cannot re-mesh: need >= {model} chips for the model axis, "
            f"have {available_chips}"
        )
    data_budget = available_chips // model
    # keep pod x data as close to the original split as possible
    old_pod = sizes.get("pod", 1)
    new_pod = min(old_pod, data_budget)
    while new_pod > 1 and data_budget % new_pod != 0:
        new_pod -= 1
    new_data = data_budget // new_pod
    if "pod" in sizes:
        new_shape = tuple(
            {"pod": new_pod, "data": new_data, "model": model}[n]
            for n in axis_names
        )
    else:
        new_shape = tuple(
            {"data": new_pod * new_data, "model": model}[n] for n in axis_names
        )
    new_chips = new_pod * new_data * model
    dp = new_pod * new_data
    return RemeshPlan(
        old_shape=tuple(old_shape),
        new_shape=new_shape,
        axis_names=tuple(axis_names),
        dropped_chips=available_chips - new_chips,
        batch_divisible=(global_batch % dp == 0),
        note=(
            ""
            if global_batch % dp == 0
            else f"global_batch {global_batch} not divisible by dp {dp}; "
            "reduce batch or pad"
        ),
    )


def apply_remesh(tree, axes_tree, new_ctx: ShardingCtx):
    """Re-place every leaf under the new mesh's resolved specs: a tree of
    ``tree``'s structure whose leaves are ``{rank coordinate: piece}`` over
    every rank of ``new_ctx.mesh``, each piece on its rank's device (a view
    where the rank shares the leaf's device)."""
    specs = tree_specs(new_ctx, tree, axes_tree)
    return tree_map(lambda x, s: shards(x, s, new_ctx.mesh), tree, specs)
