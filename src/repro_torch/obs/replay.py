"""Instrumented per-op replay: real measurements under sim node uids.

The pipelined train step (``repro_torch.dist.pp``'s scheduled executor)
runs every rank's work in one host loop; its ops are not spanned one by
one.  The observability layer therefore measures each simulated node *the
way the paper's offline profiler would*: re-execute the op standalone on
the live mesh with its real shapes and payloads, and record the blocked
wall time as a span under the node's exact uid.

* ``F{k}.{m}`` / ``B{k}.{m}`` — one virtual-stage chunk of the real
  decoder blocks (``repro_torch.models.pipeline.stage_fns``) forward, and
  its VJP (the gradients of the chunk's parameters and input);
* ``sendF*``/``sendB*`` — a :func:`~repro_torch.dist.mesh.ppermute` over
  the mesh's ``stage`` axis carrying exactly the node's boundary payload
  (one :func:`~repro_torch.dist.mesh.hop` a rank);
* ``gradAR*`` — a :func:`~repro_torch.dist.mesh.psum` over ``data`` of the
  node's wire bytes as fp32 elements (compression annotations resolved
  through the executor byte twin, ``core.estimator.dist_comm_bytes``);
* ``a2a*`` (MoE dispatch) — an :func:`~repro_torch.dist.mesh.all_to_all`
  over ``data`` of the node's payload when the mesh has more than one
  data rank (an expert group); otherwise skipped with a log line (the
  divergence attributor then reports those nodes as O002, never a
  fabricated measurement).  The JAX package skips every such node.

Every span lands on the node's simulated device (``stage{s}``,
``link:pp``, ``link:dp{s}``), so the overlay renders real tracks in the
same lanes as the simulated ones, and each op runs on the rank the node
belongs to.  A span is blocked wall time: the card is synchronised before
the clock is read at both ends, so the span covers the op's device work,
not its launch.  Every callable runs once outside any span first (kernel
builds, library heuristics).  Replay is sequential: the ranks of one card
run one after another anyway, so the summed replay time is the serialized
cost the step pays.  The replay's standalone transfers are not the
executor's: the mesh's byte counters (``dist.mesh.TRAFFIC``) are restored
when it ends.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.estimator import dist_comm_bytes
from repro_torch.device import synchronize
from repro_torch.tree import leaves, tree_map


def _chunk_fns(cfg, microbatches: int, per_vstage: int):
    """(fwd, bwd) callables for one virtual-stage chunk."""
    from repro_torch.models.pipeline import stage_fns

    _, layer_fn, _ = stage_fns(cfg, microbatches)

    def run(bp, h):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(per_vstage):
            h, a = layer_fn(tree_map(lambda x, i=i: x[i], bp), h)
            aux = aux + a
        return h, aux

    def chunk_fwd(bp, h):
        with torch.no_grad():
            return run(bp, h)

    def chunk_bwd(bp, h, ct):
        with torch.enable_grad():
            bp = tree_map(lambda x: x.detach().requires_grad_(), bp)
            h = h.detach().requires_grad_()
            y, aux = run(bp, h)
            outs, cts = [y], [ct]
            if aux.requires_grad:       # a dense chunk's aux is constant
                outs.append(aux)
                cts.append(torch.ones_like(aux))
            return torch.autograd.grad(outs, [h] + leaves(bp),
                                       grad_outputs=cts, allow_unused=True)

    return chunk_fwd, chunk_bwd


def _payload_elems(node) -> int:
    """float32 element count matching the node's wire payload."""
    return max(1, int(math.ceil(dist_comm_bytes(node) / 4.0)))


def replay_pipeline_ops(
    recorder,
    graph,
    *,
    cfg,
    plan,
    mesh,
    params,
    micro_batch: int,
    seq: int,
    log_fn: Callable[[str], None] = print,
) -> dict[str, int]:
    """Measure every node of a model-derived pipeline graph for real.

    Emits one recorder span per measured node (uid-exact) and returns
    ``{"measured": n, "skipped": n}``.  The caller supplies the live
    ``params`` and the (data, stage) mesh
    (``repro_torch.dist.mesh.Mesh``) the launch executes on.
    """
    from repro_torch.dist import mesh as M
    from repro_torch.dist import pp as _pp
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.pipeline import partition_params

    sizes = mesh.sizes
    S = sizes.get("stage", 1)
    dp = sizes.get("data", 1)
    per = plan.layers_per_vstage
    V = plan.n_vstages

    # the executor's span vocabulary must agree with the graph's node uids
    # (the join key of the divergence attributor) — assert, don't assume
    sched_names = {
        nm for nm, _ in _pp.schedule_span_names(plan.make_schedule())
    }
    graph_names = {n.name for n in graph.nodes}
    missing = sched_names - graph_names
    if missing:
        raise AssertionError(
            f"executor schedule emits span names the simulated graph "
            f"lacks: {sorted(missing)[:5]}"
        )

    def stage_device(node) -> torch.device:
        """The device of data rank 0 of the node's stage."""
        s = int(node.device[len("stage"):])
        return mesh.device(tuple(s if a == "stage" else 0
                                 for a in mesh.axis_names))

    _, blocks, _ = partition_params(cfg, params)
    fwd, bwd = _chunk_fns(cfg, plan.microbatches, per)
    chunks = [
        tree_map(lambda x, k=k: x[k * per:(k + 1) * per], blocks)
        for k in range(V)
    ]
    chunk_on: dict[tuple[int, torch.device], tuple] = {}
    gen = torch.Generator().manual_seed(0)
    h_host = torch.randn((micro_batch, seq, cfg.d_model), generator=gen,
                         dtype=torch.float32).to(dtype_of(cfg.compute_dtype))

    def chunk_inputs(k: int, dev: torch.device):
        """Chunk ``k``'s params, input and cotangent on ``dev`` (views
        where the params already live there); the forward and the VJP run
        once here, outside any span."""
        if (k, dev) not in chunk_on:
            bp = tree_map(lambda x: x.to(dev), chunks[k])
            h0 = h_host.to(dev)
            ct = torch.ones_like(h0)
            fwd(bp, h0)
            bwd(bp, h0, ct)
            synchronize(dev)
            chunk_on[(k, dev)] = (bp, h0, ct)
        return chunk_on[(k, dev)]

    devices = sorted(set(mesh.devices), key=str)

    def _sync_all() -> None:
        for d in devices:
            synchronize(d)

    def per_rank(shape) -> dict:
        return {c: torch.zeros(shape, dtype=torch.float32,
                               device=mesh.device(c))
                for c in mesh.coords()}

    # collective calls, one warmed-up payload per size
    coll_cache: dict[tuple, Callable] = {}

    def coll_fn(kind: str, n: int):
        key = (kind, n)
        if key not in coll_cache:
            if kind == "F":
                vals = per_rank((n,))
                fn = (lambda v=vals: mesh.ppermute(
                    v, "stage", [(i, i + 1) for i in range(S - 1)]))
            elif kind == "B":
                vals = per_rank((n,))
                fn = (lambda v=vals: mesh.ppermute(
                    v, "stage", [(i, i - 1) for i in range(1, S)]))
            elif kind == "AR":
                vals = per_rank((n,))
                fn = (lambda v=vals: mesh.psum(v, "data"))
            else:
                vals = per_rank((dp, -(-n // dp)))
                fn = (lambda v=vals: mesh.all_to_all(v, "data", 0, 0))
            fn()
            _sync_all()
            coll_cache[key] = fn
        return coll_cache[key]

    traffic = dict(M.TRAFFIC)
    measured = skipped = 0
    rec = recorder
    try:
        for node in graph.nodes:
            if node.kind in ("fwd", "bwd"):
                k = int(node.name[1:].split(".", 1)[0])
                dev = stage_device(node)
                bp, h0, ct = chunk_inputs(k, dev)
                synchronize(dev)
                t0 = rec.clock()
                if node.kind == "fwd":
                    fwd(bp, h0)
                else:
                    bwd(bp, h0, ct)
                synchronize(dev)
                rec.emit(node.name, node.device, t0, rec.clock(),
                         kind=node.kind, vstage=k)
                measured += 1
                continue
            if node.kind == "collective-permute":
                if S <= 1:
                    skipped += 1
                    continue
                kind = "F" if node.name.startswith("sendF") else "B"
            elif node.kind == "all-reduce":
                if dp <= 1:
                    skipped += 1
                    continue
                kind = "AR"
            elif node.kind == "all-to-all" and dp > 1:
                kind = "A2A"
            else:
                # any other kind, and a dispatch a2a without an expert
                # group on this mesh: no honest standalone measurement —
                # leave unobserved (O002)
                skipped += 1
                continue
            fn = coll_fn(kind, _payload_elems(node))
            _sync_all()
            t0 = rec.clock()
            fn()
            _sync_all()
            rec.emit(node.name, node.device, t0, rec.clock(),
                     kind=node.kind)
            measured += 1
    finally:
        M.TRAFFIC.clear()
        M.TRAFFIC.update(traffic)
    if skipped:
        log_fn(
            f"[obs] replay skipped {skipped} node(s) with no standalone "
            f"measurement on this mesh (reported as O002 by the "
            f"divergence attributor)"
        )
    return {"measured": measured, "skipped": skipped}
