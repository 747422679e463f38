"""Multi-pod dry run: price every (arch x shape x mesh) cell per rank
without allocating anything.

The counterpart of the JAX package's ``launch/dryrun.py``.  For each cell
this resolves the shardings of the state (or serving parameters), the batch
and the cache with the divisibility-aware rules of
``repro_torch.models.sharding`` (the JAX package's, with the same shape
overrides), then traces ONE rank's program on fake tensors and prices it:

    fn, shapes, in_specs, out_specs, ctx, meta = build_cell(...)
    gm = fn(device)                 # make_fx of the rank's step, fake tensors
    summary = graph + rank_collectives(...)   # flops, bytes, collectives
    memory = shard bytes of the arguments, donation, temp_bytes(gm)
    roofline = build_report(..., platform=H100_SXM)

and writes one JSON record per cell to experiments/dryrun/.

The per-rank program (design)
-----------------------------
The JAX package compiles the SPMD program with GSPMD and never runs it.
The port has no SPMD partitioner, so it traces one rank's program itself
(``core.fx_graph.trace_rank_step``, ``make_fx`` under ``FakeTensorMode``,
as ``[simtrain]``'s ``trace_train_step``):

* the rank's batch is the global batch divided over the mesh axes that
  ``batch`` resolves to, its cache the shard of the cache's spec;
* every parameter enters at its *compute* shape: the spec its logical axes
  resolve to by the rules alone (``spec_for``), so every dimension split
  over ``model`` is cut to its shard and every dimension the resolver
  dropped (it does not divide) stays whole, replicated compute as XLA does;
  the ZeRO-1/FSDP ``data`` shards of the arguments are gathered before use
  (an all-gather each, counted).  Two rules widen the compute shape: the
  MoE router keeps every expert's column (routing reads all E logits), and
  a cell whose rules replicate ``act_heads`` (the decode cells, whose cache
  splits its sequence instead) computes every attention and SSM head;
* the model code is shape-driven, so it runs the rank's share: a rank
  config carries the rank's query and kv heads for the code that reads
  them, and the sharding context's ``RankView`` answers what shapes
  cannot, one call a site (``models.sharding.rank_view``; the identity
  outside the dry run): the query heads of a rank that holds every kv
  head read ceil(K / model) of them (llama3.2-1b on (16, 16): 2 query
  heads, 8 kv heads' projections, 1 read); with ``seq_q`` on ``model``
  and the heads whole (phi4's ``seqpar``) the rank's queries are the last
  contiguous 1/16 of the sequence against every key at their
  ``q_offset``, the block's output all-gathered back; a rank holding
  E/16 experts routes over all E and runs the FFN of its own; a rank's
  SSM heads are those its weights hold;
* a decode step writes its token at the rank's last cache slot (the rank
  that holds the position), ``cache_len = S / kv_ways - 1``;
* collectives come from the specs by the rules of
  ``core.fx_graph.rank_collectives`` (tensor-parallel all-reduces, FSDP
  and ZeRO gathers, the gradient reduction through ``dist.compress``'s
  byte twin, the EP all-to-alls through ``dist.ep_a2a``'s), each ICI or
  DCN by ``mesh_info``'s ``dcn_axes``;
* memory: ``argument_size_in_bytes`` is the bytes of every argument's
  shard (exact); ``output_size_in_bytes`` and ``alias_size_in_bytes``
  follow the cell's donation (a train step donates its state, a decode
  step its cache); ``temp_size_in_bytes`` is the peak of live intermediate
  bytes over the traced graph (``fx_graph.temp_bytes``): the port's own
  estimate, not XLA's, which the record says; XLA's cost analysis, HLO
  text and generated code have no counterpart and are null;
* the trace defaults to the card's program (fake CUDA tensors: each
  kernel op is one node, as it is one launch), which needs a PyTorch
  built with CUDA and, for a train cell, a visible card (autograd asks the
  runtime for the device's context), on which nothing is allocated;
  ``--device cpu`` traces the same program
  on fake CPU tensors (the kernel ops are still one node a call; their
  CPU implementation is the plain version).  A trace that fails is
  recorded as ``status: "error"`` with its traceback; nothing reruns on
  another path.

On a mesh whose ``model`` axis is 1 the rank's trace is the step at the
rank's batch, node for node (``fx_graph.step_summary``).  The roofline is
priced at the H100 SXM; beside the copied ``roofline_fraction`` (divided by
the TPU v5e peak, ROADMAP C17) stands ``roofline_fraction_h100``.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--cells-from file]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import (SHAPES, ShapeConfig, get_config,
                                      list_archs, shape_applicable)
from repro_torch.core.fx_graph import (graph_from_fx, rank_collectives,
                                       summarize_graph, temp_bytes,
                                       trace_rank_step)
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.roofline import build_report, to_row
from repro_torch.launch.mesh import make_production_mesh, mesh_info
from repro_torch.models import (ShapeDtype, batch_logical_axes, build_model,
                                input_specs)
from repro_torch.models import layers as L
from repro_torch.models.sharding import (P, PartitionSpec, RankView,
                                         ShardingCtx, _axes_of, make_ctx,
                                         tree_specs)
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.train.step import TrainState, abstract_state
from repro_torch.tree import leaves, map_with_path, tree_map

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")

# shape-specific sharding-rule overrides, the JAX package's.  Decode cells
# shard the KV cache along the SEQUENCE dimension: the resolver walks the
# candidates outside-in, skipping axes already consumed by the batch dim,
# so decode_32k lands on ("model",) and the batch=1 long_500k cell claims
# every idle axis; their activations replicate the head dim.
_KV_SEQ = (("pod", "data", "model"), ("data", "model"), ("model",), ())
_DECODE = {"kv_seq": _KV_SEQ, "act_heads": ((),)}
SHAPE_RULE_OVERRIDES = {
    "decode_32k": _DECODE,
    "long_500k": _DECODE,
}

_METRICS = ("loss", "grad_norm", "lr", "ce", "aux")
# the attention and SSM head axes a decode cell computes whole
_HEAD_AXES = ("heads", "kv_heads", "dt")


def _opt_state_axes(opt_name: str, params_axes):
    """Logical-axes tree for the optimizer state (mirrors optimizers.py)."""
    if opt_name == "adamw":
        return {
            "m": params_axes,
            "v": params_axes,
            "count": (),
        }
    if opt_name == "adafactor":
        def one(a):
            if len(a) >= 2:
                return {"vr": a[:-1], "vc": a[:-2] + a[-1:]}
            return {"v": a}

        return {
            "f": tree_map(one, params_axes),
            "count": (),
        }
    raise ValueError(opt_name)


def _state_axes(opt_name: str, params_axes):
    # TrainState(step, params, opt_state)
    return ((), params_axes, _opt_state_axes(opt_name, params_axes))


def _fsdp_flag(cfg):
    """Per-leaf FSDP predicate honoring cfg.fsdp_exclude (selective FSDP)."""
    if not cfg.fsdp_params:
        return False
    if not cfg.fsdp_exclude:
        return True
    excl = set(cfg.fsdp_exclude)
    return lambda axes: not ({a for a in axes if a} & excl)


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------


def shard_shape(shape, spec: PartitionSpec, sizes: dict) -> tuple:
    """A rank's piece of a ``shape`` under ``spec`` (``NamedSharding
    .shard_shape``)."""
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // math.prod(sizes[a] for a in _axes_of(p))
                 for n, p in zip(shape, parts))


def _pairs(shapes, specs) -> list:
    """``(ShapeDtype, PartitionSpec)`` of every leaf of a shapes tree and
    its specs tree (dicts, NamedTuples and tuples walked alike)."""
    if shapes is None:
        return []
    if isinstance(shapes, dict):
        return [x for k in sorted(shapes) for x in _pairs(shapes[k],
                                                         specs[k])]
    if isinstance(shapes, tuple) and not isinstance(shapes, ShapeDtype):
        return [x for a, b in zip(shapes, specs) for x in _pairs(a, b)]
    return [(shapes, specs)]


def shard_bytes(shapes, specs, sizes: dict) -> int:
    """Bytes of every leaf's shard: a rank's share of the arguments."""
    return sum(math.prod(shard_shape(sd.shape, sp, sizes)) * sd.dtype.itemsize
               for sd, sp in _pairs(shapes, specs))


def _local(shapes, specs, sizes: dict):
    """The shards' shapes, as a tree of ``ShapeDtype``."""
    if isinstance(shapes, dict):
        return {k: _local(shapes[k], specs[k], sizes) for k in shapes}
    return ShapeDtype(shard_shape(shapes.shape, specs, sizes), shapes.dtype)


def _with_paths(tree, prefix=()) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _with_paths(
            tree[k], prefix + (str(k),))]
    return [("/".join(prefix), tree)]


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _compute_specs(ctx: ShardingCtx, shapes, axes, heads_whole: bool):
    """The specs the rank computes with (see the module doc): the rules
    alone, the router's experts and, where ``heads_whole``, the head axes
    kept whole.  Resolved on a copy of ``ctx``, so its drops stay the
    arguments'."""
    scratch = dataclasses.replace(ctx, drops=[])

    def one(path, sd):
        ax = _get(axes, path)
        spec = scratch.spec_for(ax, sd.shape, path)
        parts = list(spec) + [None] * (len(sd.shape) - len(spec))
        for i, a in enumerate(ax):
            if ((heads_whole and a in _HEAD_AXES)
                    or (path.endswith("router") and a == "experts")):
                parts[i] = None
        return P(*parts)

    return map_with_path(lambda path, sd: one("/".join(path), sd), shapes)


def _ways(ctx: ShardingCtx, logical: str, size: int) -> int:
    """How many ways the rules split one dimension of ``size``."""
    scratch = dataclasses.replace(ctx, drops=[])
    spec = scratch.spec_for((logical,), (size,))
    return math.prod(ctx.mesh.sizes[a] for p in spec for a in _axes_of(p))


def _part(spec, i: int):
    return tuple(spec)[i] if i < len(spec) else None


def _rank_program(cfg, shape, ctx, args: dict, compute, meta: dict,
                  optimizer):
    """The rank's program of a cell: ``fn(device)`` traces it; ``fn.info``
    holds what ``rank_summary`` prices its collectives from."""
    kind = meta["kind"]
    sizes = ctx.mesh.sizes
    heads_whole = ctx.rules.get("act_heads") == ((),)
    H, K = cfg.num_heads, cfg.num_kv_heads
    h_ways = 1 if heads_whole else _ways(ctx, "heads", H)
    k_ways = 1 if heads_whole else _ways(ctx, "kv_heads", K)
    rank_cfg = dataclasses.replace(
        cfg, num_heads=H // h_ways, num_kv_heads=K // k_ways,
        head_dim=cfg.resolved_head_dim)
    if cfg.family == "audio" and kind == "prefill":
        # the prefill's frames are as long as the prompt (input_specs), and
        # its cross K/V as long as they are, as the JAX prefill returns
        rank_cfg = dataclasses.replace(rank_cfg, source_len=shape.seq_len)
    # context parallelism only where the rank holds every query head
    seq_q = (_ways(ctx, "seq_q", shape.seq_len)
             if kind != "decode" and h_ways == 1 else 1)
    view = RankView(model=sizes.get("model", 1), seq_q=seq_q)
    rank_ctx = ShardingCtx(mesh=ctx.mesh, rules=dict(ctx.rules), rank=view)
    model = build_model(rank_cfg)
    params = _local(args["params"], compute, sizes)
    batch = _local(args["batch"], args["batch_specs"], sizes)
    cache = (None if "cache" not in args
             else _local(args["cache"], args["cache_specs"], sizes))
    b_rank = next(iter(batch.values())).shape[0]
    accum = meta.get("grad_accum", 1)
    cache_len, kv_axes = 0, ()
    if kind == "decode":
        # the rank that holds the write position: its last cache slot
        parts = [_part(_get(args["cache_specs"], p), ax.index("kv_seq"))
                 for p, ax in _with_paths(args["cache_axes"])
                 if "kv_seq" in ax]
        kv_axes = _axes_of(parts[0]) if parts else ()
        kv_ways = math.prod(sizes[a] for a in kv_axes)
        cache_len = shape.seq_len // kv_ways - 1
    sched = cosine_with_warmup(3e-4, 100, 10_000)

    def fn(device="cuda"):
        return trace_rank_step(
            kind, model, params=params, batch=batch, cache=cache,
            optimizer=optimizer, schedule=sched, grad_accum=accum,
            max_len=shape.seq_len if kind == "prefill" else 0,
            cache_len=cache_len, ctx=rank_ctx, device=device)

    opt_specs = args.get("opt_specs")
    leaf_info = []
    for path, sd in _with_paths(params):
        arg = tuple(_get(args["param_specs"], path))
        opt_zero = False
        if opt_specs is not None:
            o = (_get(opt_specs["m"], path) if "m" in opt_specs
                 else leaves(_get(opt_specs["f"], path))[0])
            opt_zero = ("data" in {a for q in o for a in _axes_of(q)}
                        and "data" not in {a for q in arg
                                           for a in _axes_of(q)})
        leaf_info.append({"path": path,
                          "axes": _get(args["param_axes"], path), "arg": arg,
                          "compute": tuple(_get(compute, path)),
                          "shape": sd.shape, "itemsize": sd.dtype.itemsize,
                          "opt_zero": opt_zero})
    first = next(iter(args["batch_specs"].values()))
    micro = b_rank // accum
    text = (shape.seq_len - cfg.num_patches) if kind == "train" else 1
    fn.info = {
        "leaf_info": leaf_info, "grad_accum": accum, "seq_q": seq_q,
        "tokens": micro * (shape.seq_len if kind != "decode" else 1),
        "head_tokens": micro * text, "kv_seq_axes": kv_axes,
        "batch_axes": _axes_of(_part(first, 0)), "rank_cfg": rank_cfg,
        "cache_len": cache_len, "batch": batch, "cache": cache,
        "heads_whole": heads_whole,
    }
    return fn


def build_cell(arch: str, shape_name: str, multi_pod: bool, cfg=None,
               mesh=None, shape: ShapeConfig = None):
    """Returns ``(fn, arg_shapes, in_specs, out_specs, ctx, meta)``, the JAX
    package's six, with PartitionSpec trees for its NamedShardings and the
    rank's program for its step: ``fn(device)`` traces it, ``fn.info``
    holds the rank's shapes and what prices its collectives.  ``mesh`` and
    ``shape`` replace the production mesh and ``SHAPES[shape_name]`` (a
    1-rank mesh, the card's own cells)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    overrides = dict(cfg.sharding_overrides or {})
    overrides.update(SHAPE_RULE_OVERRIDES.get(shape.name, {}))
    ctx = make_ctx(mesh, overrides=overrides)
    model = build_model(cfg)
    batch_specs = input_specs(cfg, shape)
    batch_axes = batch_logical_axes(cfg, shape)
    batch_sp = {k: ctx.spec_for(batch_axes[k], v.shape, k)
                for k, v in batch_specs.items()}
    heads_whole = ctx.rules.get("act_heads") == ((),)
    b = shape.global_batch
    logits = ShapeDtype((b, 1, cfg.vocab_size), torch.float32)

    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        state_shapes, params_axes = abstract_state(model, opt)
        # params: TP (+FSDP over data for >=100B configs); optimizer state:
        # always ZeRO-1 sharded over the data axis.
        params_specs = tree_specs(ctx, state_shapes.params, params_axes,
                                  zero1=_fsdp_flag(cfg))
        opt_specs = tree_specs(ctx, state_shapes.opt_state,
                               _opt_state_axes(cfg.optimizer, params_axes),
                               zero1=True)
        state_specs = TrainState(P(), params_specs, opt_specs)
        accum = (cfg.grad_accum
                 if shape.global_batch % max(cfg.grad_accum, 1) == 0 else 1)
        meta = {"donate": (0,), "kind": "train", "grad_accum": accum}
        compute = _compute_specs(ctx, state_shapes.params, params_axes,
                                 heads_whole)
        fn = _rank_program(cfg, shape, ctx, {
            "params": state_shapes.params, "param_specs": params_specs,
            "param_axes": params_axes, "opt_specs": opt_specs,
            "batch": batch_specs, "batch_specs": batch_sp}, compute, meta,
            opt)
        metrics = {k: ShapeDtype((), torch.float32) for k in _METRICS}
        fn.info["out_shapes"] = (state_shapes, metrics)
        return (
            fn,
            (state_shapes, batch_specs),
            (state_specs, batch_sp),
            (state_specs, {k: P() for k in _METRICS}),
            ctx,
            meta,
        )

    params_shapes, params_axes = model.abstract_params()
    # serving weights are bf16 (production checkpoints are served quantized
    # or half precision; the model casts to compute dtype at use anyway)
    params_shapes = tree_map(
        lambda s: ShapeDtype(s.shape, torch.bfloat16
                             if s.dtype.is_floating_point else s.dtype),
        params_shapes)
    # >=100B-class configs additionally shard serving weights over the data
    # axis (weight-gathered serving): TP alone leaves 50+ GB per chip.
    params_specs = tree_specs(ctx, params_shapes, params_axes,
                              zero1=_fsdp_flag(cfg))
    compute = _compute_specs(ctx, params_shapes, params_axes, heads_whole)
    cache_dtype = torch.bfloat16
    args = {"params": params_shapes, "param_specs": params_specs,
            "param_axes": params_axes}

    if shape.kind == "prefill":
        cache_shapes = _prefill_cache(model, cfg, shape, cache_dtype)
        cache_specs = tree_specs(ctx, cache_shapes, model.cache_axes())
        logits_spec = ctx.spec_for(("batch", None, "vocab"),
                                   (b, 1, cfg.vocab_size), "logits")
        meta = {"donate": (), "kind": "prefill"}
        fn = _rank_program(cfg, shape, ctx, dict(
            args, batch=batch_specs, batch_specs=batch_sp), compute, meta,
            None)
        fn.info["out_shapes"] = (logits, cache_shapes)
        return (
            fn,
            (params_shapes, batch_specs),
            (params_specs, batch_sp),
            (logits_spec, cache_specs),
            ctx,
            meta,
        )

    # decode: one token against a cache of seq_len
    cache_shapes = model.abstract_cache(b, shape.seq_len, dtype=cache_dtype)
    cache_axes = model.cache_axes()
    cache_specs = tree_specs(ctx, cache_shapes, cache_axes)
    logits_spec = ctx.spec_for(("batch", None, "vocab"),
                               (b, 1, cfg.vocab_size), "logits")
    meta = {"donate": (1,), "kind": "decode"}  # cache updated in place
    fn = _rank_program(cfg, shape, ctx, dict(
        args, batch={"token": batch_specs["token"]},
        batch_specs={"token": batch_sp["token"]}, cache=cache_shapes,
        cache_specs=cache_specs, cache_axes=cache_axes), compute, meta, None)
    fn.info["out_shapes"] = (logits, cache_shapes)
    return (
        fn,
        (params_shapes, cache_shapes, batch_specs["token"]),
        (params_specs, cache_specs, batch_sp["token"]),
        (logits_spec, cache_specs),
        ctx,
        meta,
    )


def _prefill_cache(model, cfg, shape, dtype):
    """The cache a prefill of ``shape`` returns: ``init_cache``'s at the
    prompt's length, the encoder-decoder's cross K/V as long as its frames
    (the JAX prefill's scan output)."""
    cache = model.abstract_cache(shape.global_batch, shape.seq_len,
                                 dtype=dtype)
    if cfg.family == "audio":
        cache["cross"] = {k: ShapeDtype(
            v.shape[:2] + (shape.seq_len,) + v.shape[3:], v.dtype)
            for k, v in cache["cross"].items()}
    return cache


def cell_memory(fn, shapes, in_specs, out_specs, meta: dict, sizes: dict,
                temp: int) -> dict:
    """``run_cell``'s memory figures: the arguments' shard bytes (exact),
    the outputs' by the out specs, the donated argument's as the alias,
    and the traced program's temp (the port's estimate)."""
    donated = meta["donate"]
    alias = sum(shard_bytes(shapes[i], in_specs[i], sizes) for i in donated)
    return {
        "argument_size_in_bytes": shard_bytes(shapes, in_specs, sizes),
        "output_size_in_bytes": shard_bytes(fn.info["out_shapes"],
                                            out_specs, sizes),
        "temp_size_in_bytes": temp,
        "alias_size_in_bytes": alias,
        "generated_code_size_in_bytes": None,
        "temp_source": "port: peak live intermediate bytes of the traced "
                       "rank program (core.fx_graph.temp_bytes), not XLA's",
    }


def rank_summary(fn, mesh, cfg, kind: str, device="cuda") -> tuple:
    """Trace the rank's program and price it: ``(summary, temp bytes,
    seconds)``, the summary with ``module_summary``'s keys (``graph``
    included) plus ``dot_flops``, ``kinds`` and ``kernel_nodes`` (the
    kernel ops' nodes, one a launch on the card)."""
    t0 = time.time()
    gm = fn(device)
    t_trace = time.time() - t0
    t0 = time.time()
    summary = summarize_graph(graph_from_fx(gm, f"{kind}_rank_{cfg.name}"))
    kernels: dict = {}
    for n in summary["graph"].nodes:
        if n.kind == "custom-call":
            kernels[n.meta["kernel"]] = kernels.get(n.meta["kernel"], 0) + 1
    summary["kernel_nodes"] = kernels
    info = fn.info
    summary.update(rank_collectives(
        cfg, kind, info["leaf_info"], sizes=mesh.sizes,
        dcn_axes=mesh_info(mesh).dcn_axes, batch_axes=info["batch_axes"],
        tokens=info["tokens"], head_tokens=info["head_tokens"],
        grad_accum=info["grad_accum"], seq_q=info["seq_q"],
        kv_seq_axes=info["kv_seq_axes"], heads_whole=info["heads_whole"],
        act_itemsize=L.dtype_of(cfg.compute_dtype).itemsize))
    temp = temp_bytes(gm)
    return summary, temp, {"trace_s": t_trace,
                           "graph_s": time.time() - t0}


def _variant_notes(cfg) -> str:
    """What a config field the port has no counterpart of does here."""
    base = {f.name: f.default for f in dataclasses.fields(cfg)}
    notes = []
    if cfg.gqa_repeat_to != base["gqa_repeat_to"]:
        notes.append(f"gqa_repeat_to={cfg.gqa_repeat_to} moves nothing in "
                     "the port: its flash kernel reads the K/V heads in "
                     "place (GQA by index), never repeated")
    if cfg.attn_block_kv != base["attn_block_kv"]:
        notes.append(f"attn_block_kv={cfg.attn_block_kv} moves nothing in "
                     "the port: its flash kernel has no KV block option")
    return "; ".join(notes)


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             cfg=None, tag: str = "", run_spec=None, device="cuda",
             mesh=None, shape: ShapeConfig = None) -> dict:
    """One cell's record (written to ``out_dir``).  ``mesh`` and ``shape``
    as in :func:`build_cell`."""
    multi_pod = mesh_name == "multi"
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    chips = (mesh.n_ranks if mesh is not None
             else 512 if multi_pod else 256)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "status": "", "variant": tag or "baseline",
    }
    if run_spec is not None:
        rec["run_spec"] = run_spec.to_dict()
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(
        out_dir, f"{arch}__{shape.name}__{mesh_name}{suffix}.json"
    )
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(path, rec)
        return rec
    try:
        t0 = time.time()
        fn, shapes, in_sh, out_sh, ctx, meta = build_cell(
            arch, shape.name, multi_pod, cfg=cfg, mesh=mesh, shape=shape)
        t_build = time.time() - t0
        summary, temp, secs = rank_summary(fn, ctx.mesh, cfg, meta["kind"],
                                           device=device)
        notes = _variant_notes(cfg)
        report = build_report(cfg, shape, mesh_name, chips, summary,
                              platform=H100_SXM, notes=notes)
        row = to_row(report)
        row["roofline_fraction_h100"] = (
            (report.model_flops_global / chips / H100_SXM.chip.peak_flops)
            / report.bound_time_s if report.bound_time_s > 0 else 0.0)
        rec.update(
            status="ok",
            device=device,
            build_s=round(t_build, 2),
            trace_s=round(secs["trace_s"], 2),
            graph_s=round(secs["graph_s"], 2),
            hlo_bytes=None,
            memory=cell_memory(fn, shapes, in_sh, out_sh, meta,
                               ctx.mesh.sizes, temp),
            xla_cost=None,
            summary={k: v for k, v in summary.items() if k != "graph"},
            roofline=row,
            sharding_drops=[str(d) for d in ctx.drops[:40]],
            num_drops=len(ctx.drops),
            meta=meta,
            rank={"batch": _shapes_json(fn.info["batch"]),
                  "heads": fn.info["rank_cfg"].num_heads,
                  "kv_heads": fn.info["rank_cfg"].num_kv_heads,
                  "seq_q": fn.info["seq_q"],
                  "cache_len": fn.info["cache_len"]},
            notes=notes,
        )
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _write(path, rec)
    return rec


def _shapes_json(tree) -> dict:
    return {k: list(v.shape) for k, v in tree.items()}


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> None:
    from repro_torch.launch import spec as runspec

    ap = argparse.ArgumentParser()
    # shared launch surface (repro_torch.launch.spec): --arch/--smoke/--seed
    # plus the dryrun cell selectors --shape/--mesh
    runspec.add_args(ap, "model", "dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells-from", default=None,
                    help="file with one 'arch|shape|mesh' per line")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="fake tensors of this device: cuda traces the "
                         "card's program (needs a PyTorch built with CUDA, "
                         "and a train cell a visible card, on which nothing "
                         "is allocated); cpu the same ops on the CPU")
    args = ap.parse_args(argv)
    spec = runspec.from_args(args)

    cells: list[tuple[str, str, str]] = []
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.cells_from:
        with open(args.cells_from) as f:
            for line in f:
                line = line.strip()
                if line:
                    a, s, m = line.split("|")
                    cells.append((a, s, m))
    elif args.all:
        for a in list_archs():
            for s in SHAPES:
                for m in meshes:
                    cells.append((a, s, m))
    else:
        assert args.arch and args.shape
        for m in meshes:
            cells.append((args.arch, args.shape, m))

    for a, s, m in cells:
        path = os.path.join(args.out, f"{a}__{s}__{m}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip existing] {a} {s} {m}", flush=True)
            continue
        t0 = time.time()
        rec = run_cell(a, s, m, args.out, run_spec=spec, device=args.device)
        dt = time.time() - t0
        msg = rec["status"]
        if msg == "ok":
            mem = rec["memory"]["temp_size_in_bytes"] / 2**30
            msg += (
                f" trace={rec['trace_s']}s temp={mem:.2f}GiB "
                f"flops/dev={rec['summary']['flops']:.3g} "
                f"coll(ici/dcn)={rec['summary']['collective_bytes_ici']:.3g}/"
                f"{rec['summary']['collective_bytes_dcn']:.3g}"
            )
        elif msg == "error":
            msg += " " + rec["error"][:160]
        print(f"[{dt:7.1f}s] {a} {s} {m}: {msg}", flush=True)
        gc.collect()


if __name__ == "__main__":
    main()
