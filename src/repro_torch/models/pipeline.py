"""Partitioning real models onto the pipeline-schedule executor.

The torch counterpart of the JAX package's ``models/pipeline.py``: the
transformer / MoE block stack split into per-stage pieces and driven through
``repro_torch.dist.pp``'s scheduled executor, so the model's own
``apply_block`` (attention through the flash-attention kernel op, the
norms through the RMSNorm kernel op, the dense or MoE FFN, the config's
remat) runs under GPipe / 1F1B / interleaved-1F1B step tables with an
explicit scheduled backward.

A :class:`PipelinePlan` names the partition: ``pp`` stage ranks times
``vstages`` model chunks per rank, each chunk a contiguous run of
``num_layers / (pp * vstages)`` decoder blocks; the token embedding rides
with the first virtual stage (``first_fn``) and the final norm + lm head +
cross-entropy with the last (``loss_fn``), so every parameter's gradient —
embedding and head included — comes out of the scheduled backward.  MoE
router auxiliary losses are emitted per block and seeded locally.  The
stages run without a sharding context, so MoE takes its einsum FFN, as the
reference's stages do inside ``shard_map``.

Loss convention: one pipeline step trains the *mean* over its
``microbatches`` of the model's per-microbatch loss — what
``train.step.make_train_step(grad_accum=M)`` computes for the same batch
split, and what :func:`microbatched_reference` computes.

The simulator prices the same partition through
``repro_torch.core.strategy.model_pipeline_graph``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import pp
from repro_torch.dist.schedules import PipelineSchedule, make_schedule
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.build import ShapeDtype
from repro_torch.tree import tree_map

# model families whose block stack is a homogeneous transformer stack the
# executor can chunk (vlm is excluded: the patch projector makes the first
# stage's input heterogeneous; hybrid/ssm mixers are not partitioned)
_PIPELINE_FAMILIES = ("dense", "moe")


@dataclass(frozen=True)
class PipelinePlan:
    """One executable+simulable pipeline partition of an ArchConfig."""

    cfg: ArchConfig
    pp: int
    microbatches: int
    schedule: str = "1f1b"
    vstages: int = 1

    @property
    def n_vstages(self) -> int:
        return self.pp * self.vstages

    @property
    def layers_per_vstage(self) -> int:
        return self.cfg.num_layers // self.n_vstages

    def make_schedule(self) -> PipelineSchedule:
        return make_schedule(
            self.schedule, self.pp, self.microbatches, self.vstages
        )

    def strategy(self, dp: int = 1, compression: str = "none"):
        """The simulator Strategy this plan executes."""
        from repro_torch.core.strategy import Strategy

        return Strategy(
            dp=dp, pp=self.pp, microbatches=self.microbatches,
            schedule=self.schedule, vstages=self.vstages,
            compression=compression,
        )

    def act_shape(self, micro_batch: int, seq: int) -> tuple[int, int, int]:
        """Shape of the activation one boundary hop ships (one microbatch)."""
        return (micro_batch, seq, self.cfg.d_model)

    def hop_bytes(self, micro_batch: int, seq: int) -> float:
        """Per-hop wire payload — the executor's ppermute byte twin."""
        return pp.boundary_bytes(self.act_shape(micro_batch, seq),
                                 self.cfg.compute_dtype)

    def boundary_bytes_per_step(self, micro_batch: int, seq: int) -> float:
        """Total scheduled boundary traffic of one pipeline step."""
        return self.make_schedule().comm_bytes(
            self.hop_bytes(micro_batch, seq)
        )

    def describe(self) -> str:
        sched = self.schedule + (
            f"v{self.vstages}" if self.vstages > 1 else ""
        )
        return (
            f"{self.cfg.name}:pp{self.pp}xmb{self.microbatches}({sched})"
            f" {self.layers_per_vstage}L/vstage"
        )


def check_pipelineable(cfg: ArchConfig, pp_stages: int,
                       vstages: int = 1) -> None:
    """Raise ValueError when this config cannot realize the partition."""
    if cfg.family not in _PIPELINE_FAMILIES:
        raise ValueError(
            f"pipeline partitioning supports families {_PIPELINE_FAMILIES}; "
            f"{cfg.name} is family={cfg.family!r}"
        )
    if cfg.num_patches:
        raise ValueError(
            f"{cfg.name}: vlm patch projector not pipeline-partitionable"
        )
    V = pp_stages * vstages
    if V < 1 or cfg.num_layers % V != 0:
        raise ValueError(
            f"{cfg.name}: num_layers {cfg.num_layers} not divisible by "
            f"pp*vstages = {pp_stages}*{vstages} = {V}"
        )


def make_plan(cfg: ArchConfig, pp_stages: int, microbatches: int,
              schedule: str = "1f1b", vstages: int = 1) -> PipelinePlan:
    """Validated plan: partitionable config AND realizable schedule."""
    check_pipelineable(cfg, pp_stages, vstages)
    plan = PipelinePlan(
        cfg=cfg, pp=pp_stages, microbatches=microbatches,
        schedule=schedule, vstages=vstages,
    )
    plan.make_schedule().validate()
    return plan


# ---------------------------------------------------------------------------
# Parameter partition: model layout <-> (first, blocks, last)
# ---------------------------------------------------------------------------


def partition_params(cfg: ArchConfig, params):
    """Split a transformer param tree into the executor's three stages:
    ``first`` (embedding), ``blocks`` (the layer-major stack the schedule
    chunks), ``last`` (final norm + head).  With tied embeddings the table
    appears in BOTH first and last; :func:`merge_grads` sums the two
    gradient contributions."""
    head = "embed" if cfg.tie_embeddings else "head"
    last = {"final_norm": params["final_norm"], head: params[head]}
    return {"embed": params["embed"]}, params["blocks"], last


def merge_grads(cfg: ArchConfig, gfirst, gblocks, glast):
    """Inverse of :func:`partition_params` for gradient trees."""
    g_embed = gfirst["embed"]
    if "embed" in glast:
        g_embed = g_embed + glast["embed"].to(g_embed.device)
    out = {
        "embed": g_embed,
        "blocks": gblocks,
        "final_norm": glast["final_norm"],
    }
    if "head" in glast:
        out["head"] = glast["head"]
    return out


def split_microbatches(batch: dict, microbatches: int) -> dict:
    """(B, ...) leaves -> (M, B/M, ...), consecutive-row blocks (the split
    of ``train.step._split_microbatches``)."""

    def split(x):
        b = x.shape[0]
        assert b % microbatches == 0, (
            f"batch {b} % microbatches {microbatches} != 0"
        )
        return x.reshape((microbatches, b // microbatches)
                         + tuple(x.shape[1:]))

    return {k: split(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Stage callables: the real block math under the schedule
# ---------------------------------------------------------------------------


def stage_fns(cfg: ArchConfig, microbatches: int):
    """(first_fn, layer_fn, loss_fn) for ``repro_torch.dist.pp``'s
    scheduled executor.

    * ``first_fn(first_params, xs_m)``: ``layers.embed`` -> (B, S, D).
    * ``layer_fn(block_params, h) -> (h, aux/M)``: ONE decoder block via
      ``transformer.apply_block`` under the config's remat; the MoE router
      balance aux is scaled by 1/M so the summed step aux equals the
      microbatch mean of the model's.
    * ``loss_fn(last_params, y, loss_m)``: final norm + the head of
      ``transformer.head_weight`` + ``chunked_xent`` on the microbatch
      labels, scaled by 1/M.
    """
    inv_m = 1.0 / float(microbatches)

    def first_fn(first_p, xs_m):
        return L.embed(first_p["embed"], xs_m["tokens"], cfg)

    def block_fn(block_p, h):
        b, s = h.shape[0], h.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=h.device).expand(b, s)
        y, aux = transformer.apply_block(block_p, h, cfg,
                                         positions=positions)
        return y, aux * inv_m

    layer_fn = transformer._remat(block_fn, cfg)

    def loss_fn(last_p, y, loss_m):
        h = L.rmsnorm(y, last_p["final_norm"], cfg.norm_eps,
                      cfg.compute_dtype)
        w, kw = transformer.head_weight(last_p, cfg)
        ce = L.chunked_xent(h, w, loss_m["labels"], chunk=cfg.loss_chunk,
                            mask=loss_m.get("loss_mask"), **kw)
        return ce * inv_m

    return first_fn, layer_fn, loss_fn


def pipeline_loss_and_grads(plan: PipelinePlan, params, batch: dict, mesh,
                            axis_name: str = "stage"):
    """Run one real-model pipeline step: scheduled forward AND backward.

    Returns ``(loss, metrics, grads)`` with ``loss = ce + aux`` (the mean
    over the plan's microbatches), ``metrics = {"ce", "aux"}``, and
    ``grads`` in the model's parameter layout (embedding/head included):
    the gradient of :func:`microbatched_reference`.
    """
    cfg, M = plan.cfg, plan.microbatches
    micro = split_microbatches(batch, M)
    xs = {"tokens": micro["tokens"]}
    loss_inputs = {k: v for k, v in micro.items() if k != "tokens"}
    first, blocks, last = partition_params(cfg, params)
    first_fn, layer_fn, loss_fn = stage_fns(cfg, M)
    ce, aux, _outs, (gf, gb, gl) = pp.pipeline_stage_shard_map(
        first, blocks, last, xs, loss_inputs, layer_fn,
        mesh, plan.make_schedule(),
        first_fn=first_fn, loss_fn=loss_fn, axis_name=axis_name,
    )
    grads = merge_grads(cfg, gf, gb, gl)
    return ce + aux, {"ce": ce, "aux": aux}, grads


def microbatched_reference(model, microbatches: int):
    """The loss the pipeline executor must reproduce: the mean over
    microbatches of ``model.loss`` — what ``make_train_step(grad_accum=
    microbatches)`` accumulates."""

    def ref_loss(params, batch):
        micro = split_microbatches(batch, microbatches)
        total = 0.0
        for m in range(microbatches):
            lval, _metrics = model.loss(params, {k: v[m]
                                                 for k, v in micro.items()})
            total = total + lval
        return total / microbatches

    return ref_loss


# ---------------------------------------------------------------------------
# Simulator-facing partition accounting
# ---------------------------------------------------------------------------


def stage_param_trees(plan: PipelinePlan, params) -> list[dict]:
    """Per-stage parameter trees (:class:`ShapeDtype` leaves): stage ``s``
    owns its ``vstages`` chunks of every block leaf, plus the embedding
    (stage 0) and the final norm/head (stage S-1; a tied table on both).
    Feeds the per-stage gradient all-reduce annotations of
    ``core.strategy.model_pipeline_graph``."""
    cfg = plan.cfg
    first, blocks, last = partition_params(cfg, params)
    rows = plan.vstages * plan.layers_per_vstage

    def stage_rows(leaf):
        return ShapeDtype((rows,) + tuple(leaf.shape[1:]), leaf.dtype)

    def as_sds(tree):
        return tree_map(lambda a: ShapeDtype(tuple(a.shape), a.dtype), tree)

    out = []
    for s in range(plan.pp):
        t = {"blocks": tree_map(stage_rows, blocks)}
        if s == 0:
            t["first"] = as_sds(first)
        if s == plan.pp - 1:
            t["last"] = as_sds(last)
        out.append(t)
    return out


def moe_layers_per_vstage(plan: PipelinePlan) -> list[int]:
    """How many MoE blocks each virtual stage's chunk contains."""
    cfg = plan.cfg
    per = plan.layers_per_vstage
    out = []
    for k in range(plan.n_vstages):
        lo = k * per
        out.append(
            sum(
                1
                for i in range(lo, lo + per)
                if cfg.moe is not None
                and i % cfg.moe.every_k == cfg.moe.offset
            )
        )
    return out


def _layer_key(cfg: ArchConfig, micro_batch: int, seq: int,
               tp: int) -> dict:
    return {"arch": cfg.name, "micro_batch": int(micro_batch),
            "seq": int(seq), "tp": int(tp)}


def profile_layer(db, platform: str, cfg: ArchConfig, micro_batch: int,
                  seq: int, device, repeats: int = 5) -> dict:
    """Time one decoder block of ``cfg`` (random seeded weights, the
    config's compute dtype and remat) on a (micro_batch, seq) activation on
    ``device``: its forward with the graph kept, as the executor's F step
    runs it, and its backward, as a B step runs it (the recompute
    included).  Records the means under ``layer_fwd``/``layer_bwd`` keyed by
    (arch, micro_batch, seq, tp=1), the entries :func:`model_layer_cost`
    points the estimator at.  Returns ``{"fwd_s", "bwd_s", "fwd_std_s",
    "bwd_std_s"}``."""
    import time

    import numpy as np

    from repro_torch.core.database import ProfileEntry
    from repro_torch.device import synchronize
    from repro_torch.tree import leaves

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    block = tree_map(lambda t: t.requires_grad_(),
                     transformer.init_block(gen, cfg))
    _first, layer_fn, _loss = stage_fns(cfg, 1)
    cdt = L.dtype_of(cfg.compute_dtype)
    x = torch.randn((micro_batch, seq, cfg.d_model), generator=gen,
                    device=device).to(cdt).requires_grad_()
    dy = torch.randn((micro_batch, seq, cfg.d_model), generator=gen,
                     device=device).to(cdt)
    fwd, bwd = [], []
    for i in range(max(repeats, 1) + 2):
        synchronize(device)
        t0 = time.perf_counter()
        y, _aux = layer_fn(block, x)
        synchronize(device)
        t1 = time.perf_counter()
        torch.autograd.backward([y], [dy])
        synchronize(device)
        t2 = time.perf_counter()
        for t in [x] + leaves(block):
            t.grad = None
        del y
        if i >= 2:        # two warm-up rounds: first-call costs
            fwd.append(t1 - t0)
            bwd.append(t2 - t1)
    out = {"fwd_s": float(np.mean(fwd)), "bwd_s": float(np.mean(bwd)),
           "fwd_std_s": float(np.std(fwd)), "bwd_std_s": float(np.std(bwd))}
    key = _layer_key(cfg, micro_batch, seq, 1)
    db.add(platform, "layer_fwd", ProfileEntry(
        dict(key), out["fwd_s"], out["fwd_std_s"], len(fwd)))
    db.add(platform, "layer_bwd", ProfileEntry(
        dict(key), out["bwd_s"], out["bwd_std_s"], len(bwd)))
    return out


def model_layer_cost(cfg: ArchConfig, micro_batch: int, seq: int,
                     tp: int = 1, db=None, platform: str = ""):
    """Per-layer LayerCost with the partition's REAL boundary payload.

    Flops and bytes come from the analytic
    ``core.autotuner.layer_cost_from_config``; ``boundary_bytes`` is the
    activation payload the executor ships per hop.  With ``db``, the layer
    must have been measured on ``platform`` (:func:`profile_layer`): the
    cost then carries the DB key of that measurement, and the estimator
    prices a pipeline chunk of n layers as n times the layer's forward or
    backward.  A layer nobody profiled raises.
    """
    from repro_torch.core.autotuner import layer_cost_from_config

    base = layer_cost_from_config(cfg, micro_batch, seq, tp=tp)
    hop = pp.boundary_bytes((micro_batch, seq, cfg.d_model),
                            cfg.compute_dtype)
    cost = dataclasses.replace(base, boundary_bytes=hop)
    if db is None:
        return cost
    key = _layer_key(cfg, micro_batch, seq, tp)
    for kind in ("layer_fwd", "layer_bwd"):
        if db.lookup(platform, kind, key) is None:
            raise KeyError(f"no measured {kind} for {key} on {platform!r}: "
                           "profile it first (profile_layer)")
    return dataclasses.replace(cost, profile_key=tuple(sorted(key.items())))
