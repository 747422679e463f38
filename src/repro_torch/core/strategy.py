"""Training-strategy config + synthetic schedule graphs for the simulator.

The paper: "[the simulation module] also needs additional information about
the training strategy from a config file, such as the number of replicas in
data parallelism, and the pipelining setting for model parallelism which may
not be available in the dataflow graph."

:class:`Strategy` is that config.  :func:`pipeline_graph` materializes a
pipeline-parallel training step (GPipe, 1F1B, or interleaved-1F1B) as a
DataflowGraph with per-stage device placements — the heterogeneous-placement
case of the simulator, and the substrate the autotuner searches over.

The schedule itself is NOT hand-rolled here: the graph is built from the
same ``repro_torch.dist.schedules`` step table that
``repro_torch.dist.pp.pipeline_schedule_shard_map`` executes for real.  Each
table entry becomes an F/B node placed on its ``stage{s}`` device, data
dependencies come from ``PipelineSchedule.data_deps``, and per-device
serialization edges pin the simulated order to the table order — so the
DES timeline and the shard_map executor realize the identical schedule
(asserted in tests/test_schedule_parity.py).

A copy of the JAX package's ``core/strategy.py`` with its imports
rewritten; ``tests/test_torch_strategy.py`` holds its graphs identical.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.graph import DataflowGraph


@dataclass(frozen=True)
class Strategy:
    dp: int = 1                 # data-parallel replicas
    tp: int = 1                 # tensor-parallel width
    pp: int = 1                 # pipeline stages
    ep: int = 1                 # expert-parallel width
    microbatches: int = 1
    schedule: str = "1f1b"      # "gpipe" | "1f1b" | "interleaved_1f1b"
    vstages: int = 1            # virtual stages (model chunks) per device
    remat: str = "dots"
    zero1: bool = False
    # gradient-compression scheme applied to the dp all-reduce: "none",
    # "int8" (numerics executable via repro_torch.dist.compress.compressed_psum),
    # or "topk:<frac>" (byte-accounting only — see compressed_allreduce_bytes)
    compression: str = "none"
    # >= 2: split each stage's dp gradient all-reduce into this many
    # reverse-topological buckets launched as backward finishes their
    # virtual stages (executable twin: repro_torch.dist.compress.compressed_psum
    # with buckets / bucketed_pmean).  0/1 = one all-reduce per stage.
    overlap_buckets: int = 0

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.pp

    def describe(self) -> str:
        tag = "" if self.compression == "none" else f",{self.compression}"
        if self.overlap_buckets >= 2:
            tag += f",ob{self.overlap_buckets}"
        sched = self.schedule + (f"v{self.vstages}" if self.vstages > 1 else "")
        return (
            f"dp{self.dp}xtp{self.tp}xpp{self.pp}"
            f"(ep{self.ep},mb{self.microbatches},{sched}{tag})"
        )

    def make_pipeline_schedule(self):
        """The shared step table this strategy simulates AND executes."""
        from repro_torch.dist.schedules import make_schedule

        return make_schedule(
            self.schedule, self.pp, self.microbatches, self.vstages
        )


@dataclass(frozen=True)
class LayerCost:
    """Per-layer per-microbatch cost profile (per tp-shard)."""

    fwd_flops: float
    fwd_bytes: float
    bwd_multiplier: float = 2.0
    # bytes crossing a stage boundary per microbatch (activations fwd,
    # gradients bwd)
    boundary_bytes: float = 0.0
    # gradient all-reduce payload per stage (dp > 1)
    grad_bytes: float = 0.0
    # distinct gradient tensors behind grad_bytes — compressed schemes ship
    # per-tensor metadata (one f32 scale each for int8), so the estimator
    # needs the count, not just the element total
    grad_tensors: int = 1
    # the ProfileDB key (sorted (name, value) pairs) of this layer's forward
    # and backward measured on the card (``layer_fwd``/``layer_bwd``); the
    # estimator prices a chunk of n layers as n times them.  None: priced
    # from flops and bytes
    profile_key: Optional[tuple] = None


class GraphBuilder:
    """Name-keyed DAG builder: add in any order, emits topologically."""

    def __init__(self, name: str):
        self.name = name
        self.specs: dict[str, dict] = {}

    def add(self, name: str, kind: str, deps: list[str], **kw):
        assert name not in self.specs, f"duplicate node {name}"
        self.specs[name] = {"kind": kind, "deps": deps, "kw": kw}

    def build(self) -> DataflowGraph:
        indeg = {n: 0 for n in self.specs}
        succ: dict[str, list[str]] = {n: [] for n in self.specs}
        for n, s in self.specs.items():
            for d in s["deps"]:
                if d not in self.specs:
                    raise KeyError(f"node {n} depends on unknown {d}")
                indeg[n] += 1
                succ[d].append(n)
        queue = deque(sorted(n for n, d in indeg.items() if d == 0))
        g = DataflowGraph(self.name)
        uid: dict[str, int] = {}
        while queue:
            n = queue.popleft()
            s = self.specs[n]
            node = g.add(n, s["kind"], deps=[uid[d] for d in s["deps"]], **s["kw"])
            uid[n] = node.uid
            for m in succ[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    queue.append(m)
        if len(uid) != len(self.specs):
            missing = set(self.specs) - set(uid)
            raise ValueError(f"cycle through {sorted(missing)[:5]}")
        g.validate()
        return g


def pipeline_graph(
    n_layers: int,
    cost: LayerCost,
    strategy: Strategy,
    hop_meta_extra: Optional[dict] = None,
    grad_bytes_per_stage: Optional[list[float]] = None,
    grad_meta_per_stage: Optional[list[dict]] = None,
    moe_a2a: Optional[dict] = None,
) -> DataflowGraph:
    """Build the fwd/bwd microbatch DAG for a pipeline-parallel step.

    The DAG is the strategy's :class:`repro_torch.dist.schedules.PipelineSchedule`
    step table made explicit: one F/B node per table entry on device
    ``stage{k % S}`` (``k`` the virtual stage), virtual-stage-boundary sends
    on "link:pp", and the closing gradient all-reduce per device on
    "link:dp{s}".  Two kinds of edges realize the table:

      * data edges — ``PipelineSchedule.data_deps`` (activations forward,
        cotangents backward, routed through the send nodes);
      * serialization edges — each step depends on the previous step of the
        same device, pinning the simulated per-device order to the exact
        table order the executor runs.

    GPipe's flush, 1F1B's ``S - s`` in-flight window, and interleaving all
    emerge from the table rather than from schedule-specific dependency
    arithmetic.

    Every collective node this builder emits (boundary sends, gradient
    all-reduces, MoE a2a) is priced by the estimator's measured chain on a
    calibrated host — exact DB hit -> fitted CollectiveModel -> ring
    (repro_torch.netprof) — with the chosen source stamped into
    ``node.meta["time_provenance"]`` after simulation.

    The optional keyword arguments let a *model-derived* partition
    (:func:`model_pipeline_graph`) refine the synthetic defaults without a
    second builder: ``hop_meta_extra`` merges into every boundary-send
    node's meta (e.g. the ``pp_hop`` payload annotation
    ``repro_torch.core.estimator.dist_comm_bytes`` resolves through the executor
    byte twin), ``grad_bytes_per_stage`` / ``grad_meta_per_stage`` replace
    the uniform per-stage gradient all-reduce payload with the partition's
    exact per-stage trees, and ``moe_a2a`` (``{"meta": .., "comm_bytes":
    .., "group_size": .., "layers_per_vstage": [..]}``) attaches one
    expert-dispatch all-to-all node per (MoE layer, fwd step).  A ``cost``
    with a ``profile_key`` (a layer measured on the card) marks every F/B
    node with it and the chunk's layer count, which the estimator prices
    as that many times the measured layer.
    """
    from repro_torch.dist.schedules import FWD

    schedule = strategy.make_pipeline_schedule()
    schedule.validate()
    S, M, V = schedule.n_stages, schedule.n_microbatches, schedule.n_vstages
    if n_layers % V != 0:
        raise ValueError(
            f"layers {n_layers} not divisible by virtual stages {V} "
            f"(pp={strategy.pp} x v={strategy.vstages})"
        )
    per_vstage = n_layers // V
    b = GraphBuilder(f"pipeline_{strategy.describe()}")

    fwd_flops = cost.fwd_flops * per_vstage
    fwd_bytes = cost.fwd_bytes * per_vstage
    bwd_flops = fwd_flops * cost.bwd_multiplier
    bwd_bytes = fwd_bytes * cost.bwd_multiplier
    # a measured layer: the estimator prices the chunk as per_vstage times it
    layer_meta = ({"meta": {"layer_profile": dict(cost.profile_key),
                            "layers": per_vstage}}
                  if cost.profile_key else {})
    # boundary sends carry the exact per-hop payload the executor ppermutes;
    # dist_comm_bytes passes comm_bytes through (or, with a pp_hop
    # annotation from hop_meta_extra, re-derives it from the executor byte
    # twin) — parity is asserted in tests/test_schedule_parity.py and
    # tests/test_model_pipeline.py
    hop_meta = {"transfer": "pp_boundary"}
    if hop_meta_extra:
        hop_meta.update(hop_meta_extra)
    a2a_layers = (moe_a2a or {}).get("layers_per_vstage")

    prev_on_device: dict[int, str] = {}
    for step in schedule.steps():
        k, m, s = step.vstage, step.microbatch, step.stage
        deps = []
        if step.phase == FWD:
            if k > 0:
                deps.append(f"sendF{k - 1}.{m}")
        else:
            deps.append(f"F{k}.{m}")
            if k < V - 1:
                deps.append(f"sendB{k + 1}.{m}")
        if s in prev_on_device:
            deps.append(prev_on_device[s])
        kind = "fwd" if step.phase == FWD else "bwd"
        b.add(
            step.name, kind, deps,
            flops=fwd_flops if step.phase == FWD else bwd_flops,
            in_bytes=fwd_bytes if step.phase == FWD else bwd_bytes,
            device=f"stage{s}", **layer_meta,
        )
        prev_on_device[s] = step.name
        if step.phase == FWD and a2a_layers and a2a_layers[k]:
            # expert-parallel dispatch a2a of every MoE block in this
            # chunk, priced via the moe_a2a annotation's dist-layer twin
            for i in range(a2a_layers[k]):
                b.add(
                    f"a2a{k}.{m}.{i}", "all-to-all", [step.name],
                    comm_bytes=moe_a2a["comm_bytes"],
                    group_size=moe_a2a["group_size"],
                    link_kind="ici", device=f"link:ep{s}",
                    meta=dict(moe_a2a["meta"]),
                )
        if step.phase == FWD and k < V - 1:
            b.add(
                f"sendF{k}.{m}", "collective-permute", [step.name],
                comm_bytes=cost.boundary_bytes, group_size=2,
                link_kind="ici", device="link:pp",
                meta=dict(hop_meta),
            )
        elif step.phase != FWD and k > 0:
            b.add(
                f"sendB{k}.{m}", "collective-permute", [step.name],
                comm_bytes=cost.boundary_bytes, group_size=2,
                link_kind="ici", device="link:pp",
                meta=dict(hop_meta),
            )
    if strategy.dp > 1 and (
        cost.grad_bytes > 0 or grad_bytes_per_stage is not None
    ):
        # comm_bytes stays the RAW f32 payload; the compression annotation is
        # resolved to the dist layer's actual wire bytes at estimation time
        # (repro_torch.core.estimator.dist_comm_bytes), keeping the graph
        # strategy-agnostic and the byte source single (repro_torch.dist.compress).
        meta = {}
        if strategy.compression != "none":
            meta = {
                "compression": strategy.compression,
                "grad_elems": int(cost.grad_bytes // 4),
                "n_tensors": int(cost.grad_tensors),
            }
        for s in range(S):
            s_bytes = cost.grad_bytes
            s_meta = dict(meta)
            if grad_bytes_per_stage is not None:
                s_bytes = grad_bytes_per_stage[s]
            if grad_meta_per_stage is not None:
                s_meta = dict(grad_meta_per_stage[s])
            ks = list(range(s, V, S))
            specs = _grad_bucket_specs(
                s_bytes, s_meta, ks, strategy.overlap_buckets
            )
            if specs is None:
                b.add(
                    f"gradAR{s}", "all-reduce",
                    [f"B{k}.{m}" for k in ks for m in range(M)],
                    comm_bytes=s_bytes, group_size=strategy.dp,
                    link_kind="ici", device=f"link:dp{s}",
                    meta=s_meta,
                )
            else:
                # bucketed overlap: gradAR{s}.{bkt} depends only on the B
                # steps of its own virtual-stage group, so the first
                # (deepest-chunk) buckets launch while earlier chunks are
                # still in backward; all buckets stay on link:dp{s}
                # (same-link FIFO), the win is the earlier launch
                for bkt, (group, g_bytes, g_meta) in enumerate(specs):
                    b.add(
                        f"gradAR{s}.{bkt}", "all-reduce",
                        [f"B{k}.{m}" for k in group for m in range(M)],
                        comm_bytes=g_bytes, group_size=strategy.dp,
                        link_kind="ici", device=f"link:dp{s}",
                        meta=g_meta,
                    )
    return b.build()


def _grad_bucket_specs(
    s_bytes: float, s_meta: dict, ks: list[int], n_buckets: int
) -> Optional[list[tuple[list[int], float, dict]]]:
    """Split one stage's gradient all-reduce into reverse-topological buckets.

    Returns ``[(vstage_group, raw_bytes, meta), ...]`` in launch order —
    the group of the *deepest* virtual stages first, since backward
    finishes their gradients first — or None when bucketing is off or the
    stage has a single virtual stage (splitting one chunk's all-reduce
    only adds per-collective latency, no earlier launch).

    Accounting is exact by construction: raw f32 bytes partition to
    ``s_bytes`` (remainder pinned to the first bucket) and the per-leaf
    compression annotation partitions leaf-for-leaf (leaves are
    layer-major, so a vstage group owns a contiguous proportional slice),
    keeping ``sum(priced buckets) == priced whole`` for every scheme —
    the graph twin of ``repro_torch.dist.compress.bucket_allreduce_bytes``.
    """
    if n_buckets < 2 or len(ks) < 2:
        return None
    nb = min(n_buckets, len(ks))
    ks_desc = sorted(ks, reverse=True)
    groups = [
        ks_desc[i * len(ks_desc) // nb:(i + 1) * len(ks_desc) // nb]
        for i in range(nb)
    ]

    leaves = None
    if s_meta.get("grad_leaf_elems"):
        leaves = [int(n) for n in s_meta["grad_leaf_elems"]]
    elif s_meta.get("n_tensors"):
        n, t = int(s_meta["grad_elems"]), int(s_meta["n_tensors"])
        leaves = [n // t + (1 if i < n % t else 0) for i in range(t)]

    out: list[tuple[list[int], float, dict]] = []
    if leaves is None:
        # no compression annotation: split raw bytes by chunk count
        raw = [s_bytes * len(g) / len(ks) for g in groups]
        raw[0] += s_bytes - sum(raw)
        return [(g, r, {}) for g, r in zip(groups, raw)]

    # leaves are layer-major (ascending vstage); group gi, holding the
    # descending-order chunks [lo_idx, hi_idx) of ks_desc, owns the
    # mirrored tail slice of the leaf list
    L = len(leaves)
    raw: list[float] = []
    slices: list[list[int]] = []
    for gi, group in enumerate(groups):
        lo_idx = sum(len(groups[j]) for j in range(gi))
        hi_idx = lo_idx + len(group)
        a = round(L * (len(ks) - hi_idx) / len(ks))
        z = round(L * (len(ks) - lo_idx) / len(ks))
        sl = leaves[a:z]
        if not sl:
            # fewer leaves than chunks (degenerate rounding): bucketing
            # would emit an empty all-reduce — keep the single node
            return None
        slices.append(sl)
        raw.append(4.0 * sum(sl))
    raw[0] += s_bytes - sum(raw)
    for group, r, sl in zip(groups, raw, slices):
        g_meta = dict(s_meta)
        g_meta["grad_elems"] = int(sum(sl))
        g_meta["n_tensors"] = len(sl)
        if s_meta.get("grad_leaf_elems"):
            g_meta["grad_leaf_elems"] = sl
        out.append((group, r, g_meta))
    return out


def model_pipeline_graph(
    cfg,
    strategy: Strategy,
    micro_batch: int,
    seq: int,
    params=None,
    cost: Optional[LayerCost] = None,
) -> DataflowGraph:
    """The pipeline DAG of a REAL model partition — the sim side of
    ``repro_torch.models.pipeline``.

    Same step table, same builder as :func:`pipeline_graph`, but every
    comm annotation is derived from the partition the executor actually
    runs:

      * boundary sends carry ``pp_hop`` meta (the (B, S, D) microbatch
        activation in the config's compute dtype) so the estimator prices
        them through ``repro_torch.dist.pp.boundary_bytes`` — the executor's
        ppermute payload twin;
      * ``dp > 1`` gradient all-reduces get the exact per-leaf element
        counts of each stage's parameter tree
        (``repro_torch.models.pipeline.stage_param_trees``), matching
        ``repro_torch.dist.compress.compressed_psum_bytes`` leaf for leaf;
      * ``ep_a2a`` MoE configs attach one dispatch all-to-all per
        (MoE layer, fwd step) annotated for
        ``repro_torch.dist.ep_a2a.a2a_payload_bytes``.

    ``params`` may be the model's param pytree (or ShapeDtypeStructs); when
    None the abstract params are derived from the config.  ``cost`` is the
    per-layer cost (e.g. ``model_layer_cost`` over a DB holding the layer
    measured on the card); None: ``model_layer_cost``'s analytic one.
    """
    from repro_torch.models.build import build_model
    from repro_torch.models.pipeline import (
        make_plan,
        model_layer_cost,
        moe_layers_per_vstage,
        stage_param_trees,
    )

    plan = make_plan(
        cfg, strategy.pp, strategy.microbatches,
        schedule=strategy.schedule, vstages=strategy.vstages,
    )
    if cost is None:
        cost = model_layer_cost(cfg, micro_batch, seq, tp=strategy.tp)
    hop_meta_extra = {
        "pp_hop": {
            "shape": list(plan.act_shape(micro_batch, seq)),
            "dtype": str(cfg.compute_dtype),
        }
    }

    grad_bytes_per_stage = grad_meta_per_stage = None
    if strategy.dp > 1:
        from repro_torch.dist.compress import leaf_elems

        if params is None:
            params, _axes = build_model(cfg).abstract_params()
        grad_bytes_per_stage, grad_meta_per_stage = [], []
        for tree in stage_param_trees(plan, params):
            elems = leaf_elems(tree)
            grad_bytes_per_stage.append(4.0 * sum(elems))
            grad_meta_per_stage.append(
                grad_allreduce_node_meta(elems, strategy.compression)
            )

    moe_a2a = None
    # price the expert-dispatch a2a only when the strategy has an
    # expert-parallel width to dispatch over (explicit ep, or the dp axis
    # the executable repro_torch.dist.ep_a2a layout shards experts over) — a
    # dp=1/ep=1 plan has no a2a to execute, so none is priced.  Note the
    # scheduled pipeline executor itself runs the capacity-parity einsum
    # MoE math (no mesh ctx inside shard_map); the a2a's executable
    # counterpart is the GSPMD-path repro_torch.dist.ep_a2a.moe_ffn_ep_a2a.
    if cfg.moe is not None and cfg.moe.impl == "ep_a2a" and (
        strategy.ep > 1 or strategy.dp > 1
    ):
        act_itemsize = 4 if str(cfg.compute_dtype) == "float32" else 2
        tokens_local = micro_batch * seq
        moe_a2a = {
            "meta": moe_a2a_node_meta(
                cfg.moe, tokens_local, cfg.d_model, itemsize=act_itemsize
            ),
            "comm_bytes": float(
                tokens_local * cfg.d_model * act_itemsize
            ),
            # device group of the a2a: the explicit-EP layout shards
            # experts over the data axis (repro_torch.dist.ep_a2a), so an
            # unspecified ep width falls back to the dp width
            "group_size": (
                strategy.ep if strategy.ep > 1 else strategy.dp
            ),
            "layers_per_vstage": moe_layers_per_vstage(plan),
        }

    return pipeline_graph(
        cfg.num_layers, cost, strategy,
        hop_meta_extra=hop_meta_extra,
        grad_bytes_per_stage=grad_bytes_per_stage,
        grad_meta_per_stage=grad_meta_per_stage,
        moe_a2a=moe_a2a,
    )


def grad_allreduce_node_meta(grads, scheme: str) -> dict:
    """Exact annotation for a compressed dp gradient all-reduce node.

    ``grads`` is either the gradient pytree itself (e.g. the abstract
    params of a real model) or a flat list of per-leaf element counts.
    The annotation carries the full per-leaf breakdown, so
    ``estimator.dist_comm_bytes`` prices precisely what the executor's
    byte twin (``repro_torch.dist.compress.compressed_psum_bytes``) reports for
    the same tree — per-tensor scale metadata and per-leaf topk rounding
    included.  Parity is asserted in tests/test_train_compressed.py.
    """
    if isinstance(grads, (list, tuple)) and all(
        isinstance(n, int) for n in grads
    ):
        elems = [int(n) for n in grads]
    else:
        from repro_torch.dist.compress import leaf_elems

        elems = leaf_elems(grads)
    return {
        "compression": scheme,
        "grad_elems": int(sum(elems)),
        "n_tensors": len(elems),
        "grad_leaf_elems": elems,
    }


def moe_a2a_node_meta(
    moe, n_tokens_local: int, d_model: int, itemsize: int = 4
) -> dict:
    """Annotation for an expert-parallel all-to-all node.

    Attach to an ``"all-to-all"`` graph node so the estimator's comm-volume
    hook prices it with the dispatched-capacity payload the executable
    ``repro_torch.dist.ep_a2a.moe_ffn_ep_a2a`` actually moves, instead of a dense
    activation payload.  ``itemsize`` must match the activation compute
    dtype the executable ships (2 for bf16, 4 for f32).
    """
    return {
        "moe_a2a": {
            "num_experts": moe.num_experts,
            "top_k": moe.top_k,
            "capacity_factor": moe.capacity_factor,
            "group_size": moe.group_size,
            "tokens_local": int(n_tokens_local),
            "d_model": int(d_model),
            "itemsize": int(itemsize),
        }
    }
