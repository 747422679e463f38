"""Graph extraction for the train step: the port's counterpart of the JAX
package's ``core/hlo_parser.py::module_summary``.

The JAX package lowers the jitted step and parses the compiled HLO.  The
port's step is eager PyTorch, so its graph is the ATen-level trace of one
step made by ``make_fx``: the forward pass, the backward pass (the
checkpointed layers' recomputation included), clipping and the optimizer.
The state and the batch are fake tensors (``FakeTensorMode``), so a
2.8B-parameter step is traced without memory on any device.

Each ATen op becomes one :class:`~repro_torch.core.graph.OpNode` of a kind
the estimator maps (``core/estimator.py``):

* ``mm``/``bmm``/``addmm``/... -> ``dot``, with ``meta["dot"]`` the
  operand shapes, contracting and batch dims and dtype, so the new-op
  profiler can time the real contraction;
* reductions (sums, means, max, softmax, logsumexp, cumsum) -> ``reduce``;
* embedding and index gathers -> ``gather``; scatters -> ``scatter``;
* copies, casts, concatenations and the zero-filled gradients of indexing
  -> ``copy``; fills -> ``broadcast``;
* views (reshape, permute, expand, slices, detach, ...) and the step's
  profiler ranges -> ``view``, which move nothing and cost nothing;
* everything else -> ``elementwise`` (transcendentals count 7 operations
  an element, as in the JAX package's HLO costing);
* each hand-written kernel op (``repro_torch::ssd_scan``,
  ``repro_torch::rmsnorm``, ``repro_torch::flash_attention``,
  ``repro_torch::flash_attention_bwd``, the flash op's gradient for bf16
  CUDA tensors, and ``repro_torch::mamba_step``, the Mamba decode step)
  -> one ``custom-call`` node, the analog of one ``pallas_call``, with
  ``meta["kernel"]`` its name, its operations and bytes from the op's own
  ``cost`` (the bound ``chip_smoke.py`` reports), and ``meta["call"]`` the
  argument specs the new-op profiler replays (a ``None`` mask stays
  ``None``).  The other backward passes (and the flash op's in fp32 or on
  the CPU) are their plain versions' VJPs, traced as ATen ops.

Flops are counted as in the JAX package's parser: 2 per multiply-add of a
contraction, one per output element elsewhere.  Bytes are the tensors an op
reads and writes.
"""
from __future__ import annotations

import math
import operator
from typing import Any

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.graph import DataflowGraph
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba_step import ops as step_ops
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.tree import leaves, tree_map, unflatten_like

# the port's kernel ops and their costs (operations, bytes), each called
# with the op's own positional arguments
KERNEL_COSTS = {"ssd_scan": ssd_ops.cost, "rmsnorm": rms_ops.cost,
                "flash_attention": fa_ops.cost,
                "flash_attention_bwd": fa_ops.backward_cost,
                "mamba_step": step_ops.cost,
                "mla_attention": mla_ops.cost}

_VIEWS = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "unsqueeze", "squeeze", "select", "slice", "split",
    "split_with_sizes", "unbind", "chunk", "as_strided", "alias", "detach",
    "lift_fresh", "lift_fresh_copy", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "diagonal", "narrow", "view_as",
    "expand_as", "unflatten", "flatten", "movedim",
}
_COPIES = {
    "clone", "contiguous", "_to_copy", "copy", "copy_", "cat", "stack",
    "flip", "constant_pad_nd", "select_backward", "slice_backward",
    "slice_scatter", "select_scatter", "as_strided_scatter", "index_put",
    "index_put_", "repeat", "tril", "triu", "_to_dtype",
}
_FILLS = {
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange", "fill",
    "fill_",
}
_GATHERS = {"embedding", "index_select", "gather", "index", "take"}
_SCATTERS = {"scatter_add", "scatter_add_", "index_add", "index_add_",
             "embedding_dense_backward", "scatter", "scatter_"}
_REDUCES = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum", "var", "var_mean", "argmax",
    "argmin", "norm", "linalg_vector_norm", "all", "any",
}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot", "addmv"}
_TRANSCENDENTAL = {
    "exp", "exp_", "log", "log_", "tanh", "sigmoid", "rsqrt", "rsqrt_",
    "sqrt", "sqrt_", "pow", "pow_", "sin", "cos", "expm1", "log1p", "erf",
    "silu", "silu_", "silu_backward", "softplus", "softplus_backward",
    "tanh_backward", "sigmoid_backward", "logit", "reciprocal",
}


def _op_name(target) -> str:
    packet = getattr(target, "_overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _val(arg):
    """The fake value an fx argument stands for (tensors, lists of them,
    literals)."""
    if isinstance(arg, torch.fx.Node):
        return arg.meta.get("val")
    if isinstance(arg, (list, tuple)):
        return type(arg)(_val(a) for a in arg)
    return arg


def _dot_meta(name: str, args: list) -> tuple[float, dict]:
    """(flops, meta["dot"]) of a contraction from its operand values."""
    if name in ("addmm", "baddbmm", "addmv"):
        args = args[1:]
    lhs, rhs = args[0], args[1]
    ls, rs = list(lhs.shape), list(rhs.shape)
    if name in ("mm", "addmm"):
        lc, rc, lb, rb = [1], [0], [], []
        flops = 2.0 * ls[0] * ls[1] * rs[1]
    elif name in ("bmm", "baddbmm"):
        lc, rc, lb, rb = [2], [1], [0], [0]
        flops = 2.0 * ls[0] * ls[1] * ls[2] * rs[2]
    elif name in ("mv", "addmv"):
        lc, rc, lb, rb = [1], [0], [], []
        flops = 2.0 * ls[0] * ls[1]
    else:  # dot
        lc, rc, lb, rb = [0], [0], [], []
        flops = 2.0 * ls[0]
    return flops, {"lhs": ls, "rhs": rs, "lc": lc, "rc": rc, "lb": lb,
                   "rb": rb, "dtype": str(lhs.dtype).split(".")[-1]}


def _arg_spec(v) -> Any:
    if isinstance(v, torch.Tensor):
        return {"shape": list(v.shape), "stride": list(v.stride()),
                "dtype": str(v.dtype).split(".")[-1]}
    if isinstance(v, torch.dtype):
        return {"torch_dtype": str(v).split(".")[-1]}
    return v


# ops a kernel's integer mask may be made of inside a trace (a decode
# step's positions, a rank's query offset), evaluated on the host
_CONST_OPS = {"full", "select", "slice", "view", "_unsafe_view", "reshape",
              "expand", "unsqueeze", "squeeze", "_to_copy", "clone", "alias",
              "detach", "add", "sub", "mul", "arange", "repeat"}


class _NotConstant(Exception):
    pass


def _constant(arg):
    """The host value of an fx argument computed from literals alone
    (:data:`_CONST_OPS` over constants); raises :class:`_NotConstant`
    where it reads an input of the trace."""
    if isinstance(arg, (list, tuple)):
        return type(arg)(_constant(a) for a in arg)
    if not isinstance(arg, torch.fx.Node):
        return arg
    if arg.op != "call_function" or _op_name(arg.target) not in _CONST_OPS:
        raise _NotConstant(arg.name)
    args = _constant(arg.args)
    kwargs = {k: torch.device("cpu") if k == "device" else _constant(v)
              for k, v in arg.kwargs.items() if k != "pin_memory"}
    return arg.target(*args, **kwargs)


def _kernel_args(node: torch.fx.Node) -> list:
    """A kernel node's argument values: the fake tensors, with an integer
    mask the trace made from constants evaluated on the host, so the op's
    cost can read it."""
    out = []
    for a in node.args:
        v = _val(a)
        if (isinstance(a, torch.fx.Node) and isinstance(v, torch.Tensor)
                and not v.is_floating_point()):
            try:
                v = _constant(a)
            except _NotConstant:
                pass
        out.append(v)
    return out


def graph_from_fx(gm: torch.fx.GraphModule,
                  name: str = "train_step") -> DataflowGraph:
    """The :class:`DataflowGraph` of a traced module (see the module doc)."""
    g = DataflowGraph(name)
    uid_of: dict[torch.fx.Node, int] = {}
    for node in gm.graph.nodes:
        if node.op == "output":
            continue
        deps = sorted({uid_of[a] for a in node.all_input_nodes
                       if a in uid_of})
        if node.op != "call_function":
            uid_of[node] = g.add(node.name, "parameter", deps=deps).uid
            continue
        target = node.target
        op = _op_name(target)
        out = _tensors(node.meta.get("val"))
        args = [_val(a) for a in node.args]
        ins = _tensors(args) + _tensors([_val(v) for v in node.kwargs.values()])
        out_b = sum(_nbytes(t) for t in out)
        in_b = sum(_nbytes(t) for t in ins)
        out_elems = float(sum(t.numel() for t in out))
        meta: dict = {"aten": op}
        if (target is operator.getitem or op in _VIEWS
                or getattr(target, "namespace", "") == "profiler"):
            kind, flops, in_b, out_b = "view", 0.0, 0.0, 0.0
        elif getattr(target, "namespace", "") == "repro_torch":
            kind = "custom-call"
            kwargs = {k: _val(v) for k, v in node.kwargs.items()}
            flops, nbytes = KERNEL_COSTS[op](*_kernel_args(node), **kwargs)
            in_b, out_b = nbytes - out_b, out_b
            meta.update(kernel=op, call={
                "op": f"repro_torch::{op}",
                "args": [_arg_spec(a) for a in args],
            })
        elif op in _DOTS:
            kind = "dot"
            flops, meta["dot"] = _dot_meta(op, args)
        elif op in _REDUCES:
            kind, flops = "reduce", float(sum(t.numel() for t in ins[:1]))
        elif op in _GATHERS:
            kind, flops, in_b = "gather", 0.0, out_b
        elif op in _SCATTERS:
            kind, flops = "scatter", 0.0
        elif op in _COPIES:
            kind, flops = "copy", 0.0
        elif op in _FILLS:
            kind, flops, in_b = "broadcast", 0.0, 0.0
        else:
            kind = "elementwise"
            flops = out_elems * (7.0 if op in _TRANSCENDENTAL else 1.0)
        uid_of[node] = g.add(node.name, kind, deps=deps, flops=flops,
                             in_bytes=in_b, out_bytes=out_b, meta=meta).uid
    g.validate()
    return g


def _traceable(device) -> torch.device:
    """``device`` for a fake-tensor trace.  Fake CUDA tensors need a
    PyTorch built with CUDA: a CPU-only build has no CUDA device guard, and
    autograd aborts the process on a CUDA tensor, so such a trace is
    refused here.  A traced train step also needs a visible card (autograd
    asks the runtime for the device's context; nothing is allocated on
    it); without one its trace fails and is recorded as failed.
    ``device="cpu"`` traces the same ops on fake CPU tensors (a kernel op
    is one node there too)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError(
            "this PyTorch build has no CUDA, so the card's program (its "
            "kernel ops on fake CUDA tensors) cannot be traced here; "
            "device='cpu' traces the same ops on fake CPU tensors")
    return dev


def _trace_train(step, state, batch: dict, mode) -> torch.fx.GraphModule:
    """``make_fx`` trace of ``step(state, batch)`` on the fake ``state``
    and ``batch`` of ``mode``; the graph returns the step's metrics."""
    from repro_torch.train.step import TrainState

    with mode:
        flat = ([state.step] + leaves(state.params)
                + leaves(state.opt_state) + leaves(batch))
    n_p, n_o = len(leaves(state.params)), len(leaves(state.opt_state))

    def fn(*ts):
        st = TrainState(ts[0], unflatten_like(state.params, list(ts[1:1 + n_p])),
                        unflatten_like(state.opt_state,
                                       list(ts[1 + n_p:1 + n_p + n_o])))
        _, metrics = step(st, unflatten_like(batch, list(ts[1 + n_p + n_o:])))
        return [metrics[k] for k in sorted(metrics)]

    with mode:
        return make_fx(fn, tracing_mode="real")(*flat)


def trace_train_step(model, optimizer, schedule, *, batch: int, seq: int,
                     device="cuda") -> torch.fx.GraphModule:
    """``make_fx`` trace of one step of ``make_train_step`` on a fake state
    and a fake (batch, seq) token batch on ``device``."""
    from repro_torch.train.step import init_state, make_train_step

    step = make_train_step(model, optimizer, schedule)
    dev = _traceable(device)
    with FakeTensorMode() as mode:
        state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                           optimizer)
        toks = {k: torch.zeros((batch, seq), dtype=torch.int32, device=dev)
                for k in ("tokens", "labels")}
    return _trace_train(step, state, toks, mode)


def summarize_graph(g: DataflowGraph) -> dict:
    """``{"module", "nodes", "flops", "bytes", "dot_flops", "kinds",
    "graph"}`` of a traced graph."""
    kinds: dict[str, int] = {}
    for n in g.nodes:
        kinds[n.kind] = kinds.get(n.kind, 0) + 1
    return {
        "module": g.name,
        "nodes": len(g),
        "flops": g.total_flops(),
        "bytes": g.total_bytes(),
        "dot_flops": dot_flops(g),
        "kinds": kinds,
        "graph": g,
    }


def step_summary(model, optimizer, schedule, *, batch: int, seq: int,
                 device="cuda") -> dict:
    """Trace + graph + aggregates, the counterpart of ``module_summary``:
    ``{"module", "nodes", "flops", "bytes", "dot_flops", "kinds", "graph"}``.
    """
    gm = trace_train_step(model, optimizer, schedule, batch=batch, seq=seq,
                          device=device)
    return summarize_graph(graph_from_fx(gm, f"train_step_{model.cfg.name}"))


def dot_flops(g: DataflowGraph) -> float:
    """Total flops of the graph's contraction nodes."""
    return sum(n.flops for n in g.nodes if n.kind == "dot")


# ---------------------------------------------------------------------------
# The dry run's per-rank program (repro_torch.launch.dryrun)
# ---------------------------------------------------------------------------


def _fake(sd, dev, grad: bool = False) -> torch.Tensor:
    """A fake tensor of a ``models.build.ShapeDtype``'s shape and dtype."""
    t = torch.empty(tuple(sd.shape), dtype=sd.dtype, device=dev)
    return t.requires_grad_() if grad else t


def trace_rank_step(kind: str, model, *, params, batch: dict, cache=None,
                    optimizer=None, schedule=None, grad_accum: int = 1,
                    max_len: int = 0, cache_len: int = 0, ctx=None,
                    device="cuda") -> torch.fx.GraphModule:
    """``make_fx`` trace of one rank's step on fake tensors of the given
    shapes (``ShapeDtype`` trees: the rank's parameters, batch and cache),
    under the sharding context ``ctx`` (whose ``rank`` view the model code
    reads; ``None``: the whole step).

    ``kind="train"``: ``make_train_step`` over ``grad_accum`` microbatches,
    the optimizer state made by ``optimizer.init`` on the parameters (the
    graph returns the metrics; the state is updated in place).
    ``"prefill"``: ``model.prefill`` to ``max_len`` positions.
    ``"decode"``: ``model.decode`` of one token written at ``cache_len``
    (the cache updated in place).  The serving steps run without autograd.
    """
    from repro_torch.models.sharding import use_sharding

    dev = _traceable(device)
    with FakeTensorMode() as mode:
        p = tree_map(lambda sd: _fake(sd, dev, grad=kind == "train"), params)
        b = tree_map(lambda sd: _fake(sd, dev), batch)
        c = None if cache is None else tree_map(lambda sd: _fake(sd, dev),
                                                cache)
    if kind == "train":
        from repro_torch.train.step import TrainState, make_train_step

        step = make_train_step(model, optimizer, schedule,
                               grad_accum=grad_accum)
        with mode:
            state = TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                               p, optimizer.init(p))

        def run(st, bt):
            with use_sharding(ctx):
                return step(st, bt)

        return _trace_train(run, state, b, mode)

    flat = leaves(p) + leaves(b) + leaves(c)
    n_p, n_b = len(leaves(p)), len(leaves(b))

    def fn(*ts):
        pp = unflatten_like(p, list(ts[:n_p]))
        bb = unflatten_like(b, list(ts[n_p:n_p + n_b]))
        with torch.no_grad(), use_sharding(ctx):
            if kind == "prefill":
                extra = {k: bb[k] for k in ("patches", "frames") if k in bb}
                logits, out = model.prefill(pp, bb["tokens"], max_len,
                                            **extra)
            else:
                cc = unflatten_like(c, list(ts[n_p + n_b:]))
                logits, out = model.decode(pp, cc, bb["token"], cache_len)
        return [logits] + leaves(out)

    with mode:
        return make_fx(fn, tracing_mode="real")(*flat)


def _storages(v) -> dict:
    """``{storage key: bytes}`` of the tensors an fx value holds."""
    out = {}
    for t in _tensors(v):
        st = t.untyped_storage()
        out[st._cdata] = int(st.nbytes())
    return out


def temp_bytes(gm: torch.fx.GraphModule) -> int:
    """The peak of live intermediate bytes over the graph, in its order:
    a node's new storages are allocated when it runs and freed after the
    last node that reads them (a view keeps its base alive); the
    arguments' storages (updated in place or not) and the graph's outputs
    are not counted.  The port's own estimate of XLA's
    ``temp_size_in_bytes``: one storage a tensor, no fusion, no reuse of a
    freed buffer's bytes beyond the running sum."""
    nodes = list(gm.graph.nodes)
    keys = {n: _storages(n.meta.get("val")) for n in nodes}
    fixed: set = set()
    for n in nodes:
        if n.op == "placeholder":
            fixed |= set(keys[n])
        elif n.op == "output":
            for a in n.all_input_nodes:
                fixed |= set(keys[a])
    last: dict = {}
    for i, n in enumerate(nodes):
        for k in keys[n]:
            last[k] = max(last.get(k, i), i)
        for a in n.all_input_nodes:
            for k in keys[a]:
                last[k] = i
    free_at: dict = {}
    for k, i in last.items():
        free_at.setdefault(i, []).append(k)
    live = peak = 0
    size: dict = {}
    for i, n in enumerate(nodes):
        for k, nb in keys[n].items():
            if k not in fixed and k not in size:
                size[k] = nb
                live += nb
        peak = max(peak, live)
        for k in free_at.get(i, ()):
            live -= size.pop(k, 0)
    return peak


def rank_collectives(cfg, kind: str, leaf_info: list, *, sizes: dict,
                     dcn_axes: tuple, batch_axes: tuple, tokens: int,
                     head_tokens: int, grad_accum: int = 1, seq_q: int = 1,
                     kv_seq_axes: tuple = (), heads_whole: bool = False,
                     act_itemsize: int = 2) -> dict:
    """One rank's collectives by rule (the port has no SPMD partitioner to
    place them).  ``leaf_info``: one dict a parameter leaf, ``path``,
    ``axes`` (logical), ``arg`` and ``compute`` (its PartitionSpecs as an
    argument and as computed with), ``shape`` (the compute shape),
    ``itemsize``, ``opt_zero`` (its optimizer state, not the parameter,
    sharded over ``data``).  ``tokens``: the rank's tokens of one
    microbatch; ``head_tokens``: those the logits head sees.

    Rules, each priced as a per-rank payload (the parser's convention:
    the input of an all-reduce, reduce-scatter or all-to-all, the output of
    an all-gather):

    * tensor parallelism over ``model``: every row-parallel projection (a
      leaf whose last axis is ``embed``/``expert_embed`` and another of
      whose dims the rank holds a ``model`` share of: attention's ``wo``,
      the MLP's and experts' ``wd``, the mixer's ``wo``) all-reduces its
      output, ``tokens x d_model`` in the compute dtype, once a layer in the
      forward, once in the backward, and once more in the remat recompute;
      a vocab-split embedding all-reduces its lookup (forward only); a
      vocab-split head all-reduces the logsumexp's max and sum (fp32 a
      token) forward and its input's fp32 gradient backward;
    * the ``seq_q`` split: each attention layer all-gathers its output
      forward (and remat) and reduce-scatters its gradient backward;
    * a decode step whose cache splits its sequence (over
      ``kv_seq_axes``): each attention layer all-reduces its partial
      outputs (fp32) and the softmax's max and sum over those axes;
    * ``heads_whole`` (a decode cell, whose rules replicate the head
      activations): the rank computes every head from weights whose
      heads it holds a share of; XLA's program projects its own heads and
      all-gathers the activations, so that is what is priced, one
      all-gather of the projected heads (``tokens x heads x head_dim``)
      for each ``wq``/``wx`` layer, and no gather of those weights;
    * FSDP (a leaf sharded over ``data`` as an argument and whole in the
      compute): an all-gather of the leaf before use, forward and backward
      of every microbatch (once a serving step); ZeRO-1 (only its optimizer
      state sharded): an all-gather of the updated leaf once a step;
    * the gradients' reduction over the batch axes: one all-reduce of the
      fp32 gradients, ``dist.compress.tree_allreduce_bytes`` (raw f32),
      over the batch axes the leaf is not itself split on;
    * ``moe.impl="ep_a2a"``: two all-to-alls a MoE layer a forward
      (dispatch, return), ``dist.ep_a2a.moe_a2a_bytes``, again backward and
      in the recompute.

    A collective whose group holds a DCN axis counts as DCN, else ICI.
    Returns ``{"collectives", "collective_bytes_ici",
    "collective_bytes_dcn"}`` as ``module_summary`` does."""
    from repro_torch.dist.compress import tree_allreduce_bytes
    from repro_torch.dist.ep_a2a import moe_a2a_bytes
    from repro_torch.models.sharding import _axes_of

    coll: dict = {}
    link = {"ici": 0.0, "dcn": 0.0}

    def add(op: str, nbytes: float, count: int, axes) -> None:
        axes = tuple(a for a in axes if a in sizes)
        group = math.prod(sizes[a] for a in axes)
        if count <= 0 or nbytes <= 0 or group <= 1:
            return
        e = coll.setdefault(op, {"count": 0, "bytes": 0.0, "max_group": 1})
        e["count"] += count
        e["bytes"] += nbytes * count
        e["max_group"] = max(e["max_group"], group)
        link["dcn" if set(axes) & set(dcn_axes) else "ici"] += nbytes * count

    train = kind == "train"
    micro = grad_accum if train else 1
    remat = 1 if train and cfg.remat_policy != "none" else 0
    per_layer = (2 + remat) * micro if train else 1
    d = cfg.d_model
    act = float(tokens * d * act_itemsize)

    def layers_of(info) -> int:
        return math.prod(n for a, n in zip(info["axes"], info["shape"])
                         if a == "layers")

    def on_model(info, dims) -> bool:
        return any("model" in _axes_of(info["compute"][i])
                   for i in dims if i < len(info["compute"]))

    def head() -> None:
        # serving keeps its logits split over the vocabulary (the output)
        if train:
            add("all-reduce", 4.0 * head_tokens, 2 * micro, ["model"])
            add("all-reduce", 4.0 * tokens * d, micro, ["model"])

    for info in leaf_info:
        axes, name = info["axes"], info["path"]
        leaf = name.split("/")[-1]
        n = len(axes)
        if name == "embed":
            if on_model(info, [0]):
                add("all-reduce", act, micro, ["model"])
                if cfg.tie_embeddings:
                    head()
        elif name == "head":
            if on_model(info, [n - 1]):
                head()
        elif (n >= 2 and axes[-1] in ("embed", "expert_embed")
              and leaf in ("wo", "wd")
              and on_model(info, range(n - 1))):
            add("all-reduce", act, per_layer * layers_of(info), ["model"])
        if leaf == "wo" and axes[-1] == "embed" and "heads" in axes:
            attn = name.split("/")[-2] in ("attn", "self", "cross")
            if attn and seq_q > 1:
                add("all-gather", act, (1 + remat) * micro * layers_of(info),
                    ["model"])
                if train:
                    add("reduce-scatter", act, micro * layers_of(info),
                        ["model"])
            if attn and kv_seq_axes:
                h, hd = info["shape"][-3], info["shape"][-2]
                add("all-reduce", 4.0 * head_tokens * h * (hd + 2),
                    layers_of(info), kv_seq_axes)
        arg_axes = {a for p in info["arg"] for a in _axes_of(p)}
        cmp_axes = {a for p in info["compute"] for a in _axes_of(p)}
        gathered = sorted(arg_axes - cmp_axes)
        full = float(math.prod(info["shape"]) * info["itemsize"])
        if heads_whole and "model" in gathered:
            gathered.remove("model")
            if leaf in ("wq", "wx"):
                heads = math.prod(info["shape"][-2:])
                add("all-gather", float(tokens * heads * act_itemsize),
                    layers_of(info), ["model"])
        if gathered:
            add("all-gather", full, 2 * micro if train else 1, gathered)
        elif train and info.get("opt_zero"):
            add("all-gather", full, 1, ["data"])
        if train:
            grad = tree_allreduce_bytes([math.prod(info["shape"])],
                                        scheme="none")
            add("all-reduce", grad, 1,
                [a for a in batch_axes if a not in cmp_axes])
    moe = cfg.moe
    if moe is not None and moe.impl == "ep_a2a":
        n_moe = sum(layers_of(i) for i in leaf_info
                    if i["path"].endswith("moe/wg"))
        a2a = moe_a2a_bytes(moe, tokens, d, act_itemsize)
        add("all-to-all", a2a, 2 * per_layer * n_moe, ["data"])
    return {"collectives": coll, "collective_bytes_ici": link["ici"],
            "collective_bytes_dcn": link["dcn"]}
