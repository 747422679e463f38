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
  ``repro_torch::rmsnorm``, ``repro_torch::flash_attention``) -> one
  ``custom-call`` node, the analog of one ``pallas_call``, with
  ``meta["kernel"]`` its name, its operations and bytes from the op's own
  ``cost`` (the bound ``chip_smoke.py`` reports), and ``meta["call"]`` the
  argument specs the new-op profiler replays (a ``None`` mask stays
  ``None``).  The ops' backward passes are their plain versions' VJPs,
  traced as ATen ops.

Flops are counted as in the JAX package's parser: 2 per multiply-add of a
contraction, one per output element elsewhere.  Bytes are the tensors an op
reads and writes.
"""
from __future__ import annotations

import operator
from typing import Any

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.graph import DataflowGraph
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.tree import leaves, unflatten_like

# the port's kernel ops and their costs (operations, bytes), each called
# with the op's own positional arguments
KERNEL_COSTS = {"ssd_scan": ssd_ops.cost, "rmsnorm": rms_ops.cost,
                "flash_attention": fa_ops.cost}

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
            flops, nbytes = KERNEL_COSTS[op](*args, **kwargs)
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


def trace_train_step(model, optimizer, schedule, *, batch: int, seq: int,
                     device="cuda") -> torch.fx.GraphModule:
    """``make_fx`` trace of one step of ``make_train_step`` on a fake state
    and a fake (batch, seq) token batch on ``device``."""
    from repro_torch.train.step import TrainState, init_state, make_train_step

    step = make_train_step(model, optimizer, schedule)
    dev = torch.device(device)
    with FakeTensorMode() as mode:
        state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                           optimizer)
        toks = {k: torch.zeros((batch, seq), dtype=torch.int32, device=dev)
                for k in ("tokens", "labels")}
        flat = ([state.step] + leaves(state.params)
                + leaves(state.opt_state) + leaves(toks))
    n_p, n_o = len(leaves(state.params)), len(leaves(state.opt_state))

    def fn(*ts):
        st = TrainState(ts[0], unflatten_like(state.params, list(ts[1:1 + n_p])),
                        unflatten_like(state.opt_state,
                                       list(ts[1 + n_p:1 + n_p + n_o])))
        _, metrics = step(st, unflatten_like(toks, list(ts[1 + n_p + n_o:])))
        return [metrics[k] for k in sorted(metrics)]

    with mode:
        return make_fx(fn, tracing_mode="real")(*flat)


def step_summary(model, optimizer, schedule, *, batch: int, seq: int,
                 device="cuda") -> dict:
    """Trace + graph + aggregates, the counterpart of ``module_summary``:
    ``{"module", "nodes", "flops", "bytes", "dot_flops", "kinds", "graph"}``.
    """
    gm = trace_train_step(model, optimizer, schedule, batch=batch, seq=seq,
                          device=device)
    g = graph_from_fx(gm, f"train_step_{model.cfg.name}")
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


def dot_flops(g: DataflowGraph) -> float:
    """Total flops of the graph's contraction nodes."""
    return sum(n.flops for n in g.nodes if n.kind == "dot")
