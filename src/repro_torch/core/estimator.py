"""Op-time estimator (paper §2): profiling-DB lookup -> learned model ->
analytic roofline fallback.

The paper: "for each input argument we profile a fixed number of values, and
use these results to train a neural network to estimate the op performance."
Here, as in the JAX package, the learned model is a small MLP (2x32, full-batch
Adam) regressing ``log(time)`` on ``[log1p(flops), log1p(bytes)]`` per op
family, trained on all profiled points of the platform; it is trained with
torch on the CPU, from initial weights drawn with numpy.

Fallback chain per compute node:
  0. a pipeline chunk of n layers whose layer was measured on the card:
     n times the DB's ``layer_fwd``/``layer_bwd`` entry
  1. exact DB hit for (op_family, args)            — paper's database query
  2. learned regression on (flops, bytes)          — paper's NN estimator
  3. analytic roofline max(flops/peak, bytes/bw)   — spec-sheet platforms

Collective nodes run their own measured chain (repro_torch.netprof.pricing):
exact DB hit -> fitted CollectiveModel -> ring model on the link class,
with the winning stage stamped into ``node.meta["time_provenance"]``.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.database import ProfileDB
from repro_torch.core.graph import OpNode
from repro_torch.core.hardware import (
    COLLECTIVE_KINDS,
    PlatformSpec,
    collective_time,
)


# ---------------------------------------------------------------------------
# Learned regressor (tiny MLP, trained with torch on the CPU)
# ---------------------------------------------------------------------------


@dataclass
class MLPModel:
    w1: np.ndarray
    b1: np.ndarray
    w2: np.ndarray
    b2: np.ndarray
    x_mean: np.ndarray
    x_std: np.ndarray

    def predict_log_time(self, feats: np.ndarray) -> np.ndarray:
        x = (feats - self.x_mean) / self.x_std
        h = np.tanh(x @ self.w1 + self.b1)
        return (h @ self.w2 + self.b2)[..., 0]

    def predict(self, flops: float, nbytes: float) -> float:
        f = np.asarray([[math.log1p(flops), math.log1p(nbytes)]])
        return float(np.exp(self.predict_log_time(f)[0]))


def initial_weights(hidden: int = 32, seed: int = 0) -> dict:
    """The MLP's starting point: normal(0, 0.5) weights from numpy, zero
    biases (the JAX package draws the same law from its PRNG key)."""
    rng = np.random.default_rng(seed)
    return {
        "w1": rng.standard_normal((2, hidden)) * 0.5,
        "b1": np.zeros((hidden,)),
        "w2": rng.standard_normal((hidden, 1)) * 0.5,
        "b2": np.zeros((1,)),
    }


def fit_time_model(
    points: list[tuple[float, float, float]],
    hidden: int = 32,
    steps: int = 800,
    seed: int = 0,
    init: Optional[dict] = None,
) -> Optional[MLPModel]:
    """points: (flops, bytes, mean_s).  Trains the log-time MLP with
    full-batch Adam (lr 3e-2, betas 0.9/0.999, eps 1e-8, ``steps`` steps),
    in fp32, as the JAX package does.  ``init``: starting weights (keys
    w1, b1, w2, b2), by default :func:`initial_weights` of ``seed``."""
    if len(points) < 8:
        return None
    import torch

    arr = np.asarray(points, dtype=np.float64)
    X = np.stack([np.log1p(arr[:, 0]), np.log1p(arr[:, 1])], axis=1)
    y = np.log(np.maximum(arr[:, 2], 1e-9))
    xm, xs = X.mean(0), X.std(0) + 1e-6
    Xn = (X - xm) / xs

    init = init if init is not None else initial_weights(hidden, seed)
    f32 = dict(dtype=torch.float32, device="cpu")
    params = {k: torch.tensor(np.asarray(init[k]), **f32)
              for k in ("w1", "b1", "w2", "b2")}
    Xt, yt = torch.tensor(Xn, **f32), torch.tensor(y, **f32)

    def loss(p):
        h = torch.tanh(Xt @ p["w1"] + p["b1"])
        pred = (h @ p["w2"] + p["b2"])[:, 0]
        return torch.mean((pred - yt) ** 2)

    lr = 3e-2
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    keys = list(params)
    for i in range(steps):
        leaves = [params[k].requires_grad_() for k in keys]
        grads = torch.autograd.grad(loss(params), leaves)
        t = torch.tensor(i + 1, dtype=torch.int32)
        with torch.no_grad():
            for k, g in zip(keys, grads):
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                params[k] = params[k].detach() - lr * (
                    m[k] / (1 - 0.9**t)
                ) / (torch.sqrt(v[k] / (1 - 0.999**t)) + 1e-8)
    out = {k: params[k].detach().numpy() for k in keys}
    return MLPModel(
        w1=out["w1"],
        b1=out["b1"],
        w2=out["w2"],
        b2=out["b2"],
        x_mean=xm,
        x_std=xs,
    )


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------

# graph-node kind -> profiling-DB op family
_FAMILY = {
    "dot": "dot",
    "convolution": "dot",
    "reduce": "reduce",
    "gather": "gather",
    "dynamic-update-slice": "dynamic-update-slice",
}

# which DB op families feed which learned model — per-family regressors, the
# paper trains one estimator per op
_MODEL_SOURCES = {
    "dot": ("dot",),
    "reduce": ("reduce", "softmax"),
    "__vector__": ("add", "mul", "relu", "exp", "tanh", "rsqrt", "copy"),
    "gather": ("gather",),
    "dynamic-update-slice": ("dynamic-update-slice",),
}

def dist_comm_bytes(node: OpNode) -> float:
    """Default comm-volume hook: the per-device payload bytes a collective
    node moves, resolved through the distributed executors' byte twins.

    Graph producers annotate rather than pre-bake: ``comm_bytes`` stays the
    raw dense payload and ``node.meta`` carries the strategy, as in the JAX
    package — ``{"compression": scheme, "grad_elems": n, "n_tensors": t}``
    (plus the exact ``"grad_leaf_elems"`` when the gradient tree is known,
    see ``core.strategy.grad_allreduce_node_meta``) on a compressed
    gradient all-reduce, priced through ``dist.compress``; ``{"pp_hop":
    {"shape", "dtype"}}`` on a model-derived pipeline boundary send, priced
    through ``dist.pp.boundary_bytes``; ``{"moe_a2a": {...}}`` on an
    expert-parallel all-to-all (``core.strategy.moe_a2a_node_meta``), priced
    through ``dist.ep_a2a.a2a_payload_bytes``.  Unannotated nodes pass
    through.
    """
    scheme = node.meta.get("compression")
    if scheme and scheme != "none":
        from repro_torch.dist.compress import (
            compressed_allreduce_bytes,
            tree_allreduce_bytes,
        )

        # exact per-leaf accounting when the producer knows the gradient
        # tree (int8 ships one f32 scale per tensor; topk rounds the kept
        # count per leaf) — matches ``compressed_psum_bytes`` leaf for leaf
        leaf_elems = node.meta.get("grad_leaf_elems")
        if leaf_elems:
            return tree_allreduce_bytes(leaf_elems, scheme=scheme)
        elems = int(node.meta.get("grad_elems") or node.comm_bytes // 4)
        n_tensors = int(node.meta.get("n_tensors", 1))
        return compressed_allreduce_bytes(
            elems, n_tensors=n_tensors, scheme=scheme
        )
    a2a = node.meta.get("moe_a2a")
    if a2a:
        from repro_torch.dist.ep_a2a import a2a_payload_bytes

        return a2a_payload_bytes(**a2a)
    hop = node.meta.get("pp_hop")
    if hop:
        from repro_torch.dist.pp import boundary_bytes

        return boundary_bytes(hop["shape"], hop["dtype"])
    return node.comm_bytes


def _model_key_for(kind: str) -> str:
    if kind in ("dot", "convolution"):
        return "dot"
    if kind == "reduce":
        return "reduce"
    if kind == "gather":
        return "gather"
    if kind == "dynamic-update-slice":
        return "dynamic-update-slice"
    return "__vector__"  # fusions, converts, elementwise, everything else


class OpTimeEstimator:
    def __init__(
        self,
        platform: PlatformSpec,
        db: Optional[ProfileDB] = None,
        use_learned: bool = True,
        new_op_profiler=None,
        comm_bytes_fn=dist_comm_bytes,
    ):
        self.platform = platform
        self.db = db
        self.new_op_profiler = new_op_profiler
        # comm-volume hook: OpNode -> effective per-device payload bytes
        self.comm_bytes_fn = comm_bytes_fn
        self.models: dict[str, MLPModel] = {}
        # measured-collective pricing chain (repro_torch.netprof): exact DB hit ->
        # fitted CollectiveModel -> ring fallback, with per-node provenance
        self.collective_pricer = None
        # measured-serve pricing chain (repro_torch.serve.cost), built lazily on
        # the first serve-annotated node so non-serving estimators never
        # import the serve package
        self._serve_pricer = None
        # link-contention model fitted from the concurrent-collective sweep
        # (None without measurements: the DES keeps fully-parallel links)
        self.contention_model = None
        self.dispatch_s = 0.0
        self.op_overhead_s = 0.0
        if db is not None:
            from repro_torch.netprof.model import fit_link_contention
            from repro_torch.netprof.pricing import CollectivePricer

            self.collective_pricer = CollectivePricer(db, platform)
            self.contention_model = fit_link_contention(db, platform.name)
            self.dispatch_s = float(
                db.meta(platform.name).get("dispatch_s", 0.0)
            )
            self.op_overhead_s = float(
                db.meta(platform.name).get("op_overhead_s", 0.0)
            )
            if use_learned:
                for key, fams in _MODEL_SOURCES.items():
                    # collective families never feed the compute MLP: their
                    # cost is group-structured (entries differing only in
                    # `devices` collide on the (flops, bytes) features), so
                    # both the family list and any entry carrying a
                    # `devices` arg are gated out — collectives are priced
                    # by the CollectiveModel chain below instead
                    pts = [
                        (
                            e.flops,
                            e.bytes,
                            max(e.mean_s - self.dispatch_s, 1e-8),
                        )
                        for fam in fams
                        if fam not in COLLECTIVE_KINDS
                        for e in db.entries(platform.name, fam)
                        if e.mean_s > 0
                        and (e.flops > 0 or e.bytes > 0)
                        and "devices" not in e.args
                    ]
                    # stable digest, NOT hash(): Python string hashing is
                    # salted per process
                    m = fit_time_model(
                        pts, seed=zlib.crc32(key.encode("utf-8")) % 2**31
                    )
                    if m is not None:
                        self.models[key] = m
        self.stats = {"db": 0, "learned": 0, "analytic": 0, "newop": 0}
        # the chunks priced from a measured layer (counted apart from the
        # reference's stats: a scaled measurement, not an exact DB hit)
        self.layer_chunks = 0

    # -- per-node ----------------------------------------------------------------

    def duration(self, node: OpNode) -> float:
        if node.is_collective:
            return self._collective(node)
        sv = node.meta.get("serve")
        if sv is not None:
            return self._serve(node, sv)
        if node.flops == 0 and node.bytes_accessed == 0:
            return 0.0
        # 1. exact DB hit — either op-family args or a (flops, bytes)
        # signature previously measured by the new-op profiler
        if self.db is not None:
            # a pipeline chunk of a layer measured on the card
            # (models.pipeline.profile_layer): n times the layer's time
            lp = node.meta.get("layer_profile")
            if lp is not None:
                e = self.db.lookup(self.platform.name, f"layer_{node.kind}",
                                   lp)
                if e is not None:
                    self.layer_chunks += 1
                    return node.meta["layers"] * e.mean_s
            fam = _FAMILY.get(node.kind)
            args = node.meta.get("db_args")
            if fam is not None and args:
                e = self.db.lookup(self.platform.name, fam, args)
                if e is not None:
                    self.stats["db"] += 1
                    return e.mean_s
            sig = {
                "flops": int(node.flops),
                "bytes": int(node.bytes_accessed),
            }
            e = self.db.lookup(self.platform.name, node.kind, sig)
            if e is not None:
                self.stats["db"] += 1
                return e.mean_s
        # 2. learned per-family model, clamped to an analytic trust region
        # (an MLP extrapolating outside its training manifold — e.g. a
        # zero-flop copy when all training points had flops>0 — must not be
        # able to predict absurd times)
        model = self.models.get(_model_key_for(node.kind))
        if model is not None and not node.meta.get("folded"):
            self.stats["learned"] += 1
            t = max(model.predict(node.flops, node.bytes_accessed), 0.0)
            anchor = self._analytic(node, include_dispatch=False)
            t = float(min(max(t, 0.25 * anchor), 50.0 * anchor + 1e-4))
            return t + self.op_overhead_s
        # 3. new-op online fallback (inserts into the DB)
        if self.new_op_profiler is not None:
            t = self.new_op_profiler.try_profile(node)
            if t is not None:
                self.stats["newop"] += 1
                return t
        # 4. analytic roofline
        self.stats["analytic"] += 1
        return self._analytic(node)

    def _analytic(self, node: OpNode, include_dispatch: bool = True) -> float:
        chip = self.platform.chip
        eff = (
            chip.gemm_efficiency
            if node.kind in ("dot", "convolution")
            else chip.vector_efficiency
        )
        t_flops = node.flops / (chip.peak_flops * eff) if node.flops else 0.0
        t_bytes = node.bytes_accessed / chip.hbm_bw
        base = max(t_flops, t_bytes)
        if not include_dispatch:
            return base
        if node.meta.get("folded"):
            # folded while: the dispatch overhead applies per iteration
            base += self.dispatch_s * node.meta.get("trips", 1)
            # folded comm time appended sequentially
            if node.comm_bytes:
                base += collective_time(
                    "all-reduce", node.comm_bytes, node.group_size,
                    self.platform.link_for(node.link_kind or "ici"),
                )
            return base
        return base + self.dispatch_s

    def _serve(self, node: OpNode, sv: dict) -> float:
        """Serve-step pricing chain: exact DB hit -> interpolated ServePricer
        curve -> analytic roofline on the node's flops/bytes.  The winning
        stage lands in ``node.meta["time_provenance"]`` (the serve audit's
        A004 gate requires every priced serve node to carry one)."""
        from repro_torch.pricing import PROV_ANALYTIC, PROV_DB, PriceQuery

        if self.db is not None:
            from repro_torch.serve.cost import ServePricer

            if self._serve_pricer is None:
                self._serve_pricer = ServePricer(self.db, self.platform.name)
            res = self._serve_pricer.price_query(
                PriceQuery.make(
                    sv["family"],
                    **{k: v for k, v in sv.items() if k != "family"},
                )
            )
            if res is not None:
                t, prov = res
                node.meta["time_provenance"] = prov
                self.stats["db" if prov == PROV_DB else "learned"] += 1
                return t
        node.meta["time_provenance"] = PROV_ANALYTIC
        self.stats["analytic"] += 1
        return self._analytic(node)

    def _collective(self, node: OpNode) -> float:
        """Measured pricing chain: exact DB hit -> fitted CollectiveModel ->
        ring fallback (repro_torch.netprof.pricing).  The winning stage is stamped
        into ``node.meta["time_provenance"]`` so timelines and launch
        reports can show measured-vs-ring per node."""
        from repro_torch.pricing import PROV_DB, PROV_FIT, PROV_NOOP, PROV_RING, PriceQuery

        link = self.platform.link_for(node.link_kind)
        nbytes = (
            self.comm_bytes_fn(node)
            if self.comm_bytes_fn is not None
            else node.comm_bytes
        )
        if self.collective_pricer is not None:
            t, prov = self.collective_pricer.price_query(
                PriceQuery.make(
                    node.kind,
                    nbytes=nbytes,
                    group=node.group_size,
                    link_kind=node.link_kind or "ici",
                )
            )
            node.meta["time_provenance"] = prov
            if prov == PROV_DB:
                self.stats["db"] += 1
            elif prov == PROV_FIT:
                self.stats["learned"] += 1
            return t
        node.meta["time_provenance"] = (
            PROV_RING if node.group_size > 1 else PROV_NOOP
        )
        return collective_time(node.kind, nbytes, node.group_size, link)
