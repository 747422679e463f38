"""Op-time estimator (paper §2): profiling-DB lookup -> learned model ->
analytic roofline fallback.

The paper: "for each input argument we profile a fixed number of values, and
use these results to train a neural network to estimate the op performance."
In the JAX package the learned model is a small MLP regressing ``log(time)``
on ``[log1p(flops), log1p(bytes)]`` per platform; its trainer is not ported
yet (ROADMAP A5), so estimators here are built with ``use_learned=False``
and the chain below skips stage 2.

Fallback chain per compute node:
  1. exact DB hit for (op_family, args)            — paper's database query
  2. learned regression on (flops, bytes)          — paper's NN estimator
  3. analytic roofline max(flops/peak, bytes/bw)   — spec-sheet platforms

Collective nodes run their own measured chain (repro_torch.netprof.pricing):
exact DB hit -> fitted CollectiveModel -> ring model on the link class,
with the winning stage stamped into ``node.meta["time_provenance"]``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.database import ProfileDB
from repro_torch.core.graph import OpNode
from repro_torch.core.hardware import PlatformSpec, collective_time


# ---------------------------------------------------------------------------
# Learned regressor (its trainer waits for ROADMAP A5)
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


def fit_time_model(
    points: list[tuple[float, float, float]],
    hidden: int = 32,
    steps: int = 800,
    seed: int = 0,
) -> Optional[MLPModel]:
    """The learned log-time regressor; not ported yet (ROADMAP A5).

    The JAX package trains it with JAX; its torch counterpart comes with the
    offline op profiler, so the port's estimators run ``use_learned=False``.
    """
    raise NotImplementedError(
        "fit_time_model is not ported to torch yet (ROADMAP A5); "
        "build OpTimeEstimator(..., use_learned=False)"
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

def dist_comm_bytes(node: OpNode) -> float:
    """Default comm-volume hook: the node's raw payload bytes.

    Graph producers may annotate a collective with ``compression``,
    ``moe_a2a`` or ``pp_hop`` metadata, which the JAX package resolves
    through the distributed executors' byte twins.  Those executors are not
    ported yet, so such a node raises instead of being priced at its raw
    payload.
    """
    scheme = node.meta.get("compression")
    annotated = [
        key for key, on in (
            ("compression", scheme and scheme != "none"),
            ("moe_a2a", node.meta.get("moe_a2a")),
            ("pp_hop", node.meta.get("pp_hop")),
        ) if on
    ]
    if annotated:
        # the byte twins of these annotations live in the distributed
        # executors, which the port has not taken over yet
        raise NotImplementedError(
            f"collective node {node.name!r} carries {annotated[0]!r}: the "
            "distributed byte twins are not ported yet (ROADMAP, distributed)"
        )
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
                # the learned stage is not ported yet (ROADMAP A5): say so
                # at construction instead of pricing without it
                fit_time_model([])
        self.stats = {"db": 0, "learned": 0, "analytic": 0, "newop": 0}

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
