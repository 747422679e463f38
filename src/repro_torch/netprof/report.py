"""Measured-vs-ring simulation reports for calibrated hosts.

The acceptance loop of the netprof subsystem: take a real workload graph
(pipeline + int8 data-parallel + MoE a2a — the graphs whose *byte* twins
are already exact), price it once with the measured chain and once with the
analytic ring model, and report both makespans plus the per-node pricing
provenance.  ``ring_fallbacks`` must be 0 on a host calibrated for the
collectives the graph uses.

A copy of the JAX package's ``netprof/report.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.database import ProfileDB
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.hardware import PlatformSpec
from repro_torch.core.simulator import simulate
from repro_torch.netprof.pricing import PROV_DB, PROV_FIT, PROV_RING, graph_provenance


@dataclass
class MeasuredVsRing:
    measured_makespan_s: float
    ring_makespan_s: float
    provenance: dict[str, dict[str, int]]   # per-kind pricing counts
    ring_fallbacks: int                     # ring-priced nodes of profiled kinds
    collective_nodes: int
    profiled_kinds: list[str]

    def lines(self) -> list[str]:
        out = [
            f"measured-chain step {self.measured_makespan_s * 1e3:.3f}ms vs "
            f"ring-model step {self.ring_makespan_s * 1e3:.3f}ms "
            f"({self.collective_nodes} collective nodes)"
        ]
        for kind in sorted(self.provenance):
            s = self.provenance[kind]
            out.append(
                f"  {kind}: {s.get(PROV_DB, 0)} db / {s.get(PROV_FIT, 0)} "
                f"fit / {s.get(PROV_RING, 0)} ring"
            )
        out.append(
            f"  ring-fallback nodes for profiled collectives: "
            f"{self.ring_fallbacks}"
        )
        return out


def measured_vs_ring(
    graph, db: ProfileDB, platform: PlatformSpec
) -> MeasuredVsRing:
    """Simulate ``graph`` under the measured chain and the ring model."""
    from repro_torch.core.estimator import OpTimeEstimator

    # ring first, measured second: the graph's final provenance stamps (what
    # a timeline export would show) are the measured chain's
    est_r = OpTimeEstimator(platform, None)
    res_r = simulate(graph, est_r.duration)
    est_m = OpTimeEstimator(platform, db)
    res_m = simulate(graph, est_m.duration)
    prov = graph_provenance(graph)
    pricer = est_m.collective_pricer
    return MeasuredVsRing(
        measured_makespan_s=res_m.makespan,
        ring_makespan_s=res_r.makespan,
        provenance=prov,
        ring_fallbacks=(
            pricer.ring_fallbacks_for_profiled() if pricer else 0
        ),
        collective_nodes=sum(1 for n in graph.nodes if n.is_collective),
        profiled_kinds=pricer.profiled_kinds() if pricer else [],
    )


def acceptance_graph(microbatch: int = 2, seq: int = 64) -> DataflowGraph:
    """The canonical pp + int8-dp + MoE-a2a graph used by reports/tests.

    A smoke MoE config through ``model_pipeline_graph`` with dp=2, pp=2,
    int8 gradient compression and explicit expert-parallel a2a — one graph
    exercising every collective family the dist layer ships: gradient
    all-reduces, pipeline boundary collective-permutes, and MoE dispatch
    all-to-alls.
    """
    import dataclasses as _dc

    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core.strategy import Strategy, model_pipeline_graph

    cfg = smoke_variant(get_config("qwen3-moe-235b-a22b"))
    cfg = _dc.replace(cfg, moe=_dc.replace(cfg.moe, impl="ep_a2a"))
    strategy = Strategy(
        dp=2, pp=2, microbatches=4, schedule="1f1b", compression="int8"
    )
    return model_pipeline_graph(cfg, strategy, microbatch, seq)
