"""Unified dataflow-graph IR (the paper's preprocessing target format).

A :class:`DataflowGraph` is a DAG of :class:`OpNode`.  Nodes carry the
framework-level op kind, tensor shapes, analytic flops/bytes, an optional
``device`` placement (the paper's TF "device" attribute — used directly by
the heterogeneous pipeline-parallel simulation), and for collectives the
group size and link kind.

Graphs come from three producers:
  * ``repro_torch.core.hlo_parser``   — post-SPMD XLA HLO (the main path),
  * hand-construction in tests  — known DAGs with exact expected makespans,
  * ``repro_torch.core.strategy``     — synthetic pipeline/microbatch graphs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional


class GraphInvariantError(ValueError):
    """A DataflowGraph structural invariant does not hold.

    Raised by :meth:`DataflowGraph.validate` naming the offending node —
    unlike a bare ``assert``, it survives ``python -O`` and tells you
    *which* node broke (deep lints with cycle extraction live in
    ``repro_torch.analysis.graph_lints``)."""


@dataclass
class OpNode:
    uid: int
    name: str
    kind: str                      # hlo opcode or synthetic kind
    out_bytes: float = 0.0
    in_bytes: float = 0.0
    flops: float = 0.0
    # collective metadata
    comm_bytes: float = 0.0        # per-device payload
    group_size: int = 1
    link_kind: str = ""            # "ici" | "dcn" | "" (not a collective)
    # placement: None = the SPMD compute stream
    device: Optional[str] = None
    deps: list[int] = field(default_factory=list)
    # free-form (fusion arity, trip counts, source instruction, ...)
    meta: dict = field(default_factory=dict)

    @property
    def bytes_accessed(self) -> float:
        return self.in_bytes + self.out_bytes

    @property
    def is_collective(self) -> bool:
        return bool(self.link_kind)


class DataflowGraph:
    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: list[OpNode] = []

    # -- construction --------------------------------------------------------

    def add(
        self,
        name: str,
        kind: str,
        deps: Iterable[int] = (),
        **kw,
    ) -> OpNode:
        node = OpNode(uid=len(self.nodes), name=name, kind=kind, deps=list(deps), **kw)
        for d in node.deps:
            if not (0 <= d < node.uid):
                raise ValueError(f"dep {d} of node {node.uid} not yet defined")
        self.nodes.append(node)
        return node

    # -- queries --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.nodes)

    def successors(self) -> list[list[int]]:
        succ: list[list[int]] = [[] for _ in self.nodes]
        for n in self.nodes:
            for d in n.deps:
                succ[d].append(n.uid)
        return succ

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    def total_bytes(self) -> float:
        return sum(n.bytes_accessed for n in self.nodes)

    def collective_bytes(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for n in self.nodes:
            if n.is_collective:
                out[n.kind] = out.get(n.kind, 0.0) + n.comm_bytes
        return out

    def validate(self) -> None:
        """Raise :class:`GraphInvariantError` naming the offending node if
        uids are duplicated/misnumbered, a dep is dangling, or the node
        list is not in topological order."""
        n_nodes = len(self.nodes)
        seen: set[int] = set()
        for idx, n in enumerate(self.nodes):
            if n.uid in seen:
                raise GraphInvariantError(
                    f"graph {self.name!r}: node {n.name!r} at position "
                    f"{idx} reuses uid {n.uid}"
                )
            seen.add(n.uid)
            if n.uid != idx:
                raise GraphInvariantError(
                    f"graph {self.name!r}: node {n.name!r} has uid "
                    f"{n.uid} at position {idx}"
                )
            for d in n.deps:
                if not 0 <= d < n_nodes:
                    raise GraphInvariantError(
                        f"graph {self.name!r}: node {n.name!r} (uid "
                        f"{n.uid}) depends on undefined uid {d}"
                    )
                if d >= n.uid:
                    raise GraphInvariantError(
                        f"graph {self.name!r}: node {n.name!r} (uid "
                        f"{n.uid}) depends on uid {d} — nodes must be in "
                        "topological order"
                    )

    def critical_path(self, duration_fn) -> float:
        """Longest path through the DAG under ``duration_fn(node) -> s``.

        Lower bound on any schedule's makespan (used by property tests)."""
        dist = [0.0] * len(self.nodes)
        for n in self.nodes:
            d = duration_fn(n)
            best = max((dist[p] for p in n.deps), default=0.0)
            dist[n.uid] = best + d
        return max(dist, default=0.0)
