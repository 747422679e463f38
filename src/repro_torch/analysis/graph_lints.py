"""Static lints over :class:`repro_torch.core.graph.DataflowGraph`.

Three families:

* **structure** — duplicate/misnumbered uids, dangling deps, self-deps,
  topological-order violations, and cycle detection with the offending
  cycle *named* (the thing ``Simulator.run``'s "simulated X/N nodes" error
  historically could not tell you);
* **placement** — device-consistency: collectives must live on link
  streams, compute must not, and a compute->compute dependency that crosses
  devices without an intervening transfer node means unaccounted traffic;
* **accounting completeness** — every collective node must be resolvable
  by ``repro_torch.core.estimator.dist_comm_bytes`` (malformed ``pp_hop`` /
  ``moe_a2a`` / compression annotations surface here, before a simulation
  prices garbage), and, when an estimator with a netprof-calibrated DB is
  supplied, must price through the measured chain without a silent ring
  fallback (provenance audit).

A copy of the JAX package's ``analysis/graph_lints.py`` with its imports
rewritten (``tests/test_torch_analysis.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.analysis.diagnostics import Report
from repro_torch.core.graph import DataflowGraph, OpNode


def find_cycle(nodes: Sequence[OpNode]) -> Optional[list[int]]:
    """One dependency cycle as a uid list (``[a, b, ..., a]``), or None.

    Works on arbitrary node lists — deps may point forward, making cycles
    possible even though :meth:`DataflowGraph.add` forbids them; deps
    outside the graph are ignored (reported separately as G003).
    """
    by_uid = {node.uid: node for node in nodes}
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {uid: WHITE for uid in by_uid}
    parent: dict[int, int] = {}
    for root in by_uid:
        if color[root] != WHITE:
            continue
        stack: list[tuple[int, int]] = [(root, 0)]
        color[root] = GRAY
        while stack:
            uid, i = stack[-1]
            deps = [d for d in by_uid[uid].deps if d in by_uid]
            if i < len(deps):
                stack[-1] = (uid, i + 1)
                d = deps[i]
                if color[d] == GRAY:
                    # back edge: unwind the cycle dep -> ... -> uid -> dep
                    cycle = [uid]
                    cur = uid
                    while cur != d:
                        cur = parent[cur]
                        cycle.append(cur)
                    cycle.reverse()
                    return cycle + [cycle[0]]
                if color[d] == WHITE:
                    color[d] = GRAY
                    parent[d] = uid
                    stack.append((d, 0))
            else:
                color[uid] = BLACK
                stack.pop()
    return None


def cycle_names(graph: DataflowGraph) -> Optional[list[str]]:
    """The offending cycle as node names, or None (used by Simulator.run)."""
    cyc = find_cycle(graph.nodes)
    if cyc is None:
        return None
    by_uid = {n.uid: n for n in graph.nodes}
    return [by_uid[u].name for u in cyc]


def unsimulated_summary(graph: DataflowGraph, completed: Sequence[bool]) -> str:
    """Human detail for a stalled simulation: which nodes never ran, and —
    delegated cycle extraction — the dependency cycle blocking them."""
    unreached = [n.name for n in graph.nodes if not completed[n.uid]]
    head = ", ".join(unreached[:8])
    more = f", ... ({len(unreached)} total)" if len(unreached) > 8 else ""
    msg = f"unreached nodes: {head}{more}"
    names = cycle_names(graph)
    if names is not None:
        msg += f"; dependency cycle: {' -> '.join(names)}"
    else:
        msg += "; no cycle found (dangling or out-of-graph dependencies)"
    return msg


def _is_link_device(device: Optional[str]) -> bool:
    return device is not None and device.startswith("link")


def lint_graph_structure(graph: DataflowGraph, report: Report) -> None:
    """G001-G006: uid numbering, dangling deps, topo order, cycles."""
    n = len(graph.nodes)
    seen: set[int] = set()
    order_ok = True
    for idx, node in enumerate(graph.nodes):
        if node.uid in seen:
            report.error(
                "G001", f"node {node.name!r} reuses uid {node.uid}",
                node=node.uid, name=node.name,
            )
        seen.add(node.uid)
        if node.uid != idx:
            report.error(
                "G002",
                f"node {node.name!r} has uid {node.uid} at position {idx}",
                node=node.uid, name=node.name, position=idx,
            )
        for d in node.deps:
            if not 0 <= d < n:
                report.error(
                    "G003",
                    f"node {node.name!r} (uid {node.uid}) depends on "
                    f"undefined uid {d}",
                    node=node.uid, name=node.name, dep=d,
                )
            elif d == node.uid:
                order_ok = False
                report.error(
                    "G004", f"node {node.name!r} depends on itself",
                    node=node.uid, name=node.name,
                )
            elif d > node.uid:
                order_ok = False
    if not order_ok or len(seen) != n:
        cyc = cycle_names(graph)
        if cyc is not None:
            report.error(
                "G005", f"dependency cycle: {' -> '.join(cyc)}",
                cycle=cyc,
            )
        else:
            # forward references without a closed cycle still break the
            # DataflowGraph topological-order contract
            bad = [
                (node.uid, node.name, d)
                for node in graph.nodes
                for d in node.deps
                if node.uid < d < n
            ]
            for uid, name, d in bad[:8]:
                report.error(
                    "G006",
                    f"node {name!r} (uid {uid}) depends on later uid {d}",
                    node=uid, name=name, dep=d,
                )


def lint_graph_placement(graph: DataflowGraph, report: Report) -> None:
    """G010-G013: device-placement consistency."""
    n = len(graph.nodes)
    for node in graph.nodes:
        if node.is_collective and node.device is not None and not _is_link_device(node.device):
            report.warning(
                "G010",
                f"collective {node.name!r} placed on compute device "
                f"{node.device!r}",
                node=node.uid, name=node.name, device=node.device,
            )
        if not node.is_collective:
            if _is_link_device(node.device):
                report.warning(
                    "G011",
                    f"compute node {node.name!r} placed on link device "
                    f"{node.device!r}",
                    node=node.uid, name=node.name, device=node.device,
                )
            if node.group_size > 1:
                report.warning(
                    "G013",
                    f"node {node.name!r} has group_size={node.group_size} "
                    "but no link_kind — it will be priced as compute",
                    node=node.uid, name=node.name,
                )
        for d in node.deps:
            if not 0 <= d < n:
                continue  # dangling: reported as G003
            dep = graph.nodes[d]
            if (
                not node.is_collective
                and not dep.is_collective
                and node.device is not None
                and dep.device is not None
                and node.device != dep.device
                and not _is_link_device(node.device)
                and not _is_link_device(dep.device)
            ):
                report.warning(
                    "G012",
                    f"dependency {dep.name!r} ({dep.device}) -> "
                    f"{node.name!r} ({node.device}) crosses devices with "
                    "no transfer node: unaccounted traffic",
                    node=node.uid, name=node.name, dep=dep.uid,
                )


def lint_graph_accounting(
    graph: DataflowGraph, report: Report, estimator=None
) -> None:
    """A001-A003: every collective must be priceable, and priced from
    measurements when a netprof-calibrated estimator is supplied."""
    from repro_torch.core.estimator import dist_comm_bytes

    pricer = getattr(estimator, "collective_pricer", None)
    for node in graph.nodes:
        if not node.is_collective:
            continue
        comm_fn = dist_comm_bytes
        if estimator is not None and estimator.comm_bytes_fn is not None:
            comm_fn = estimator.comm_bytes_fn
        try:
            nbytes = float(comm_fn(node))
        except Exception as e:  # noqa: BLE001 — every failure is the finding
            report.error(
                "A001",
                f"collective {node.name!r} ({node.kind}) is not priceable: "
                f"{type(e).__name__}: {e}",
                node=node.uid, name=node.name, kind=node.kind,
                meta_keys=sorted(node.meta),
            )
            continue
        if node.group_size > 1 and nbytes <= 0.0:
            report.warning(
                "A002",
                f"collective {node.name!r} ({node.kind}) resolves to "
                f"{nbytes} bytes with group_size={node.group_size}",
                node=node.uid, name=node.name, kind=node.kind,
            )
        if pricer is not None and node.group_size > 1:
            from repro_torch.netprof.pricing import PROV_RING

            link = estimator.platform.link_for(node.link_kind or "ici")
            _t, prov = pricer.price(
                node.kind, nbytes, node.group_size, link
            )
            node.meta["time_provenance"] = prov
            if prov == PROV_RING:
                report.error(
                    "A003",
                    f"collective {node.name!r} ({node.kind}, "
                    f"{nbytes:.0f} B x {node.group_size}) silently "
                    "ring-priced: the supplied netprof DB has no "
                    f"measurements or model for {node.kind!r}",
                    node=node.uid, name=node.name, kind=node.kind,
                )


def lint_graph(
    graph: DataflowGraph, estimator=None, name: Optional[str] = None
) -> Report:
    """Full graph lint pass: structure, placement, accounting."""
    report = Report(name or f"graph:{graph.name}")
    lint_graph_structure(graph, report)
    lint_graph_placement(graph, report)
    lint_graph_accounting(graph, report, estimator=estimator)
    report.metrics["graph_nodes"] = float(len(graph.nodes))
    report.metrics["graph_collectives"] = float(
        sum(1 for node in graph.nodes if node.is_collective)
    )
    return report
