"""Race/overlap audit over simulated timelines (:class:`SimResult` events).

The DES serializes each logical device — two events overlapping on ONE
device stream means the simulator's own FIFO invariant broke (T001), an
event starting before a dependency finished means causality broke (T002).
These are internal-consistency checks: they hold for every correct run and
exist to catch estimator/device-fn bugs (negative durations, NaN times)
the moment they corrupt a timeline rather than three plots later.

T010 is different — an *audit*, not an invariant.  Distinct link streams
(``link:pp``, ``link:dp0``, ...) are free to overlap in the simulation,
but on real hardware they often share one physical fabric; every second
two link streams are concurrently busy is a second where the serializing
DES and overlapped hardware can diverge (the sim-vs-real gap measurement
ROADMAP item 2 calls for).  The sweep-line reports total overlap seconds
and the fraction of the makespan affected as report metrics, and
:func:`link_contention` expands the audit into a contention-exposure
report: per-link overlap seconds, per-pair overlap, and the top
offending event pairs (named), carried in the T010 finding's ``where``.

A copy of the JAX package's ``analysis/timeline_checks.py`` with its
imports rewritten (``tests/test_torch_analysis.py``).
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.analysis.diagnostics import Report
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.simulator import SimResult

_EPS = 1e-9


def _overlap_windows(
    intervals: list[tuple[float, float]]
) -> list[tuple[float, float]]:
    """Windows where >= 2 of the given busy intervals are simultaneously
    active (sweep line over start/end boundaries)."""
    bounds: list[tuple[float, int]] = []
    for start, end in intervals:
        if end > start:
            bounds.append((start, +1))
            bounds.append((end, -1))
    bounds.sort()
    out: list[tuple[float, float]] = []
    depth = 0
    opened = 0.0
    for t, delta in bounds:
        was = depth
        depth += delta
        if was < 2 <= depth:
            opened = t
        elif was >= 2 > depth:
            if t > opened:
                out.append((opened, t))
    return out


def _merge_interval_list(
    intervals: list[tuple[float, float]]
) -> list[tuple[float, float]]:
    """Union of busy intervals (zero-gap adjacency merged)."""
    out: list[tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1] + _EPS:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _merge_busy(events: list) -> list[tuple[float, float]]:
    return _merge_interval_list(
        [(e.start, e.end) for e in events if e.end > e.start]
    )


def link_contention(
    result: SimResult, top_pairs: int = 5
) -> dict:
    """Contention-exposure report over the link streams of a timeline.

    Returns ``{"links": {device: overlap_s}, "pairs": [...],
    "top_event_pairs": [...]}`` — per-link seconds spent concurrently busy
    with ANY other link, per-device-pair overlap seconds, and the
    ``top_pairs`` longest-overlapping event pairs with both events named.
    Every second reported is a second where a serializing fabric would
    stretch the simulated timeline (ROADMAP item 2's divergence budget).
    """
    by_device: dict[str, list] = {}
    for e in result.events:
        if e.device.startswith("link") and e.end > e.start:
            by_device.setdefault(e.device, []).append(e)
    devices = sorted(by_device)
    links = {d: 0.0 for d in devices}
    pairs = []
    event_pairs = []
    for i, da in enumerate(devices):
        for db in devices[i + 1:]:
            pair_s = 0.0
            for sa, ea in _merge_busy(by_device[da]):
                for sb, eb in _merge_busy(by_device[db]):
                    pair_s += max(0.0, min(ea, eb) - max(sa, sb))
            if pair_s > _EPS:
                pairs.append({"a": da, "b": db, "overlap_s": pair_s})
            for ev_a in by_device[da]:
                for ev_b in by_device[db]:
                    ov = max(
                        0.0, min(ev_a.end, ev_b.end)
                        - max(ev_a.start, ev_b.start)
                    )
                    if ov > _EPS:
                        event_pairs.append(
                            {
                                "a": ev_a.name, "b": ev_b.name,
                                "a_device": da, "b_device": db,
                                "start": max(ev_a.start, ev_b.start),
                                "overlap_s": ov,
                            }
                        )
    # per-link exposure: union of this link's overlap windows against the
    # union of every OTHER link's busy time
    for d in devices:
        other = [
            iv
            for d2 in devices
            if d2 != d
            for iv in _merge_busy(by_device[d2])
        ]
        exposure = 0.0
        for sa, ea in _merge_busy(by_device[d]):
            for sb, eb in _merge_interval_list(other):
                exposure += max(0.0, min(ea, eb) - max(sa, sb))
        links[d] = exposure
    pairs.sort(key=lambda p: -p["overlap_s"])
    event_pairs.sort(key=lambda p: -p["overlap_s"])
    return {
        "links": links,
        "pairs": pairs,
        "top_event_pairs": event_pairs[:top_pairs],
    }


def audit_timeline(
    result: SimResult,
    graph: Optional[DataflowGraph] = None,
    name: Optional[str] = None,
    contention_available: bool = False,
) -> Report:
    """T001-T004 invariants plus the T010/T011 link-concurrency audits.

    Needs a timeline simulated with ``record_events=True``; pass the
    simulated ``graph`` to enable the causality check (T002).

    ``contention_available=True`` declares that the caller HAS a fitted
    link-contention model (``estimator.contention_model``); a timeline that
    then shows nonzero T010 overlap while ``result.contention`` is unset
    was silently priced with the exact-serialization assumption the model
    exists to correct, and draws a T011 warning (the timeline mirror of the
    A003 no-silent-fallback rule).  With no model available, overlapped
    serialized pricing is the only option and stays a T010 info.
    """
    report = Report(name or "timeline")
    by_device: dict[str, list] = {}
    node_end: dict[int, float] = {}
    for e in result.events:
        dur = e.end - e.start
        if (
            not math.isfinite(e.start)
            or not math.isfinite(e.end)
            or dur < -_EPS
        ):
            report.error(
                "T003",
                f"event {e.name!r} on {e.device} has invalid interval "
                f"[{e.start}, {e.end}]",
                node=e.node, name=e.name, device=e.device,
            )
            continue
        if e.end > result.makespan * (1 + _EPS) + _EPS:
            report.error(
                "T004",
                f"event {e.name!r} ends at {e.end:.6g}s, beyond the "
                f"reported makespan {result.makespan:.6g}s",
                node=e.node, name=e.name, device=e.device,
            )
        by_device.setdefault(e.device, []).append(e)
        node_end[e.node] = max(node_end.get(e.node, 0.0), e.end)

    # T001 — per-device serialization: a logical device is a FIFO; any
    # overlap means the DES invariant (or a hand-built event list) broke
    for device, evs in sorted(by_device.items()):
        evs.sort(key=lambda e: (e.start, e.end, e.node))
        for prev, cur in zip(evs, evs[1:]):
            if cur.start < prev.end - _EPS:
                report.error(
                    "T001",
                    f"device {device}: {cur.name!r} starts at "
                    f"{cur.start:.6g}s while {prev.name!r} still runs "
                    f"until {prev.end:.6g}s",
                    device=device, node=cur.node, name=cur.name,
                    conflicts_with=prev.name,
                )

    # T002 — causality: no event may start before a priced dependency ends
    if graph is not None:
        nodes = graph.nodes
        for e in result.events:
            if not (0 <= e.node < len(nodes)):
                continue
            for d in nodes[e.node].deps:
                dep_end = node_end.get(d)
                if dep_end is not None and e.start < dep_end - _EPS:
                    report.error(
                        "T002",
                        f"event {e.name!r} starts at {e.start:.6g}s before "
                        f"its dependency {nodes[d].name!r} finishes at "
                        f"{dep_end:.6g}s",
                        node=e.node, name=e.name, dep=d,
                    )

    # T010 — link-concurrency audit (metric, not an invariant)
    link_intervals = [
        (e.start, e.end)
        for d, evs in by_device.items()
        if d.startswith("link")
        for e in evs
    ]
    windows = _overlap_windows(link_intervals)
    overlap_s = sum(end - start for start, end in windows)
    report.metrics["link_overlap_s"] = overlap_s
    report.metrics["link_overlap_fraction"] = (
        overlap_s / result.makespan if result.makespan > 0 else 0.0
    )
    report.metrics["timeline_events"] = float(len(result.events))
    if overlap_s > _EPS:
        worst = max(windows, key=lambda w: w[1] - w[0])
        contention = link_contention(result)
        for dev, exposure in sorted(contention["links"].items()):
            report.metrics[f"link_overlap_s[{dev}]"] = exposure
        top = contention["top_event_pairs"]
        pair_txt = "; ".join(
            f"{p['a']} x {p['b']} ({p['overlap_s']:.6g}s)" for p in top[:3]
        )
        report.info(
            "T010",
            f"{len(windows)} windows ({overlap_s:.6g}s, "
            f"{100 * overlap_s / result.makespan:.1f}% of makespan) have "
            ">= 2 link streams concurrently busy — the serializing DES "
            "and overlapped hardware can diverge here (worst window "
            f"[{worst[0]:.6g}s, {worst[1]:.6g}s]; top pairs: {pair_txt})",
            windows=len(windows),
            links=contention["links"],
            pairs=contention["pairs"],
            top_event_pairs=top,
        )
        # T011 — silent serialized pricing: overlap is present AND a
        # contention model was available, yet this timeline was simulated
        # without it (SimResult.contention unset)
        if contention_available and result.contention is None:
            report.warning(
                "T011",
                f"{overlap_s:.6g}s of link overlap priced WITHOUT the "
                "available link-contention model — pass "
                "contention=estimator.contention_model to simulate() so "
                "concurrent collectives are slowed by the fitted gamma(k) "
                "instead of silently overlapping for free",
                overlap_s=overlap_s,
            )
    return report


def audit_serve_timeline(
    result: SimResult,
    graph: DataflowGraph,
    name: Optional[str] = None,
) -> Report:
    """Serve-sim audit: the generic timeline invariants plus A004.

    A004: every serve-annotated node the estimator priced must carry a
    ``time_provenance`` stamp (``measured-db`` / ``measured-fit`` /
    ``analytic``) — a missing stamp means a serve node slipped past the
    serve pricing chain and was costed by some other path, which would
    silently decouple the twin's percentiles from the profiled data.
    Provenance counts land in the report metrics so launch reports can
    show measured-vs-analytic coverage.
    """
    report = audit_timeline(result, graph, name or "serve-timeline")
    n_serve = 0
    prov_counts: dict[str, int] = {}
    for node in graph.nodes:
        if node.meta.get("serve") is None:
            continue
        n_serve += 1
        prov = node.meta.get("time_provenance")
        if prov is None:
            report.error(
                "A004",
                f"serve node {node.name!r} ({node.kind}) was simulated "
                "without a time_provenance stamp",
                node=node.uid, name=node.name, kind=node.kind,
            )
        else:
            prov_counts[prov] = prov_counts.get(prov, 0) + 1
    report.metrics["serve_nodes"] = float(n_serve)
    for prov, c in sorted(prov_counts.items()):
        report.metrics[f"serve_prov_{prov}"] = float(c)
    return report
