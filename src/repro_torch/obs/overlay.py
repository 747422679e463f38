"""Overlay exporter: one Chrome/Perfetto trace, sim and real side by side.

Each logical device gets two adjacent trace processes — ``sim:<device>``
and ``real:<device>`` — ordered by the same compute-first key the
sim-only exporter uses (:func:`repro_torch.core.timeline._device_sort_key`), so
a pipeline overlay reads stage-by-stage with the simulated prediction
directly above the measurement.  Both sides are t0-normalized
independently: the comparison is *durations and structure*, not absolute
wall-clock (the real side starts whenever the launch did).

Sim events carry their pricing provenance and byte twins
(``time_provenance``, ``comm_bytes``, ``flops``) as trace args; real
spans carry their recorder labels.  Counter tracks ("C" events) render
in-flight microbatches and link concurrency derived from the simulated
timeline (:func:`derive_sim_counters`) plus whatever counters the real
recorder sampled (KV free blocks, live slots — see
``repro_torch.serve.engine``).

A copy of the JAX package's ``obs/overlay.py`` with its imports rewritten
(``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import json
import re
from typing import Any, Iterable, Optional

from repro_torch.core.timeline import _device_sort_key
from repro_torch.obs.record import Counter

_F_NODE = re.compile(r"^F(\d+)\.(\d+)$")
_B_NODE = re.compile(r"^B(\d+)\.(\d+)$")


def derive_sim_counters(sim_result) -> list[Counter]:
    """Counter tracks computable from a simulated timeline alone.

    * ``inflight_microbatches`` — +1 at a microbatch's first forward
      start, -1 at its last backward end (the pipeline's live-activation
      footprint over time);
    * ``link_concurrency`` — number of ``link:*`` devices busy at once
      (the contention pressure the link-contention model prices).
    """
    if sim_result is None:
        return []
    first_f: dict[str, float] = {}
    last_b: dict[str, float] = {}
    link_edges: list[tuple[float, int]] = []
    for e in sim_result.events:
        m = _F_NODE.match(e.name)
        if m:
            mb = m.group(2)
            if mb not in first_f or e.start < first_f[mb]:
                first_f[mb] = e.start
        m = _B_NODE.match(e.name)
        if m:
            mb = m.group(2)
            if mb not in last_b or e.end > last_b[mb]:
                last_b[mb] = e.end
        if e.device.startswith("link"):
            link_edges.append((e.start, +1))
            link_edges.append((e.end, -1))

    counters: list[Counter] = []
    mb_edges = [(t, +1) for t in first_f.values()]
    mb_edges += [(last_b[mb], -1) for mb in first_f if mb in last_b]
    for track, edges in (
        ("inflight_microbatches", mb_edges),
        ("link_concurrency", link_edges),
    ):
        level = 0
        for t, d in sorted(edges):
            level += d
            counters.append(Counter(track, "sim", t, float(level)))
    return counters


def _track_key(device: str, side: str) -> tuple:
    # sim above real for the same device; counter tracks sort last via
    # _device_sort_key's counter category
    return (_device_sort_key(device), 0 if side == "sim" else 1)


def overlay_chrome_trace(
    sim_result,
    real,
    path: Optional[str] = None,
    *,
    graph=None,
    sim_counters: Optional[Iterable[Counter]] = None,
    name: str = "obs-overlay",
) -> dict:
    """Merge a simulated timeline and a real recorder into one trace.

    ``real`` is a :class:`repro_torch.obs.record.Recorder` or a list of span
    dicts.  Either side may be ``None``/empty — a real-only trace is
    still a valid export (it just has no ``sim:`` tracks to compare
    against).
    """
    spans = []
    real_counters: list[Counter] = []
    if real is not None:
        to_events = getattr(real, "to_events", None)
        spans = list(to_events()) if callable(to_events) else [
            dict(s) for s in real
        ]
        real_counters = list(getattr(real, "counters", []) or [])
    sim_events = list(sim_result.events) if sim_result is not None else []
    if sim_counters is None:
        sim_counters = derive_sim_counters(sim_result)
    sim_counters = list(sim_counters)

    # t0-normalize each side independently
    sim_t0 = min((e.start for e in sim_events), default=0.0)
    real_t0 = min((s["start"] for s in spans), default=0.0)
    if real_counters:
        real_t0 = min(real_t0, min(c.t for c in real_counters))

    # track registry: (side, device) -> pid, ordered sim/real-adjacent
    tracks: dict[tuple[str, str], None] = {}
    for e in sim_events:
        tracks.setdefault(("sim", e.device))
    for c in sim_counters:
        tracks.setdefault(("sim", f"ctr:{c.name}"))
    for s in spans:
        tracks.setdefault(("real", s["device"]))
    for c in real_counters:
        tracks.setdefault(("real", f"ctr:{c.name}"))
    ordered = sorted(tracks, key=lambda sd: _track_key(sd[1], sd[0]))
    pid = {sd: i for i, sd in enumerate(ordered)}

    node_by_name = (
        {n.name: n for n in graph.nodes} if graph is not None else {}
    )
    events: list[dict[str, Any]] = []
    for e in sim_events:
        ev: dict[str, Any] = {
            "name": e.name,
            "cat": e.kind,
            "ph": "X",
            "ts": (e.start - sim_t0) * 1e6,
            "dur": (e.end - e.start) * 1e6,
            "pid": pid[("sim", e.device)],
            "tid": 0,
        }
        node = node_by_name.get(e.name)
        if node is not None:
            args: dict[str, Any] = {}
            prov = node.meta.get("time_provenance")
            if prov is not None:
                args["time_provenance"] = prov
            # byte twins: what the executor would put on the wire / read
            if node.comm_bytes:
                args["comm_bytes"] = node.comm_bytes
            if node.flops:
                args["flops"] = node.flops
            if node.in_bytes:
                args["in_bytes"] = node.in_bytes
            if args:
                ev["args"] = args
        events.append(ev)
    for s in spans:
        ev = {
            "name": s["name"],
            "cat": s.get("kind", "span"),
            "ph": "X",
            "ts": (s["start"] - real_t0) * 1e6,
            "dur": (s["end"] - s["start"]) * 1e6,
            "pid": pid[("real", s["device"])],
            "tid": int(s.get("depth", 0)),
        }
        labels = s.get("labels") or {}
        if labels:
            ev["args"] = {k: labels[k] for k in sorted(labels)}
        events.append(ev)
    for side, ctrs, t0 in (
        ("sim", sim_counters, sim_t0),
        ("real", real_counters, real_t0),
    ):
        for c in ctrs:
            events.append({
                "name": c.name,
                "ph": "C",
                "ts": (c.t - t0) * 1e6,
                "pid": pid[(side, f"ctr:{c.name}")],
                "tid": 0,
                "args": {c.name: c.value},
            })
    for (side, device), p in sorted(pid.items(), key=lambda kv: kv[1]):
        label = f"{side}:{device}"
        events.append({
            "name": "process_name", "ph": "M", "pid": p, "tid": 0,
            "args": {"name": label},
        })
        events.append({
            "name": "process_sort_index", "ph": "M", "pid": p, "tid": 0,
            "args": {"sort_index": p, "name": label},
        })
    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        # the trace format's name, shared with the JAX package's exporter
        # (as record.py's "repro.obs/1" schema), so the two compare equal
        "otherData": {"exporter": "repro.obs.overlay", "name": name},
    }
    if path:
        with open(path, "w") as f:
            json.dump(trace, f, sort_keys=True)
    return trace
