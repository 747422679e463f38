"""Chrome-trace export of simulated timelines (viewable in perfetto/chrome).

Each simulated device becomes its own trace *process* (pid) with a
``process_name`` metadata record, so heterogeneous timelines — pipeline
stages, per-stage dp links, the pp boundary link — render as separately
labeled swimlanes instead of anonymous tids under one process.  Pids are
ordered compute-devices-first (``chip``, the serve engine host, ``stage0``,
``stage1``, ..., serve ``slot``s), then links, then counter tracks,
matching how you read a pipeline trace top-to-bottom; see
docs/timelines.md for a walkthrough.  The sim-vs-real overlay exporter
(:mod:`repro_torch.obs.overlay`) reuses :func:`_device_sort_key` so both
exporters order lanes identically.

A copy of the JAX package's ``core/timeline.py`` with its imports
rewritten; ``tests/test_torch_strategy.py`` holds its trace identical.
"""
from __future__ import annotations

import json

from repro_torch.core.simulator import SimResult


def _device_sort_key(device: str) -> tuple:
    """chip/host first, then stages and serve slots by number, then links
    alphabetically, then everything else, with counter tracks last."""
    if device in ("chip", "host", "engine"):
        return (0, 0, device)
    for prefix, rank in (("stage", 1), ("slot", 2)):
        if device.startswith(prefix):
            try:
                return (rank, int(device[len(prefix):]), device)
            except ValueError:
                return (rank, 0, device)
    if device.startswith("link"):
        return (3, 0, device)
    if device.startswith("ctr:"):
        return (5, 0, device)
    return (4, 0, device)


def to_chrome_trace(
    result: SimResult, path: str | None = None, graph=None, counters=None
) -> dict:
    """Export a simulated timeline; pass the simulated ``graph`` to attach
    per-event pricing provenance (``measured-db`` / ``measured-fit`` /
    ``ring``, written into node meta by the estimator's collective chain —
    see repro_torch.netprof) as trace-event args, so a perfetto click shows
    whether that box was priced from a measurement or from the spec sheet.

    ``counters`` is an optional iterable of
    :class:`repro_torch.obs.record.Counter` samples (or ``(name, t, value)``
    tuples); each distinct counter name becomes a ``ctr:<name>`` process of
    "C" events rendered below the device lanes (in-flight microbatches,
    link concurrency, KV free blocks ...).
    """
    counter_samples: list[tuple[str, float, float]] = []
    for c in counters or ():
        if isinstance(c, tuple):
            nm, t, v = c
        else:
            nm, t, v = c.name, c.t, c.value
        counter_samples.append((str(nm), float(t), float(v)))

    devices = sorted(
        {e.device for e in result.events}
        | {f"ctr:{nm}" for nm, _, _ in counter_samples},
        key=_device_sort_key,
    )
    pid = {d: i for i, d in enumerate(devices)}
    events = []
    for e in result.events:
        ev = {
            "name": e.name,
            "cat": e.kind,
            "ph": "X",
            "ts": e.start * 1e6,
            "dur": (e.end - e.start) * 1e6,
            "pid": pid[e.device],
            "tid": 0,
        }
        if graph is not None:
            prov = graph.nodes[e.node].meta.get("time_provenance")
            if prov is not None:
                ev["args"] = {"time_provenance": prov}
        events.append(ev)
    for nm, t, v in counter_samples:
        events.append(
            {
                "name": nm,
                "ph": "C",
                "ts": t * 1e6,
                "pid": pid[f"ctr:{nm}"],
                "tid": 0,
                "args": {nm: v},
            }
        )
    for d, p in pid.items():
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": p,
                "tid": 0,
                "args": {"name": d},
            }
        )
        events.append(
            {
                "name": "process_sort_index",
                "ph": "M",
                "pid": p,
                "tid": 0,
                "args": {"sort_index": p, "name": d},
            }
        )
        # thread_name kept for viewers that group by tid within a process
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": p,
                "tid": 0,
                "args": {"name": d},
            }
        )
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path:
        with open(path, "w") as f:
            json.dump(trace, f, sort_keys=True)
    return trace
