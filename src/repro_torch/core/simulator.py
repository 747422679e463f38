"""Dataflow-based simulation engine (paper §2, implemented verbatim).

    "Each independent device (CPU, GPU, or communication link) executes in
    parallel and maintains a job queue and its finish time.  The simulator
    keeps a global ready list containing all nodes whose dependencies are
    fulfilled.  The simulator runs in a loop: (1) It starts all nodes in the
    ready list by enqueuing them into their corresponding device's job
    queues.  (2) As soon as an op is finished on a device (using the
    profiling results), it updates all successor nodes' dependency counter.
    If the counter becomes zero, the successor node is added into ready
    list.  The system performance is obtained by looking at the finish time
    of the last device."

Implemented event-driven (a heap of op completions) which is observationally
identical to the paper's loop: every device is a FIFO served in ready-time
order, ties broken by node id for determinism.

Devices are *logical*: for an SPMD program one "chip" stream plus one link
stream per link class models the per-device program (every physical chip
executes the same schedule); heterogeneous placements (pipeline stages,
parameter servers) use per-node ``device`` attributes, preserving the
paper's general model.

**Link contention** (the overlap-aware extension): the classic loop runs
distinct link streams (``link:dp0`` vs ``link:pp`` ...) fully in parallel,
but on real hosts they usually share one fabric.  When a
:class:`repro_torch.netprof.model.LinkContentionModel` is supplied, link jobs
become processor-shared per fabric: while ``k`` jobs from distinct links
are concurrently in flight, each progresses at rate ``1/gamma(k)``
(``gamma(k) = 1 + c*(k-1)``, fitted from the concurrent-collective sweep).
Same-link jobs still serialize FIFO, compute devices are untouched, and a
timeline with **no** concurrent link intervals prices bit-identically to
the classic loop (asserted in tests) — the model changes *contention*,
never accounting.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.graph import DataflowGraph, OpNode


@dataclass
class SimEvent:
    node: int
    name: str
    kind: str
    device: str
    start: float
    end: float


@dataclass
class SimResult:
    makespan: float
    device_busy: dict[str, float]
    events: list[SimEvent]
    time_by_kind: dict[str, float]
    # description of the link-contention model the run applied, or None for
    # the classic fully-parallel link streams (audited by T011)
    contention: Optional[str] = field(default=None)

    @property
    def compute_time(self) -> float:
        return sum(
            t for k, t in self.time_by_kind.items() if not k.startswith("link")
        )

    @property
    def comm_time(self) -> float:
        return sum(
            t for k, t in self.time_by_kind.items() if k.startswith("link")
        )


def default_device_fn(node: OpNode) -> str:
    if node.device is not None:
        return node.device
    if node.is_collective:
        return f"link:{node.link_kind}"
    return "chip"


def default_fabric_fn(device: str) -> Optional[str]:
    """Which shared fabric a logical device's traffic rides on.

    Every ``link:*`` stream shares one fabric by default — the T010 audit
    measures exactly the windows where these logical streams overlap, and
    production single-slice meshes put all of them on the same ici.
    Compute devices return None (never shared)."""
    return "ici" if device.startswith("link") else None


class Simulator:
    """duration_fn(node) -> seconds; device_fn(node) -> device name.

    ``contention`` (optional): a :class:`LinkContentionModel`-shaped object
    (``gamma(k) -> float``, ``describe() -> str``); when supplied and
    non-trivial, concurrently-busy link streams on one fabric
    processor-share instead of running fully parallel.  ``fabric_fn`` maps
    a device name to its fabric (None = unshared).
    """

    def __init__(
        self,
        duration_fn: Callable[[OpNode], float],
        device_fn: Callable[[OpNode], str] = default_device_fn,
        record_events: bool = True,
        contention=None,
        fabric_fn: Callable[[str], Optional[str]] = default_fabric_fn,
    ):
        self.duration_fn = duration_fn
        self.device_fn = device_fn
        self.record_events = record_events
        # a gamma identically 1 is the classic simulator: take the exact
        # legacy code path so pricing stays bit-identical
        if contention is not None and contention.gamma(2) <= 1.0:
            contention = None
        self.contention = contention
        self.fabric_fn = fabric_fn

    def run(self, graph: DataflowGraph) -> SimResult:
        if self.contention is not None:
            return self._run_contended(graph)
        return self._run_serialized(graph)

    def _run_serialized(self, graph: DataflowGraph) -> SimResult:
        n = len(graph.nodes)
        succ = graph.successors()
        indeg = [len(node.deps) for node in graph.nodes]
        dev_avail: dict[str, float] = {}
        dev_busy: dict[str, float] = {}
        time_by_kind: dict[str, float] = {}
        events: list[SimEvent] = []

        # ready heap keyed by (ready_time, uid) — the paper's global ready
        # list with deterministic FIFO order per device
        ready: list[tuple[float, int]] = []
        finish = [0.0] * n
        completed = [False] * n
        for node in graph.nodes:
            if indeg[node.uid] == 0:
                heapq.heappush(ready, (0.0, node.uid))

        done = 0
        makespan = 0.0
        while ready:
            t_ready, uid = heapq.heappop(ready)
            node = graph.nodes[uid]
            dev = self.device_fn(node)
            dur = self.duration_fn(node)
            start = max(t_ready, dev_avail.get(dev, 0.0))
            end = start + dur
            dev_avail[dev] = end
            dev_busy[dev] = dev_busy.get(dev, 0.0) + dur
            key = dev if dev.startswith("link") else node.kind
            time_by_kind[key] = time_by_kind.get(key, 0.0) + dur
            finish[uid] = end
            makespan = max(makespan, end)
            if self.record_events and dur > 0:
                events.append(SimEvent(uid, node.name, node.kind, dev, start, end))
            done += 1
            completed[uid] = True
            for s in succ[uid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    t = max(
                        (finish[d] for d in graph.nodes[s].deps), default=0.0
                    )
                    heapq.heappush(ready, (t, s))
        if done != n:
            # name the stuck nodes and the cycle blocking them — extraction
            # is the analyzer's job (lazy import keeps core free of a
            # repro_torch.analysis dependency at module load)
            from repro_torch.analysis.graph_lints import unsimulated_summary

            raise RuntimeError(
                f"simulated {done}/{n} nodes — graph has a cycle or "
                f"unreachable dependencies; "
                f"{unsimulated_summary(graph, completed)}"
            )
        return SimResult(makespan, dev_busy, events, time_by_kind)

    # -- contention-aware loop ------------------------------------------------

    def _run_contended(self, graph: DataflowGraph) -> SimResult:
        """The same DES with per-fabric processor sharing of link jobs.

        Link jobs carry *remaining solo-seconds*; while ``k`` jobs from
        distinct links of one fabric are in flight, each drains at rate
        ``1/gamma(k)``.  Events are processed in global time order (starts
        merged with projected completions), so occupancy changes reprice
        in-flight jobs exactly.  A job that never shared its fabric keeps
        ``end == start + dur`` computed with the identical float ops as
        the serialized loop — the zero-overlap bit-parity contract.
        """
        n = len(graph.nodes)
        succ = graph.successors()
        indeg = [len(node.deps) for node in graph.nodes]
        dev_avail: dict[str, float] = {}
        dev_busy: dict[str, float] = {}
        time_by_kind: dict[str, float] = {}
        events: list[SimEvent] = []
        finish = [0.0] * n
        completed = [False] * n
        ready: list[tuple[float, int]] = []
        for node in graph.nodes:
            if indeg[node.uid] == 0:
                heapq.heappush(ready, (0.0, node.uid))

        gamma = self.contention.gamma
        # per-fabric processor-sharing state
        fab_active: dict[str, dict[int, float]] = {}  # fabric -> uid -> rem
        fab_last: dict[str, float] = {}
        fab_ver: dict[str, int] = {}
        job_start: dict[int, float] = {}
        job_solo: dict[int, float] = {}
        job_dev: dict[int, str] = {}
        job_shared: set[int] = set()
        occupied: set[str] = set()                   # link devices in flight
        parked: dict[str, list[tuple[float, int]]] = {}
        # (projected_end, version, fabric, designated uid); stale versions
        # are skipped lazily
        comp: list[tuple[float, int, str, int]] = []

        def fab_advance(f: str, now: float) -> None:
            active = fab_active.get(f)
            last = fab_last.get(f, now)
            if active and now > last:
                rate = 1.0 / gamma(len(active))
                el = now - last
                if len(active) > 1:
                    job_shared.update(active)
                for u in active:
                    active[u] -= el * rate
            fab_last[f] = now

        def fab_project(f: str) -> None:
            active = fab_active.get(f)
            if not active:
                return
            fab_ver[f] = fab_ver.get(f, 0) + 1
            rem, u = min((rem, u) for u, rem in active.items())
            t = fab_last[f] + rem * gamma(len(active))
            heapq.heappush(comp, (t, fab_ver[f], f, u))

        done = 0
        makespan = 0.0

        def finish_node(uid: int, end: float) -> None:
            nonlocal done, makespan
            finish[uid] = end
            completed[uid] = True
            makespan = max(makespan, end)
            done += 1
            for s in succ[uid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    t = max(
                        (finish[d] for d in graph.nodes[s].deps), default=0.0
                    )
                    heapq.heappush(ready, (t, s))

        def complete_link_job(f: str, uid: int, end: float) -> None:
            node = graph.nodes[uid]
            dev = job_dev[uid]
            start = job_start[uid]
            del fab_active[f][uid]
            # never-shared jobs account their solo duration (bit-parity
            # with the serialized loop); shared jobs their stretched span
            dur = job_solo[uid] if uid not in job_shared else end - start
            dev_avail[dev] = end
            dev_busy[dev] = dev_busy.get(dev, 0.0) + dur
            time_by_kind[dev] = time_by_kind.get(dev, 0.0) + dur
            if self.record_events and end > start:
                events.append(
                    SimEvent(uid, node.name, node.kind, dev, start, end)
                )
            occupied.discard(dev)
            for t_r, u in parked.pop(dev, []):
                heapq.heappush(ready, (max(t_r, end), u))
            finish_node(uid, end)

        while ready or comp:
            while comp and comp[0][1] != fab_ver.get(comp[0][2], -1):
                heapq.heappop(comp)
            t_comp = comp[0][0] if comp else math.inf
            t_start = ready[0][0] if ready else math.inf
            if t_comp is math.inf and t_start is math.inf:
                break
            if t_comp <= t_start:
                # a fabric completion: advance the fabric, retire the
                # designated job (and any co-draining ties), re-project
                t, _ver, f, u_min = heapq.heappop(comp)
                fab_advance(f, t)
                complete_link_job(f, u_min, t)
                active = fab_active.get(f, {})
                ties = sorted(
                    u for u, rem in active.items()
                    if rem <= 1e-9 * max(job_solo[u], 1e-30)
                )
                for u in ties:
                    complete_link_job(f, u, t)
                fab_project(f)
                continue
            t_ready, uid = heapq.heappop(ready)
            node = graph.nodes[uid]
            dev = self.device_fn(node)
            fabric = self.fabric_fn(dev)
            if fabric is None:
                # unshared device: the serialized loop's exact arithmetic
                dur = self.duration_fn(node)
                start = max(t_ready, dev_avail.get(dev, 0.0))
                end = start + dur
                dev_avail[dev] = end
                dev_busy[dev] = dev_busy.get(dev, 0.0) + dur
                key = dev if dev.startswith("link") else node.kind
                time_by_kind[key] = time_by_kind.get(key, 0.0) + dur
                if self.record_events and dur > 0:
                    events.append(
                        SimEvent(uid, node.name, node.kind, dev, start, end)
                    )
                finish_node(uid, end)
                continue
            if dev in occupied:
                # same-link FIFO: wait for the in-flight job; re-queued
                # with the completing job's end time on release
                parked.setdefault(dev, []).append((t_ready, uid))
                continue
            avail = dev_avail.get(dev, 0.0)
            if avail > t_ready:
                # keep global time order: a deferred start re-enters the
                # merge at its true start time
                heapq.heappush(ready, (avail, uid))
                continue
            dur = self.duration_fn(node)
            if dur <= 0.0:
                dev_avail[dev] = t_ready
                time_by_kind.setdefault(dev, 0.0)
                dev_busy.setdefault(dev, 0.0)
                finish_node(uid, t_ready)
                continue
            fab_advance(fabric, t_ready)
            fab_active.setdefault(fabric, {})[uid] = dur
            if len(fab_active[fabric]) > 1:
                job_shared.update(fab_active[fabric])
            job_start[uid] = t_ready
            job_solo[uid] = dur
            job_dev[uid] = dev
            occupied.add(dev)
            fab_project(fabric)

        if done != n:
            from repro_torch.analysis.graph_lints import unsimulated_summary

            raise RuntimeError(
                f"simulated {done}/{n} nodes — graph has a cycle or "
                f"unreachable dependencies; "
                f"{unsimulated_summary(graph, completed)}"
            )
        events.sort(key=lambda e: (e.start, e.end, e.node))
        describe = getattr(self.contention, "describe", None)
        return SimResult(
            makespan, dev_busy, events, time_by_kind,
            contention=describe() if describe else "contention",
        )


def simulate(
    graph: DataflowGraph,
    duration_fn: Callable[[OpNode], float],
    device_fn: Callable[[OpNode], str] = default_device_fn,
    record_events: bool = False,
    contention=None,
    fabric_fn: Callable[[str], Optional[str]] = default_fabric_fn,
) -> SimResult:
    return Simulator(
        duration_fn, device_fn, record_events,
        contention=contention, fabric_fn=fabric_fn,
    ).run(graph)
