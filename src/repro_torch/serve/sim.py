"""DES twin of the serving engine: priced trace replay + parity replay.

Both entry points drive the SAME :class:`~repro_torch.serve.policy.ServeScheduler`
the real engine drives — the only difference is where a step's duration
comes from:

* :func:`simulate_serve` — *predictive* mode.  Each planned step becomes
  one or two graph nodes (a prefill chunk, the full-batch decode) priced
  through the estimator's serve chain (ProfileDB hit -> Dooly-style
  interpolation -> analytic roofline), and the simulated clock advances by
  the priced duration.  Returns per-request latency percentiles, the
  priced :class:`DataflowGraph` (every node provenance-stamped — audited
  by ``repro_torch.analysis.audit_serve_timeline``) and a
  :class:`~repro_torch.core.simulator.SimResult` timeline.

* :func:`replay_schedule` — *parity* mode.  Re-runs the policy with the
  engine's own measured per-step durations.  Because scheduler decisions
  depend only on (trace, config, step durations), the replay reproduces
  the engine's step compositions exactly — the hard half of the serve
  parity gate; the soft half compares measured vs priced percentiles.

Serve steps are serial on one logical "chip" stream (the engine's host
loop dispatches one jitted call after another), so the DES here is a
single-queue clock loop; the graph still records the dependency chain so
the generic :class:`Simulator` replays it to the same makespan
(asserted in tests/test_serve_sim.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.simulator import SimEvent, SimResult
from repro_torch.serve.cost import (
    FAMILY_DECODE,
    FAMILY_PREFILL,
    serve_node_features,
    serve_node_meta,
)
from repro_torch.serve.policy import ServeConfig, ServeScheduler, StepPlan
from repro_torch.serve.report import latency_report
from repro_torch.serve.trace import TraceRequest


@dataclass
class ServeSimResult:
    latency: dict                       # latency_report dict
    records: list[dict]                 # per-request latency records
    step_log: list[tuple]               # StepPlan signatures, in order
    step_durations: list[float]
    graph: Optional[DataflowGraph]      # None in replay mode
    timeline: Optional[SimResult]       # None in replay mode


def _drive(
    trace: list[TraceRequest],
    scfg: ServeConfig,
    step_cost: Callable[[StepPlan, float], float],
) -> tuple[list[dict], list[tuple], list[float], float]:
    """Run the shared policy over a trace, costing steps via ``step_cost``.

    Mirrors ``ServeEngine.step``/``run_until_done`` exactly: plan, execute
    (here: price), commit, advance; fast-forward the clock to the next
    arrival when nothing can progress.  Token timestamps land at step end —
    the same attribution point the engine uses.
    """
    sched = ServeScheduler(scfg)
    state: dict[int, dict] = {}
    for r in trace:
        sched.submit(r.rid, r.prompt_len, r.max_new_tokens, r.arrival_s)
        state[r.rid] = {
            "rid": r.rid, "arrival_s": r.arrival_s, "ttft_s": None,
            "token_gaps_s": [], "e2e_s": None, "n_tokens": 0, "_last": None,
        }
    step_log: list[tuple] = []
    durations: list[float] = []
    while sched.outstanding():
        plan = sched.plan_step()
        if plan.empty:
            nxt = sched.next_arrival()
            if nxt is None:
                queued = [q.rid for q in sched.queue]
                live = [s.rid for s in sched.slots if s is not None]
                raise RuntimeError(
                    f"serve sim stalled at step {sched.step_index} with "
                    f"work outstanding (queued requests {queued}, live "
                    f"requests {live})"
                )
            sched.skip_to(nxt)
            continue
        t0 = sched.clock
        dur = step_cost(plan, t0)
        res = sched.commit(plan)           # twin: no EOS knowledge
        sched.advance(dur)
        t_end = sched.clock
        step_log.append(plan.signature())
        durations.append(dur)
        for te in res.tokens:
            rec = state[te.rid]
            if te.first:
                rec["ttft_s"] = t_end - rec["arrival_s"]
            else:
                rec["token_gaps_s"].append(t_end - rec["_last"])
            rec["_last"] = t_end
            rec["n_tokens"] += 1
            if te.done:
                rec["e2e_s"] = t_end - rec["arrival_s"]
    records = []
    for rid in sorted(state):
        rec = dict(state[rid])
        rec.pop("_last")
        records.append(rec)
    return records, step_log, durations, sched.clock


def simulate_serve(
    trace: list[TraceRequest],
    cfg: ArchConfig,
    scfg: ServeConfig,
    estimator,
    *,
    name: str = "serve-sim",
    step_durations: Optional[list[float]] = None,
) -> ServeSimResult:
    """Price a request trace through the serve cost chain (no model runs).

    ``step_durations`` switches to *priced replay*: the scheduler clock
    advances by the engine's measured per-step durations (so, by the
    :func:`replay_schedule` induction, the step compositions — and hence
    every node uid — are bit-identical to the engine's), while each
    planned node is still priced through the estimator into the
    graph/timeline.  This is the telemetry join mode (``--obs``): the
    predictive mode admits on *priced* time, so under measurement noise
    its compositions can lag or lead the engine's by a step and the
    uid-keyed divergence join would report spurious O001/O002 pairs.
    """
    graph = DataflowGraph(name)
    events: list[SimEvent] = []
    prev: Optional[int] = None
    measured = iter(step_durations) if step_durations is not None else None

    def price(plan: StepPlan, t0: float) -> float:
        nonlocal prev
        t = t0
        deps = [prev] if prev is not None else []
        if plan.prefill is not None:
            pf = plan.prefill
            flops, nbytes = serve_node_features(
                cfg, scfg, FAMILY_PREFILL, pf.bucket
            )
            node = graph.add(
                f"step{plan.index}/prefill[r{pf.rid}@{pf.start}+{pf.width}]",
                FAMILY_PREFILL, deps, flops=flops, in_bytes=nbytes,
                device="chip",
                meta={"serve": serve_node_meta(cfg, scfg, FAMILY_PREFILL,
                                               pf.bucket)},
            )
            d = estimator.duration(node)
            events.append(
                SimEvent(node.uid, node.name, node.kind, "chip", t, t + d)
            )
            t += d
            deps = [node.uid]
        if plan.decode_slots:
            # the decode kernel has static batch = slots: a step costs the
            # same however many lanes are live (the engine pays exactly this)
            flops, nbytes = serve_node_features(
                cfg, scfg, FAMILY_DECODE, scfg.slots
            )
            meta = {
                "serve": serve_node_meta(cfg, scfg, FAMILY_DECODE, scfg.slots),
                "active_slots": len(plan.decode_slots),
            }
            node = graph.add(
                f"step{plan.index}/decode[{len(plan.decode_slots)}]",
                FAMILY_DECODE, deps, flops=flops, in_bytes=nbytes,
                device="chip", meta=meta,
            )
            d = estimator.duration(node)
            events.append(
                SimEvent(node.uid, node.name, node.kind, "chip", t, t + d)
            )
            t += d
            deps = [node.uid]
        if deps:
            prev = deps[0]
        if measured is None:
            return t - t0
        try:
            return float(next(measured))
        except StopIteration:
            raise RuntimeError(
                "priced replay exhausted the engine's step durations at "
                f"step {plan.index} — engine and twin step counts diverge"
            ) from None

    records, step_log, durations, makespan = _drive(trace, scfg, price)
    time_by_kind: dict[str, float] = {}
    busy = 0.0
    for e in events:
        d = e.end - e.start
        busy += d
        time_by_kind[e.kind] = time_by_kind.get(e.kind, 0.0) + d
    timeline = SimResult(
        makespan=makespan, device_busy={"chip": busy},
        events=events, time_by_kind=time_by_kind,
    )
    return ServeSimResult(
        latency=latency_report(records, makespan),
        records=records, step_log=step_log, step_durations=durations,
        graph=graph, timeline=timeline,
    )


def replay_schedule(
    trace: list[TraceRequest],
    scfg: ServeConfig,
    step_durations: list[float],
) -> ServeSimResult:
    """Replay the policy with the engine's measured per-step durations.

    By induction over steps, feeding the engine's own durations back into
    the shared scheduler reproduces the engine's clock at every plan point,
    hence its admission decisions, hence its step compositions — any
    mismatch in ``step_log`` means the engine bypassed its scheduler.
    """
    it = iter(step_durations)

    def cost(plan: StepPlan, t0: float) -> float:
        try:
            return float(next(it))
        except StopIteration:
            raise RuntimeError(
                "replay exhausted the engine's step durations at step "
                f"{plan.index} — engine and twin step counts diverge"
            ) from None

    records, step_log, durations, makespan = _drive(trace, scfg, cost)
    return ServeSimResult(
        latency=latency_report(records, makespan),
        records=records, step_log=step_log, step_durations=durations,
        graph=None, timeline=None,
    )
