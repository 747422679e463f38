"""Static checks over pipeline-schedule step tables and executor plans.

The executor (``repro_torch.dist.pp``) and the simulator consume the same
:class:`repro_torch.dist.schedules.PipelineSchedule` table, so a malformed table
is the one defect class that deadlocks BOTH sides — the simulator wedges
with "simulated X/N nodes" and the real shard_map executor blocks forever
on a ppermute nobody answers.  These checks prove a table well-formed
before anything runs:

* **structural** (S001-S004): every (vstage, microbatch, phase) cell
  present exactly once, on the right device, indices in range — the
  diagnostics twin of ``PipelineSchedule.validate()``'s raises;
* **liveness** (S005, S006): greedy per-device execution must not wedge;
  on deadlock the stuck frontier is named together with each stuck step's
  unmet dependencies — the cross-stage wait chain;
* **ppermute pairing** (S007-S009): over the compiled
  :class:`repro_torch.dist.schedules.ExecutorPlan` arrays, every send must have
  a matching receive one tick later on the destination device, routed to
  the right (chunk, microbatch) slot — a mismatch is exactly the
  real-executor deadlock/corruption case;
* **accounting twins** (S010, S011): the table's bubble must respect the
  analytic ``2*(S-1)`` chunk-tick fill/drain lower bound, and the executor
  plan's send counts must equal the table's ``comm_steps()`` twin.

A copy of the JAX package's ``analysis/schedule_checks.py`` with its
imports rewritten (the autotuner's pruner).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis.diagnostics import Report
from repro_torch.dist.schedules import (
    BWD,
    FWD,
    ExecutorPlan,
    PipelineSchedule,
    Step,
    make_schedule,
)


def _greedy_ticks(
    schedule: PipelineSchedule,
) -> tuple[dict[Step, int], list[tuple[Step, list[Step]]]]:
    """(ticks, stuck) — the unit-tick list schedule, or the stuck frontier.

    Re-runs the greedy per-device execution of
    ``PipelineSchedule._ticks`` but, instead of raising on deadlock,
    returns the stuck steps WITH their unmet dependencies so the
    diagnostic can name the cross-stage wait chain.
    """
    queues = {s: list(schedule.stage_steps(s)) for s in range(schedule.n_stages)}
    pos = {s: 0 for s in range(schedule.n_stages)}
    free = {s: 0 for s in range(schedule.n_stages)}
    ticks: dict[Step, int] = {}
    remaining = sum(len(q) for q in queues.values())
    while remaining:
        progressed = False
        for s in range(schedule.n_stages):
            if pos[s] >= len(queues[s]):
                continue
            step = queues[s][pos[s]]
            deps = schedule.data_deps(step)
            if any(d not in ticks for d in deps):
                continue
            ticks[step] = max([free[s]] + [ticks[d] + 1 for d in deps])
            free[s] = ticks[step] + 1
            pos[s] += 1
            remaining -= 1
            progressed = True
        if not progressed:
            stuck = []
            for s in range(schedule.n_stages):
                if pos[s] < len(queues[s]):
                    step = queues[s][pos[s]]
                    unmet = [
                        d for d in schedule.data_deps(step) if d not in ticks
                    ]
                    stuck.append((step, unmet))
            return ticks, stuck
    return ticks, []


def lint_schedule(
    schedule: PipelineSchedule, name: Optional[str] = None
) -> Report:
    """Structural + liveness + accounting checks on one step table."""
    report = Report(name or f"schedule:{schedule.describe()}")
    S, M, V = schedule.n_stages, schedule.n_microbatches, schedule.n_vstages

    seen: set[tuple] = set()
    fwd_pos: dict[tuple[int, int], int] = {}
    structural_ok = True
    for s in range(S):
        steps = schedule.stage_steps(s)
        for i, step in enumerate(steps):
            if step.stage != s or schedule.device_of(step.vstage) != s:
                structural_ok = False
                report.error(
                    "S001",
                    f"step {step.name} (vstage {step.vstage}) scheduled on "
                    f"device {s}, belongs on "
                    f"{schedule.device_of(step.vstage)}",
                    step=step.name, device=s,
                )
            if not (0 <= step.microbatch < M and 0 <= step.vstage < V):
                structural_ok = False
                report.error(
                    "S004",
                    f"step {step.name} indices out of range "
                    f"(M={M}, V={V})",
                    step=step.name, device=s,
                )
                continue
            if step.key in seen:
                structural_ok = False
                report.error(
                    "S002", f"duplicate step {step.name}",
                    step=step.name, device=s,
                )
            seen.add(step.key)
            cell = (step.vstage, step.microbatch)
            if step.phase == FWD:
                fwd_pos[cell] = i
            elif step.phase == BWD and schedule.device_of(step.vstage) == s:
                # phase legality on the owning device: bwd(k, m) must come
                # after fwd(k, m) in this device's own sequence
                f = fwd_pos.get(cell)
                if f is None:
                    report.error(
                        "S006",
                        f"step {step.name}: backward ordered before its "
                        f"forward on device {s}",
                        step=step.name, device=s,
                    )
    want = 2 * V * M
    if len(seen) != want:
        missing = [
            f"{'F' if ph == FWD else 'B'}{k}.{m}"
            for ph in (FWD, BWD)
            for k in range(V)
            for m in range(M)
            if (ph, k, m) not in seen
        ]
        report.error(
            "S003",
            f"incomplete table: {len(seen)}/{want} cells; missing "
            f"{', '.join(missing[:6])}"
            + (f", ... ({len(missing)} total)" if len(missing) > 6 else ""),
            missing=missing[:32],
        )

    ticks, stuck = _greedy_ticks(schedule)
    if stuck:
        chain = "; ".join(
            f"{step.name} on device {step.stage} waits for "
            + (", ".join(d.name for d in unmet) or "nothing schedulable")
            for step, unmet in stuck[:4]
        )
        report.error(
            "S005",
            f"schedule deadlock with {len(ticks)}/{want} steps placed — "
            f"stuck: {chain}",
            stuck=[step.name for step, _ in stuck[:16]],
        )
        return report  # tick-derived checks below need a complete table

    if structural_ok and len(seen) == want:
        total = max(ticks.values()) + 1 if ticks else 0
        analytic = schedule.analytic_bubble_ticks()
        min_bubble = None
        for s in range(S):
            bubble = total - len(schedule.stage_steps(s))
            min_bubble = bubble if min_bubble is None else min(min_bubble, bubble)
            if bubble < analytic:
                report.error(
                    "S010",
                    f"device {s} bubble {bubble} ticks < analytic "
                    f"fill/drain lower bound {analytic} — the table's "
                    "accounting twin is inconsistent",
                    device=s, bubble=bubble, bound=analytic,
                )
        report.metrics["schedule_total_ticks"] = float(total)
        report.metrics["schedule_bubble_ticks"] = float(min_bubble or 0)
        report.metrics["schedule_bubble_fraction"] = (
            float(min_bubble or 0) / total if total else 0.0
        )
        report.metrics["schedule_comm_steps"] = float(schedule.comm_steps())
    return report


def lint_executor_plan(
    plan: ExecutorPlan, name: Optional[str] = None
) -> Report:
    """Ppermute send/receive pairing over the compiled tick arrays.

    Operates on the :class:`ExecutorPlan` the executor actually closes
    over — so a corrupted plan (the dynamic-deadlock case) is caught even
    when the source table was fine.  Checks, per direction:

    * every send at tick ``t`` on stage ``s`` has a receive marked valid at
      ``t+1`` on the destination stage (S007), routed to the (chunk,
      microbatch) slot the table's data deps demand (S008);
    * no receive is marked valid without a matching send (S008);
    * no send is scheduled on the final tick (S009);
    * total sends per direction match the table's ``comm_steps()``
      accounting twin (S011).
    """
    schedule = plan.schedule
    report = Report(name or f"executor:{schedule.describe()}")
    S, T, V = schedule.n_stages, plan.n_ticks, schedule.n_vstages
    ticks = schedule.tick_table()
    step_at = {(t, step.stage): step for step, t in ticks.items()}

    matched = {"fwd": set(), "bwd": set()}
    n_sends = {"fwd": 0, "bwd": 0}
    for t in range(T):
        for s in range(S):
            for direction, sends, rv, rc, rm, dst_of in (
                ("fwd", plan.sends_fwd, plan.recv_fwd_valid,
                 plan.recv_fwd_chunk, plan.recv_fwd_mb,
                 lambda s: (s + 1) % S),
                ("bwd", plan.sends_bwd, plan.recv_bwd_valid,
                 plan.recv_bwd_chunk, plan.recv_bwd_mb,
                 lambda s: (s - 1) % S),
            ):
                if not sends[t][s]:
                    continue
                n_sends[direction] += 1
                step = step_at.get((t, s))
                if t + 1 >= T:
                    report.error(
                        "S009",
                        f"{direction} send at tick {t} on stage {s} is "
                        f"after the final tick ({T} ticks)",
                        tick=t, stage=s, direction=direction,
                    )
                    continue
                dst = dst_of(s)
                if not rv[t + 1][dst]:
                    report.error(
                        "S007",
                        f"unpaired ppermute: {direction} send at tick {t} "
                        f"on stage {s} "
                        + (f"({step.name}) " if step is not None else "")
                        + f"has no receive at tick {t + 1} on stage {dst} "
                        "— the real executor drops this activation",
                        tick=t, stage=s, dst=dst, direction=direction,
                        step=step.name if step is not None else None,
                    )
                    continue
                matched[direction].add((t + 1, dst))
                if step is not None:
                    k = step.vstage + (1 if direction == "fwd" else -1)
                    if 0 <= k < V:
                        want_chunk = schedule.chunk_of(k)
                        got_chunk = rc[t + 1][dst]
                        got_mb = rm[t + 1][dst]
                        if (got_chunk, got_mb) != (want_chunk, step.microbatch):
                            report.error(
                                "S008",
                                f"misrouted receive for {step.name}: stage "
                                f"{dst} tick {t + 1} stores into (chunk "
                                f"{got_chunk}, mb {got_mb}), expected "
                                f"(chunk {want_chunk}, mb "
                                f"{step.microbatch})",
                                tick=t + 1, stage=dst, direction=direction,
                            )
    for direction, rv in (("fwd", plan.recv_fwd_valid),
                          ("bwd", plan.recv_bwd_valid)):
        for t in range(T):
            for s in range(S):
                if rv[t][s] and (t, s) not in matched[direction]:
                    report.error(
                        "S008",
                        f"orphan receive: stage {s} expects a {direction} "
                        f"ppermute at tick {t} but no stage sends one",
                        tick=t, stage=s, direction=direction,
                    )
    expect = schedule.comm_steps()
    for direction in ("fwd", "bwd"):
        if n_sends[direction] != expect:
            report.error(
                "S011",
                f"{direction} sends in the executor plan "
                f"({n_sends[direction]}) != the table's comm_steps twin "
                f"({expect})",
                direction=direction, sends=n_sends[direction], expect=expect,
            )
    report.metrics["executor_ticks"] = float(T)
    report.metrics["executor_sends_per_direction"] = float(n_sends["fwd"])
    return report


def lint_strategy(
    strategy, n_layers: int, name: Optional[str] = None
) -> Report:
    """Schedule legality of one :class:`repro_torch.core.strategy.Strategy`.

    The autotuner's static pruner: S012 (schedule not constructible for
    S/M/v — e.g. interleaved microbatches not divisible by stages), S013
    (layer count not divisible by the virtual-stage count — the graph
    builder cannot partition), then the full table lint.  Cheap enough to
    run over thousands of search candidates.
    """
    report = Report(name or f"strategy:{strategy.describe()}")
    try:
        schedule = make_schedule(
            strategy.schedule, strategy.pp, strategy.microbatches,
            strategy.vstages,
        )
    except ValueError as e:
        report.error(
            "S012", f"schedule not constructible: {e}",
            schedule=strategy.schedule, pp=strategy.pp,
            microbatches=strategy.microbatches, vstages=strategy.vstages,
        )
        return report
    V = schedule.n_vstages
    if n_layers % V != 0:
        report.error(
            "S013",
            f"{n_layers} layers not divisible by {V} virtual stages "
            f"(pp={strategy.pp} x v={strategy.vstages})",
            n_layers=n_layers, vstages=V,
        )
        return report
    return report.extend(lint_schedule(schedule, name=report.name))
