"""Serve-plan resource sanitizer: the R-code family (abstract interpreter).

The serving engine's correctness rests on a handful of ledger invariants
the shared :class:`~repro_torch.serve.policy.ServeScheduler` maintains at run
time: every KV block freed exactly once, worst-case reservations inside
the pool, FIFO admission, one decode per slot per step, token counts
capped by ``effective_max_tokens``.  This module checks those invariants
*statically* — :func:`extract_serve_plan` replays the scheduler over an
arrival trace into a plain-data :class:`ServePlan` (no model, no devices,
no pricing), and :func:`check_serve_plan` symbolically re-executes the
block ledger over that record, emitting a diagnostic per violation with
the request id and step index named:

=====  =================================================================
R001   block leak — a block allocated to a request is never freed
R002   double-free, or free of a block the request never owned
R003   reservation violates the pool (over-reservation, double-booked
       block, id outside the pool, or under-reserved worst case)
R004   ``effective_max_tokens`` capacity cap violated
R005   FIFO admission order broken (or admission before arrival)
R006   decode-slot exclusivity / slot-composition broken in one step
R007   per-request token count outside [1, effective budget]
=====  =================================================================

A plan produced by the real scheduler always verifies clean — the value
is gating *serialized* plans (``ServePlan.load``), hand-edited or
machine-generated step tables, and regression-testing the scheduler
itself: ``launch/serve.py --analyze`` runs this before any device work
and raises :class:`~repro_torch.analysis.PlanVerificationError` on errors.

A copy of the JAX package's ``analysis/serve_checks.py`` with its imports
rewritten (``tests/test_torch_analysis.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.analysis.diagnostics import Report
from repro_torch.serve.blocks import blocks_for_tokens
from repro_torch.serve.policy import ServeConfig, ServeScheduler, StepPlan
from repro_torch.serve.trace import TraceRequest

_EPS = 1e-12


@dataclass(frozen=True)
class AdmitRecord:
    """One admission: request -> slot, with its reserved blocks + budget."""

    rid: int
    slot: int
    budget: int                  # effective (capacity-capped) token budget
    blocks: tuple[int, ...]      # reserved block ids, worst-case footprint


@dataclass(frozen=True)
class FreeRecord:
    """One request's blocks returned to the pool on completion."""

    rid: int
    blocks: tuple[int, ...]


@dataclass(frozen=True)
class ServeStepRecord:
    """One scheduler step, fully materialized (plan + commit effects)."""

    index: int
    clock_s: float
    admitted: tuple[AdmitRecord, ...]
    # (slot, rid, start, width, final) — mirrors PrefillChunk sans bucket
    prefill: Optional[tuple[int, int, int, int, bool]]
    decode_slots: tuple[int, ...]
    freed: tuple[FreeRecord, ...]


@dataclass
class ServePlan:
    """Plain-data, JSON-serializable record of a whole serving schedule."""

    slots: int
    max_len: int
    block_size: int
    num_blocks: int              # resolved pool size (scratch included)
    chunk: int
    scratch_block: int
    requests: list[dict]         # {rid, prompt_len, max_new_tokens,
    #                               arrival_s, order}
    steps: list[ServeStepRecord] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "slots": self.slots,
            "max_len": self.max_len,
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "chunk": self.chunk,
            "scratch_block": self.scratch_block,
            "requests": [dict(r) for r in self.requests],
            "steps": [
                {
                    "index": s.index,
                    "clock_s": s.clock_s,
                    "admitted": [
                        {"rid": a.rid, "slot": a.slot, "budget": a.budget,
                         "blocks": list(a.blocks)}
                        for a in s.admitted
                    ],
                    "prefill": list(s.prefill) if s.prefill else None,
                    "decode_slots": list(s.decode_slots),
                    "freed": [
                        {"rid": f.rid, "blocks": list(f.blocks)}
                        for f in s.freed
                    ],
                }
                for s in self.steps
            ],
        }

    @staticmethod
    def from_dict(doc: dict[str, Any]) -> "ServePlan":
        steps = [
            ServeStepRecord(
                index=int(s["index"]),
                clock_s=float(s["clock_s"]),
                admitted=tuple(
                    AdmitRecord(int(a["rid"]), int(a["slot"]),
                                int(a["budget"]), tuple(a["blocks"]))
                    for a in s["admitted"]
                ),
                prefill=(
                    (int(s["prefill"][0]), int(s["prefill"][1]),
                     int(s["prefill"][2]), int(s["prefill"][3]),
                     bool(s["prefill"][4]))
                    if s.get("prefill") else None
                ),
                decode_slots=tuple(int(d) for d in s["decode_slots"]),
                freed=tuple(
                    FreeRecord(int(f["rid"]), tuple(f["blocks"]))
                    for f in s["freed"]
                ),
            )
            for s in doc["steps"]
        ]
        return ServePlan(
            slots=int(doc["slots"]), max_len=int(doc["max_len"]),
            block_size=int(doc["block_size"]),
            num_blocks=int(doc["num_blocks"]), chunk=int(doc["chunk"]),
            scratch_block=int(doc["scratch_block"]),
            requests=[dict(r) for r in doc["requests"]], steps=steps,
        )

    def save(self, path: str) -> None:
        import json

        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @staticmethod
    def load(path: str) -> "ServePlan":
        import json

        with open(path) as f:
            return ServePlan.from_dict(json.load(f))


def lint_serve_trace(
    trace: list[TraceRequest],
    scfg: ServeConfig,
    name: Optional[str] = None,
) -> Report:
    """Pre-extraction trace legality: the checks ``submit()`` enforces
    dynamically, as diagnostics instead of exceptions."""
    report = Report(name or "serve-trace")
    usable = scfg.resolved_num_blocks() - 1     # block 0 is scratch
    seen: set[int] = set()
    for r in trace:
        if r.rid in seen:
            report.error(
                "R005",
                f"duplicate request id {r.rid} in the trace — FIFO "
                f"identity is ambiguous",
                rid=r.rid,
            )
        seen.add(r.rid)
        if r.prompt_len < 1:
            report.error(
                "R004", f"request {r.rid}: empty prompt", rid=r.rid,
            )
            continue
        if r.prompt_len > scfg.max_len:
            report.error(
                "R004",
                f"request {r.rid}: prompt_len {r.prompt_len} exceeds "
                f"engine max_len {scfg.max_len}",
                rid=r.rid,
            )
            continue
        eff = scfg.effective_max_tokens(r.prompt_len, r.max_new_tokens)
        needed = blocks_for_tokens(r.prompt_len + eff - 1, scfg.block_size)
        if needed > usable:
            report.error(
                "R003",
                f"request {r.rid}: worst-case footprint {needed} blocks "
                f"can never fit the usable pool ({usable} blocks)",
                rid=r.rid, needed=needed, pool=usable,
            )
    report.metrics["serve_trace_requests"] = float(len(trace))
    return report


def extract_serve_plan(
    trace: list[TraceRequest],
    scfg: ServeConfig,
    step_cost: Optional[Callable[[StepPlan, float], float]] = None,
) -> ServePlan:
    """Drive the shared scheduler over a trace, recording every step.

    ``step_cost`` defaults to a constant per-step duration — scheduling
    decisions under any positive cost are legal policy outputs, and the R
    checks are duration-independent (only arrival gating reads the clock,
    and the recorded ``clock_s`` is checked against the recorded
    arrivals).  Mirrors ``repro_torch.serve.sim._drive`` step for step.
    """
    cost = step_cost or (lambda plan, t0: 1e-3)
    sched = ServeScheduler(scfg)
    requests = []
    for r in trace:
        sched.submit(r.rid, r.prompt_len, r.max_new_tokens, r.arrival_s)
        requests.append({
            "rid": r.rid, "prompt_len": r.prompt_len,
            "max_new_tokens": r.max_new_tokens, "arrival_s": r.arrival_s,
            "order": len(requests),
        })
    plan = ServePlan(
        slots=scfg.slots, max_len=scfg.max_len, block_size=scfg.block_size,
        num_blocks=scfg.resolved_num_blocks(), chunk=scfg.chunk,
        scratch_block=sched.scratch_block, requests=requests,
    )
    owned: dict[int, tuple[int, ...]] = {}      # rid -> reserved blocks
    while sched.outstanding():
        sp = sched.plan_step()
        if sp.empty:
            nxt = sched.next_arrival()
            if nxt is None:
                live = [s.rid for s in sched.slots if s is not None]
                raise RuntimeError(
                    f"serve plan extraction stalled at step "
                    f"{sched.step_index} with requests outstanding "
                    f"(queued {[q.rid for q in sched.queue]}, live {live})"
                )
            sched.skip_to(nxt)
            continue
        t0 = sched.clock
        admitted = []
        for rid, slot in sp.admitted:
            s = sched.slot_state(slot)
            assert s is not None and s.rid == rid
            owned[rid] = tuple(s.blocks)
            admitted.append(
                AdmitRecord(rid=rid, slot=slot, budget=s.max_tokens,
                            blocks=tuple(s.blocks))
            )
        res = sched.commit(sp)
        sched.advance(cost(sp, t0))
        pf = sp.prefill
        plan.steps.append(
            ServeStepRecord(
                index=sp.index, clock_s=t0, admitted=tuple(admitted),
                prefill=(
                    (pf.slot, pf.rid, pf.start, pf.width, pf.final)
                    if pf is not None else None
                ),
                decode_slots=sp.decode_slots,
                freed=tuple(
                    FreeRecord(rid, owned.pop(rid)) for rid in res.finished
                ),
            )
        )
    return plan


def check_serve_plan(plan: ServePlan, name: Optional[str] = None) -> Report:
    """Symbolically replay a :class:`ServePlan`'s block ledger (R codes)."""
    report = Report(name or "serve-plan")
    usable = plan.num_blocks - 1                # scratch never allocatable
    scfg = ServeConfig(
        slots=plan.slots, max_len=plan.max_len,
        block_size=plan.block_size, num_blocks=plan.num_blocks,
        chunk=plan.chunk,
    )
    queued: dict[int, dict] = {}
    for r in plan.requests:
        queued[int(r["rid"])] = r
    owned: dict[int, int] = {}                  # block -> rid
    live: dict[int, dict] = {}                  # rid -> symbolic slot state
    slot_rid: dict[int, int] = {}               # slot -> rid
    peak = 0
    tokens_total = 0

    def qkey(r: dict) -> tuple[float, int]:
        return (float(r["arrival_s"]), int(r["order"]))

    for rec in plan.steps:
        idx = rec.index
        for adm in rec.admitted:
            r = queued.get(adm.rid)
            if r is None:
                report.error(
                    "R005",
                    f"step {idx}: request {adm.rid} admitted but never "
                    f"queued (or admitted twice)",
                    rid=adm.rid, step=idx,
                )
                continue
            if float(r["arrival_s"]) > rec.clock_s + _EPS:
                report.error(
                    "R005",
                    f"step {idx}: request {adm.rid} admitted at clock "
                    f"{rec.clock_s:.6g}s before its arrival "
                    f"{r['arrival_s']:.6g}s",
                    rid=adm.rid, step=idx,
                )
            head = min(queued.values(), key=qkey)
            if int(head["rid"]) != adm.rid:
                report.error(
                    "R005",
                    f"step {idx}: request {adm.rid} admitted ahead of the "
                    f"earlier-queued request {head['rid']} (FIFO with "
                    f"head-of-line blocking admits strictly in order)",
                    rid=adm.rid, step=idx, jumped=int(head["rid"]),
                )
            del queued[adm.rid]
            if not 0 <= adm.slot < plan.slots:
                report.error(
                    "R006",
                    f"step {idx}: request {adm.rid} admitted into slot "
                    f"{adm.slot}, outside [0, {plan.slots})",
                    rid=adm.rid, step=idx, slot=adm.slot,
                )
                continue
            if adm.slot in slot_rid:
                report.error(
                    "R006",
                    f"step {idx}: request {adm.rid} admitted into slot "
                    f"{adm.slot} still occupied by request "
                    f"{slot_rid[adm.slot]}",
                    rid=adm.rid, step=idx, slot=adm.slot,
                )
            eff = scfg.effective_max_tokens(
                int(r["prompt_len"]), int(r["max_new_tokens"])
            )
            if adm.budget > eff:
                report.error(
                    "R004",
                    f"step {idx}: request {adm.rid} admitted with budget "
                    f"{adm.budget}, above the capacity cap {eff} "
                    f"(max_len {plan.max_len}, prompt {r['prompt_len']})",
                    rid=adm.rid, step=idx, budget=adm.budget, cap=eff,
                )
            elif adm.budget < eff:
                report.warning(
                    "R004",
                    f"step {idx}: request {adm.rid} admitted with budget "
                    f"{adm.budget} below the capacity-capped {eff} — "
                    f"composition will diverge from the shared policy",
                    rid=adm.rid, step=idx, budget=adm.budget, cap=eff,
                )
            needed = blocks_for_tokens(
                int(r["prompt_len"]) + eff - 1, plan.block_size
            )
            if len(adm.blocks) != needed:
                report.error(
                    "R003",
                    f"step {idx}: request {adm.rid} reserved "
                    f"{len(adm.blocks)} blocks; the worst-case footprint "
                    f"is {needed} (prompt {r['prompt_len']} + budget "
                    f"{eff} - 1 positions)",
                    rid=adm.rid, step=idx,
                    reserved=len(adm.blocks), needed=needed,
                )
            for b in adm.blocks:
                if not 0 <= b < plan.num_blocks:
                    report.error(
                        "R003",
                        f"step {idx}: request {adm.rid} reserved block "
                        f"{b}, outside the pool [0, {plan.num_blocks})",
                        rid=adm.rid, step=idx, block=b,
                    )
                elif b == plan.scratch_block:
                    report.error(
                        "R003",
                        f"step {idx}: request {adm.rid} reserved the "
                        f"scratch block {b}",
                        rid=adm.rid, step=idx, block=b,
                    )
                elif b in owned:
                    report.error(
                        "R003",
                        f"step {idx}: request {adm.rid} reserved block "
                        f"{b}, already owned by request {owned[b]}",
                        rid=adm.rid, step=idx, block=b, owner=owned[b],
                    )
                else:
                    owned[b] = adm.rid
            slot_rid[adm.slot] = adm.rid
            live[adm.rid] = {
                "slot": adm.slot, "prompt_len": int(r["prompt_len"]),
                "budget": adm.budget, "pos": 0, "phase": "prefill",
                "emitted": 0,
            }
        if len(owned) > usable:
            report.error(
                "R003",
                f"step {idx}: {len(owned)} live reserved blocks exceed "
                f"the usable pool of {usable} "
                f"({plan.num_blocks} blocks minus scratch)",
                step=idx, reserved=len(owned), pool=usable,
            )
        peak = max(peak, len(owned))

        if rec.prefill is not None:
            slot, rid, start, width, final = rec.prefill
            s = live.get(rid)
            if s is None or slot_rid.get(slot) != rid:
                holder = slot_rid.get(slot)
                report.error(
                    "R006",
                    f"step {idx}: prefill chunk targets request {rid} in "
                    f"slot {slot}, but the slot holds "
                    f"{'no request' if holder is None else f'request {holder}'}",
                    rid=rid, step=idx, slot=slot,
                )
            elif s["phase"] != "prefill":
                report.error(
                    "R006",
                    f"step {idx}: prefill chunk for request {rid}, which "
                    f"already finished its prompt",
                    rid=rid, step=idx, slot=slot,
                )
            else:
                if start != s["pos"]:
                    report.error(
                        "R006",
                        f"step {idx}: request {rid} prefill starts at "
                        f"position {start}; {s['pos']} prompt tokens are "
                        f"cached",
                        rid=rid, step=idx,
                    )
                if width < 1 or start + width > s["prompt_len"]:
                    report.error(
                        "R007",
                        f"step {idx}: request {rid} prefill chunk "
                        f"[{start}, {start + width}) writes outside its "
                        f"prompt of {s['prompt_len']} tokens",
                        rid=rid, step=idx,
                    )
                elif width != min(plan.chunk, s["prompt_len"] - start):
                    report.error(
                        "R006",
                        f"step {idx}: request {rid} prefill width {width} "
                        f"diverges from the shared policy's "
                        f"{min(plan.chunk, s['prompt_len'] - start)}",
                        rid=rid, step=idx,
                    )
                s["pos"] = min(start + width, s["prompt_len"])
                done_prompt = s["pos"] >= s["prompt_len"]
                if final != done_prompt:
                    report.error(
                        "R006",
                        f"step {idx}: request {rid} prefill marked "
                        f"final={final} with {s['pos']}/{s['prompt_len']} "
                        f"prompt tokens cached",
                        rid=rid, step=idx,
                    )
                if done_prompt:
                    s["phase"] = "decode"
                    s["emitted"] = 1          # prefill produces token 1
                    tokens_total += 1

        seen_slots: set[int] = set()
        for slot in rec.decode_slots:
            if slot in seen_slots:
                report.error(
                    "R006",
                    f"step {idx}: slot {slot} appears twice in the decode "
                    f"batch",
                    step=idx, slot=slot,
                )
                continue
            seen_slots.add(slot)
            if rec.prefill is not None and slot == rec.prefill[0]:
                report.error(
                    "R006",
                    f"step {idx}: slot {slot} both prefills and decodes "
                    f"in one step (request {rec.prefill[1]})",
                    rid=rec.prefill[1], step=idx, slot=slot,
                )
                continue
            rid = slot_rid.get(slot)
            s = live.get(rid) if rid is not None else None
            if rid is None or s is None:
                report.error(
                    "R006",
                    f"step {idx}: decode batch includes slot {slot} with "
                    f"no admitted request",
                    step=idx, slot=slot,
                )
                continue
            if s["phase"] != "decode":
                report.error(
                    "R006",
                    f"step {idx}: request {rid} decodes in slot {slot} "
                    f"with only {s['pos']}/{s['prompt_len']} prompt "
                    f"tokens cached",
                    rid=rid, step=idx, slot=slot,
                )
                continue
            s["emitted"] += 1
            tokens_total += 1
            if s["emitted"] > s["budget"]:
                report.error(
                    "R007",
                    f"step {idx}: request {rid} emits token "
                    f"{s['emitted']}, beyond its effective budget "
                    f"{s['budget']}",
                    rid=rid, step=idx,
                    emitted=s["emitted"], budget=s["budget"],
                )

        for fr in rec.freed:
            s = live.pop(fr.rid, None)
            if s is None:
                report.error(
                    "R002",
                    f"step {idx}: free for request {fr.rid}, which holds "
                    f"no live allocation",
                    rid=fr.rid, step=idx,
                )
                continue
            slot_rid.pop(s["slot"], None)
            if s["emitted"] < 1:
                report.error(
                    "R007",
                    f"step {idx}: request {fr.rid} freed after 0 output "
                    f"tokens (every request produces at least the "
                    f"prefill token)",
                    rid=fr.rid, step=idx,
                )
            for b in fr.blocks:
                holder = owned.get(b)
                if holder != fr.rid:
                    report.error(
                        "R002",
                        f"step {idx}: request {fr.rid} frees block {b} "
                        f"{'it never owned' if holder is None else f'owned by request {holder}'} "
                        f"— double-free or cross-request free",
                        rid=fr.rid, step=idx, block=b,
                    )
                else:
                    del owned[b]

    for b in sorted(owned):
        report.error(
            "R001",
            f"block {b} of request {owned[b]} is never freed — leaked at "
            f"the end of the plan (last step "
            f"{plan.steps[-1].index if plan.steps else -1})",
            rid=owned[b], block=b,
        )
    for rid in sorted(live):
        report.error(
            "R001",
            f"request {rid} is still live at the end of the plan "
            f"(admitted in slot {live[rid]['slot']}, never finished)",
            rid=rid, slot=live[rid]["slot"],
        )
    if queued:
        report.info(
            "R005",
            f"{len(queued)} request(s) never admitted within the plan "
            f"(rids {sorted(queued)}) — truncated plan?",
            rids=sorted(queued),
        )
    report.metrics["serve_plan_steps"] = float(len(plan.steps))
    report.metrics["serve_plan_requests"] = float(len(plan.requests))
    report.metrics["serve_pool_blocks"] = float(usable)
    report.metrics["serve_peak_reserved_blocks"] = float(peak)
    report.metrics["serve_peak_pool_utilization"] = (
        peak / usable if usable > 0 else 0.0
    )
    report.metrics["serve_tokens_total"] = float(tokens_total)
    return report


def audit_serve_plan(
    trace: list[TraceRequest],
    scfg: ServeConfig,
    name: Optional[str] = None,
) -> Report:
    """Trace lint + scheduler replay + ledger check, composed.

    The pre-run gate behind ``launch/serve.py --analyze``: when the trace
    itself is illegal the lint findings are returned without attempting
    extraction (the scheduler would raise on submit).
    """
    report = lint_serve_trace(trace, scfg, name=name)
    if not report.ok:
        return report
    plan = extract_serve_plan(trace, scfg)
    return report.extend(check_serve_plan(plan, name=report.name))
