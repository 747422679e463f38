"""Pipeline schedules as first-class step tables — the sim <-> real contract.

The paper claims dataflow simulation is accurate *because* it models "the
various parallelization strategies in a real system".  For pipeline
parallelism that is only true if the simulated schedule and the executed
schedule are the same object.  This module is that object: a
:class:`PipelineSchedule` emits an explicit per-stage table of
``(stage, vstage, microbatch, phase)`` :class:`Step` entries, and BOTH sides
consume it —

  * ``repro_torch.core.strategy.pipeline_graph`` turns the table into the
    simulator's DataflowGraph (data deps + per-device serialization edges),
  * ``repro_torch.dist.pp.pipeline_schedule_shard_map`` executes the table for
    real under ``shard_map``, with explicit scheduled backward steps and
    ppermute activation/grad exchanges.

Three schedules:

  * :class:`GPipeSchedule` — all forwards, flush, all backwards.
  * :class:`OneFOneBSchedule` — PipeDream-Flush: stage ``s`` warms up with
    ``min(M, S - s)`` forwards then alternates (bwd, fwd); the in-flight
    activation count never exceeds ``S - s``.
  * :class:`InterleavedOneFOneBSchedule` — Megatron-style interleaving:
    each device owns ``v`` model chunks (virtual stage ``k`` lives on device
    ``k % S``), shrinking the bubble from ``(S-1)*(tf+tb)`` to
    ``(S-1)*(tf+tb)/v`` at the price of ``v``x more boundary traffic.

Terminology: ``S`` pipeline devices (stages), ``M`` microbatches, ``v``
virtual stages (model chunks) per device, ``V = S*v`` total virtual stages.
Virtual stage ``k`` computes layers ``[k*L/V, (k+1)*L/V)`` and is placed on
device ``k % S`` — contiguous layer blocks round-robined over devices.

A copy of the JAX package's framework-neutral ``dist/schedules.py`` with
its imports rewritten; ``tests/test_torch_schedules.py`` holds every table
and twin identical to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

FWD = "fwd"
BWD = "bwd"


@dataclass(frozen=True)
class Step:
    """One unit of pipeline work: a fwd or bwd pass of one microbatch
    through one virtual stage, executed on device ``stage``."""

    stage: int        # executing device (pipeline rank), 0 <= stage < S
    vstage: int       # global virtual stage, 0 <= vstage < S*v
    microbatch: int   # 0 <= microbatch < M
    phase: str        # FWD | BWD

    @property
    def key(self) -> tuple:
        return (self.phase, self.vstage, self.microbatch)

    @property
    def name(self) -> str:
        tag = "F" if self.phase == FWD else "B"
        return f"{tag}{self.vstage}.{self.microbatch}"


class PipelineSchedule:
    """Base: subclasses implement :meth:`stage_steps` (per-device order)."""

    name = "base"

    def __init__(self, n_stages: int, n_microbatches: int, vstages: int = 1):
        if n_stages < 1 or n_microbatches < 1 or vstages < 1:
            raise ValueError(
                f"invalid schedule dims S={n_stages} M={n_microbatches} "
                f"v={vstages}"
            )
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.vstages = vstages

    # -- geometry -------------------------------------------------------------

    @property
    def n_vstages(self) -> int:
        return self.n_stages * self.vstages

    def device_of(self, vstage: int) -> int:
        return vstage % self.n_stages

    def chunk_of(self, vstage: int) -> int:
        """Local chunk index of a virtual stage on its device."""
        return vstage // self.n_stages

    def vstage_of(self, stage: int, chunk: int) -> int:
        return stage + chunk * self.n_stages

    # -- the step table -------------------------------------------------------

    def stage_steps(self, stage: int) -> list[Step]:
        """Execution order of device ``stage`` — subclass responsibility."""
        raise NotImplementedError

    def steps(self) -> list[Step]:
        """The global step table in simulated execution (tick) order."""
        order = self.tick_table()
        merged = [s for _, s in sorted(
            ((t, s) for s, t in order.items()),
            key=lambda ts: (ts[0], ts[1].stage),
        )]
        return merged

    def data_deps(self, step: Step) -> list[Step]:
        """Dataflow predecessors of a step (schedule-independent).

        fwd(k, m) needs fwd(k-1, m); bwd(k, m) needs fwd(k, m) and
        bwd(k+1, m).  The cross-device hop implied by a dep is realized as a
        collective-permute node in the simulator and a ppermute in the
        executor.
        """
        k, m = step.vstage, step.microbatch
        if step.phase == FWD:
            if k == 0:
                return []
            return [Step(self.device_of(k - 1), k - 1, m, FWD)]
        deps = [Step(step.stage, k, m, FWD)]
        if k < self.n_vstages - 1:
            deps.append(Step(self.device_of(k + 1), k + 1, m, BWD))
        return deps

    # -- validation -----------------------------------------------------------

    def validate(self) -> None:
        """Structural checks: complete, non-duplicated, dependency-closed.

        Dependency closure means the per-device sequences can be executed
        greedily without deadlock — every data dependency of a step is
        produced by an earlier step (the tick table exists).  Raises
        ValueError otherwise.
        """
        seen: set[tuple] = set()
        want = 2 * self.n_vstages * self.n_microbatches
        for s in range(self.n_stages):
            for step in self.stage_steps(s):
                if step.stage != s or self.device_of(step.vstage) != s:
                    raise ValueError(f"step {step} misplaced on device {s}")
                if not (0 <= step.microbatch < self.n_microbatches):
                    raise ValueError(f"step {step} microbatch out of range")
                if step.key in seen:
                    raise ValueError(f"duplicate step {step}")
                seen.add(step.key)
        if len(seen) != want:
            raise ValueError(
                f"incomplete table: {len(seen)} steps, expected {want}"
            )
        self.tick_table()  # raises on deadlock

    @cached_property
    def _ticks(self) -> dict[Step, int]:
        """Unit-time list schedule: tick of each step when every fwd/bwd
        costs one tick, comm is free, and devices respect table order.

        A step runs at ``max(prev step on device, data deps) + 1`` — exactly
        what the DES produces with unit durations, so
        ``total_ticks``/``bubble_ticks`` are the executor-side accounting
        twins of the simulated timeline.  Raises ValueError on deadlock
        (a table that is not dependency-closed).
        """
        queues = {s: list(self.stage_steps(s)) for s in range(self.n_stages)}
        pos = {s: 0 for s in range(self.n_stages)}
        free = {s: 0 for s in range(self.n_stages)}
        tick: dict[Step, int] = {}
        remaining = sum(len(q) for q in queues.values())
        while remaining:
            progressed = False
            for s in range(self.n_stages):
                if pos[s] >= len(queues[s]):
                    continue
                step = queues[s][pos[s]]
                deps = self.data_deps(step)
                if any(d not in tick for d in deps):
                    continue
                t = max(
                    [free[s]] + [tick[d] + 1 for d in deps]
                )
                tick[step] = t
                free[s] = t + 1
                pos[s] += 1
                remaining -= 1
                progressed = True
            if not progressed:
                stuck = [
                    queues[s][pos[s]] for s in range(self.n_stages)
                    if pos[s] < len(queues[s])
                ]
                raise ValueError(
                    f"schedule deadlock: {self.name} S={self.n_stages} "
                    f"M={self.n_microbatches} v={self.vstages}, "
                    f"stuck at {stuck[:4]}"
                )
        return tick

    def tick_table(self) -> dict[Step, int]:
        return dict(self._ticks)

    # -- accounting twins ------------------------------------------------------

    def total_ticks(self) -> int:
        """Unit-time makespan — equals the DES makespan at tf=tb=1, comm=0."""
        return max(self._ticks.values()) + 1

    def bubble_ticks(self, stage: int) -> int:
        """Idle ticks of one device over the whole step (unit durations)."""
        return self.total_ticks() - len(self.stage_steps(stage))

    def analytic_bubble_ticks(self) -> int:
        """Ideal per-device bubble: ``(S-1) * (tf_chunk + tb_chunk)`` ticks.

        In full-stage time units (one stage = v chunks) this is the classic
        ``(S-1)/v * (t_fwd + t_bwd)`` — interleaving divides the bubble by
        the virtual-stage count.
        """
        return 2 * (self.n_stages - 1)

    def max_in_flight(self, stage: int) -> int:
        """Peak count of forward activations a device holds live: the number
        of fwd steps executed minus bwd steps executed, maximized over every
        prefix of the device's sequence."""
        live = peak = 0
        for step in self.stage_steps(stage):
            live += 1 if step.phase == FWD else -1
            peak = max(peak, live)
        return peak

    def comm_steps(self) -> int:
        """Number of cross-stage hops the table schedules, per direction:
        every microbatch crosses each of the ``V - 1`` virtual-stage
        boundaries once forward and once backward."""
        return (self.n_vstages - 1) * self.n_microbatches

    def comm_bytes(self, hop_bytes: float) -> float:
        """Total scheduled boundary traffic (activations fwd + grads bwd).

        The byte-accounting twin of both the simulator's collective-permute
        nodes and the executor's useful ppermute payloads — asserted equal in
        tests/test_schedule_parity.py.
        """
        return 2.0 * self.comm_steps() * hop_bytes

    def describe(self) -> str:
        return (
            f"{self.name}(S={self.n_stages},M={self.n_microbatches}"
            + (f",v={self.vstages}" if self.vstages > 1 else "")
            + ")"
        )


class GPipeSchedule(PipelineSchedule):
    """All forwards, full flush, all backwards."""

    name = "gpipe"

    def __init__(self, n_stages, n_microbatches, vstages=1):
        if vstages != 1:
            raise ValueError("gpipe does not interleave; vstages must be 1")
        super().__init__(n_stages, n_microbatches, vstages)

    def stage_steps(self, stage: int) -> list[Step]:
        M = self.n_microbatches
        fwd = [Step(stage, stage, m, FWD) for m in range(M)]
        bwd = [Step(stage, stage, m, BWD) for m in range(M)]
        return fwd + bwd


class OneFOneBSchedule(PipelineSchedule):
    """PipeDream-Flush / non-interleaved 1F1B.

    Stage ``s`` warms up with ``w = min(M, S - s)`` forwards, then runs
    (bwd, fwd) pairs until forwards are exhausted, then drains backwards.
    The in-flight bound ``<= S - s`` is the classic memory window — tested
    in tests/test_schedules.py.
    """

    name = "1f1b"

    def __init__(self, n_stages, n_microbatches, vstages=1):
        if vstages != 1:
            raise ValueError(
                "1f1b is the v=1 schedule; use interleaved_1f1b for v>1"
            )
        super().__init__(n_stages, n_microbatches, vstages)

    def stage_steps(self, stage: int) -> list[Step]:
        S, M = self.n_stages, self.n_microbatches
        w = min(M, S - stage)
        out = [Step(stage, stage, m, FWD) for m in range(w)]
        for i in range(M - w):
            out.append(Step(stage, stage, i, BWD))
            out.append(Step(stage, stage, w + i, FWD))
        for i in range(M - w, M):
            out.append(Step(stage, stage, i, BWD))
        return out


class InterleavedOneFOneBSchedule(PipelineSchedule):
    """Megatron-LM interleaved 1F1B over ``v`` model chunks per device.

    Microbatches are processed in groups of ``S``; within a group a device
    runs chunk 0 for all S microbatches, then chunk 1, ...  Device ``s``
    warms up with ``2*(S - s - 1) + (v - 1)*S`` forwards (capped at the
    ``M*v`` total), runs 1F1B pairs, then drains.  Requires ``M % S == 0``
    (the Megatron constraint that keeps the steady state stall-free).
    """

    name = "interleaved_1f1b"

    def __init__(self, n_stages, n_microbatches, vstages=2):
        super().__init__(n_stages, n_microbatches, vstages)
        if n_microbatches % n_stages != 0:
            raise ValueError(
                f"interleaved_1f1b needs microbatches ({n_microbatches}) "
                f"divisible by stages ({n_stages})"
            )

    def _fwd_at(self, stage: int, i: int) -> Step:
        S, v = self.n_stages, self.vstages
        group, within = divmod(i, S * v)
        chunk, lane = divmod(within, S)
        return Step(stage, self.vstage_of(stage, chunk), group * S + lane, FWD)

    def _bwd_at(self, stage: int, i: int) -> Step:
        S, v = self.n_stages, self.vstages
        group, within = divmod(i, S * v)
        chunk, lane = divmod(within, S)
        return Step(
            stage, self.vstage_of(stage, v - 1 - chunk), group * S + lane, BWD
        )

    def stage_steps(self, stage: int) -> list[Step]:
        S, M, v = self.n_stages, self.n_microbatches, self.vstages
        total = M * v
        warm = min(total, 2 * (S - stage - 1) + (v - 1) * S)
        out = [self._fwd_at(stage, i) for i in range(warm)]
        for i in range(total - warm):
            out.append(self._fwd_at(stage, warm + i))
            out.append(self._bwd_at(stage, i))
        for i in range(total - warm, total):
            out.append(self._bwd_at(stage, i))
        return out


SCHEDULES = {
    GPipeSchedule.name: GPipeSchedule,
    OneFOneBSchedule.name: OneFOneBSchedule,
    InterleavedOneFOneBSchedule.name: InterleavedOneFOneBSchedule,
}


def make_schedule(
    name: str, n_stages: int, n_microbatches: int, vstages: int = 1
) -> PipelineSchedule:
    """Factory keyed by ``Strategy.schedule`` names."""
    try:
        cls = SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown pipeline schedule {name!r}; options: {sorted(SCHEDULES)}"
        ) from None
    return cls(n_stages, n_microbatches, vstages)


# ---------------------------------------------------------------------------
# Executor plan: the step table compiled to SPMD-indexable tick arrays
# ---------------------------------------------------------------------------

NOOP, DO_FWD, DO_BWD, DO_BWD_LAST = 0, 1, 2, 3


@dataclass(frozen=True)
class ExecutorPlan:
    """The schedule lowered to dense ``[n_ticks][n_stages]`` arrays.

    ``pipeline_schedule_shard_map`` runs one tick per entry: every device
    looks up its ``action``/``chunk``/``microbatch`` row, the ppermute
    receive descriptors say which (chunk, microbatch) slot an incoming
    activation/cotangent belongs to, and ``is_last``/``is_first`` mark
    loss-seeding and input-feeding steps.  The backward of the last virtual
    stage is its own action (``DO_BWD_LAST``) so only that branch pays the
    loss vjp.  All entries are plain ints so the arrays can be closed over
    as constants inside jit.
    """

    schedule: PipelineSchedule
    n_ticks: int
    action: list[list[int]]          # NOOP | DO_FWD | DO_BWD | DO_BWD_LAST
    chunk: list[list[int]]           # local chunk of the step (0 if noop)
    microbatch: list[list[int]]
    is_first: list[list[int]]        # step's vstage == 0 (reads xs)
    is_last: list[list[int]]         # step's vstage == V-1 (loss boundary)
    sends_fwd: list[list[int]]       # fwd step whose output hops to s+1
    sends_bwd: list[list[int]]       # bwd step whose cotangent hops to s-1
    recv_fwd_valid: list[list[int]]  # incoming fwd ppermute is meaningful
    recv_fwd_chunk: list[list[int]]
    recv_fwd_mb: list[list[int]]
    recv_bwd_valid: list[list[int]]
    recv_bwd_chunk: list[list[int]]
    recv_bwd_mb: list[list[int]]

    def comm_steps(self) -> int:
        """Useful hops per direction — must equal schedule.comm_steps()."""
        fwd = sum(map(sum, self.sends_fwd))
        bwd = sum(map(sum, self.sends_bwd))
        if fwd != bwd:
            raise ValueError(
                f"{self.schedule.describe()}: asymmetric executor plan — "
                f"{fwd} fwd sends vs {bwd} bwd sends"
            )
        return fwd

    def comm_bytes(self, hop_bytes: float) -> float:
        """Executor-side accounting twin of ``schedule.comm_bytes``."""
        return 2.0 * self.comm_steps() * hop_bytes


def build_executor_plan(schedule: PipelineSchedule) -> ExecutorPlan:
    schedule.validate()
    S, V = schedule.n_stages, schedule.n_vstages
    ticks = schedule.tick_table()
    T = schedule.total_ticks()

    def grid(fill=0):
        return [[fill] * S for _ in range(T)]

    action, chunk, mb = grid(NOOP), grid(), grid()
    first, last = grid(), grid()
    sf, sb = grid(), grid()
    rfv, rfc, rfm = grid(), grid(), grid()
    rbv, rbc, rbm = grid(), grid(), grid()

    for step, t in ticks.items():
        s, k, m = step.stage, step.vstage, step.microbatch
        if step.phase == FWD:
            action[t][s] = DO_FWD
        else:
            action[t][s] = DO_BWD_LAST if k == V - 1 else DO_BWD
        chunk[t][s] = schedule.chunk_of(k)
        mb[t][s] = m
        first[t][s] = int(k == 0)
        last[t][s] = int(k == V - 1)
        if step.phase == FWD and k < V - 1:
            sf[t][s] = 1
            # arrives on device (s+1)%S at tick t+1, for chunk of vstage k+1
            dst, at = (s + 1) % S, t + 1
            if at >= T:
                raise ValueError(
                    f"{schedule.describe()}: fwd send of {step.name} at "
                    f"tick {t} lands after the final tick ({T})"
                )
            if rfv[at][dst]:
                raise ValueError(
                    f"{schedule.describe()}: fwd receive collision on "
                    f"stage {dst} at tick {at} (sender {step.name})"
                )
            rfv[at][dst] = 1
            rfc[at][dst] = schedule.chunk_of(k + 1)
            rfm[at][dst] = m
        if step.phase == BWD and k > 0:
            sb[t][s] = 1
            dst, at = (s - 1) % S, t + 1
            if at >= T:
                raise ValueError(
                    f"{schedule.describe()}: bwd send of {step.name} at "
                    f"tick {t} lands after the final tick ({T})"
                )
            if rbv[at][dst]:
                raise ValueError(
                    f"{schedule.describe()}: bwd receive collision on "
                    f"stage {dst} at tick {at} (sender {step.name})"
                )
            rbv[at][dst] = 1
            rbc[at][dst] = schedule.chunk_of(k - 1)
            rbm[at][dst] = m

    return ExecutorPlan(
        schedule=schedule, n_ticks=T,
        action=action, chunk=chunk, microbatch=mb,
        is_first=first, is_last=last,
        sends_fwd=sf, sends_bwd=sb,
        recv_fwd_valid=rfv, recv_fwd_chunk=rfc, recv_fwd_mb=rfm,
        recv_bwd_valid=rbv, recv_bwd_chunk=rbc, recv_bwd_mb=rbm,
    )
