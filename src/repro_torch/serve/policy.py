"""Continuous-batching admission/scheduling policy — shared executor/sim.

Phantora's (PAPERS.md) argument for trustworthy simulators is *code
sharing*: the decisions that shape a timeline must come from the same
implementation on both sides.  :class:`ServeScheduler` is that shared
piece: the real engine (``repro_torch.serve.engine``) and the DES twin
(``repro_torch.serve.sim``) both drive one scheduler instance and execute the
:class:`StepPlan` it emits — the engine with jitted paged-attention calls,
the twin with priced durations.  Identical request sequences therefore
produce identical step counts and batch compositions, asserted step-for-
step by ``serve_parity_report``.

Policy (deterministic, FIFO, no preemption):

* **admission** — the head of the arrival queue is admitted to the
  lowest-id idle slot once it has arrived (``arrival_s <= clock``) and the
  block pool can cover its *worst-case* cache footprint (static
  reservation: ``prompt_len + max_tokens - 1`` positions, so a mid-flight
  request can never strand the pool; head-of-line blocking is intentional
  — reordering would make composition parity depend on timing);
* **chunked prefill** — one prompt chunk per engine step, lowest prefill
  slot first, interleaved with the decode batch of every decoding slot;
* **decode** — all decoding slots advance one token per step (the jitted
  decode batch has static shape, so a step's cost does not depend on how
  many slots are live);
* **completion** — token-count based (``max_tokens`` capped to the KV
  capacity ``max_len - prompt_len + 1``).  EOS early-exit is an
  engine-side event reported through ``commit(..., eos_slots=...)``; the
  twin cannot predict token *values*, so parity traces leave EOS unset.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.serve.blocks import BlockAllocator, blocks_for_tokens


@dataclass(frozen=True)
class ServeConfig:
    """Engine/sim-shared serving shape parameters."""

    slots: int = 4
    max_len: int = 256
    block_size: int = 16
    num_blocks: int = 0          # 0 -> slots * blocks(max_len) + 1 scratch
    chunk: int = 32              # max prefill tokens per engine step

    def __post_init__(self):
        if self.slots < 1 or self.max_len < 2 or self.chunk < 1:
            raise ValueError(f"degenerate serve config {self}")
        if self.block_size < 1 or self.block_size > self.max_len:
            raise ValueError(
                f"block_size {self.block_size} outside [1, {self.max_len}]"
            )

    @property
    def max_blocks_per_slot(self) -> int:
        return blocks_for_tokens(self.max_len, self.block_size)

    @property
    def view_len(self) -> int:
        """Padded KV view width of the gathered per-slot cache."""
        return self.max_blocks_per_slot * self.block_size

    def resolved_num_blocks(self) -> int:
        """Pool size: explicit, or every slot full-length + 1 scratch."""
        if self.num_blocks:
            return self.num_blocks
        return self.slots * self.max_blocks_per_slot + 1

    def bucket(self, width: int) -> int:
        """Pow2 chunk bucket (caps jit retraces at log2(chunk) variants).

        Shared by the scheduler and the static coverage auditor
        (``repro_torch.analysis.coverage``): the distinct prefill queries a trace
        will issue are fully determined by this function and the prompt
        lengths, which is what makes ProfileDB coverage checkable offline.
        """
        b = 1
        while b < width:
            b *= 2
        return min(b, self.chunk)

    def effective_max_tokens(self, prompt_len: int, max_tokens: int) -> int:
        """Output-token budget capped to KV capacity.

        The cache holds ``max_len`` positions; prefill writes
        ``prompt_len`` of them and every decode step writes exactly one
        more, so at most ``max_len - prompt_len`` decode steps fit — plus
        the prefill-produced first token gives ``max_len - prompt_len + 1``
        output tokens.  (The seed engine set the slot length to the padded
        bucket at admission and clamped at ``max_len - 1``, repeating the
        final cache position — the off-by-one the boundary regression test
        in tests/test_serve_engine.py pins down.)
        """
        return max(1, min(max_tokens, self.max_len - prompt_len + 1))


@dataclass(frozen=True)
class PrefillChunk:
    slot: int
    rid: int
    start: int       # first prompt position of this chunk
    width: int       # real prompt tokens in this chunk
    bucket: int      # padded (jit-traced) chunk width, >= width
    final: bool      # does this chunk finish the prompt?


@dataclass(frozen=True)
class StepPlan:
    """One engine step's worth of scheduling decisions."""

    index: int
    admitted: tuple[tuple[int, int], ...]       # (rid, slot)
    prefill: Optional[PrefillChunk]
    decode_slots: tuple[int, ...]

    @property
    def empty(self) -> bool:
        return not (self.admitted or self.prefill or self.decode_slots)

    def signature(self) -> tuple:
        """Hashable composition record compared by the parity report."""
        pf = None
        if self.prefill is not None:
            p = self.prefill
            pf = (p.slot, p.rid, p.start, p.width, p.final)
        return (self.index, self.admitted, pf, self.decode_slots)


@dataclass
class _Slot:
    rid: int
    prompt_len: int
    max_tokens: int              # effective (capacity-capped) budget
    blocks: list[int]
    pos: int = 0                 # prefill progress (prompt tokens cached)
    length: int = 0              # cache positions written (decode phase)
    emitted: int = 0             # output tokens produced
    phase: str = "prefill"       # "prefill" | "decode"


@dataclass
class _Queued:
    rid: int
    prompt_len: int
    max_tokens: int
    arrival_s: float = 0.0
    submit_order: int = 0


@dataclass
class TokenEvent:
    """One output token attributed to a request (filled by commit)."""

    rid: int
    first: bool
    done: bool


@dataclass
class CommitResult:
    tokens: list[TokenEvent] = field(default_factory=list)
    finished: list[int] = field(default_factory=list)    # rids


class ServeScheduler:
    """Deterministic continuous-batching policy over a block pool."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.allocator = BlockAllocator(
            cfg.resolved_num_blocks(), cfg.block_size
        )
        # block 0 is the scratch block: inactive decode lanes write there
        # and unallocated block-table entries point there, so the device
        # kernels never need data-dependent control flow
        (self.scratch_block,) = self.allocator.alloc(1, "__scratch__")
        self.queue: list[_Queued] = []
        self.slots: list[Optional[_Slot]] = [None] * cfg.slots
        self.clock = 0.0
        self.step_index = 0
        self._submitted = 0

    # -- intake ----------------------------------------------------------------

    def submit(
        self, rid: int, prompt_len: int, max_tokens: int, arrival_s: float = 0.0
    ) -> None:
        if prompt_len < 1:
            raise ValueError(f"request {rid}: empty prompt")
        if prompt_len > self.cfg.max_len:
            raise ValueError(
                f"request {rid}: prompt_len {prompt_len} exceeds engine "
                f"max_len {self.cfg.max_len}"
            )
        needed = blocks_for_tokens(
            self._reserved_positions(prompt_len, max_tokens),
            self.cfg.block_size,
        )
        if needed > self.allocator.num_blocks - 1:  # -1: scratch
            raise ValueError(
                f"request {rid} needs {needed} blocks, pool holds "
                f"{self.allocator.num_blocks - 1}"
            )
        self.queue.append(
            _Queued(rid, prompt_len,
                    self.cfg.effective_max_tokens(prompt_len, max_tokens),
                    arrival_s, self._submitted)
        )
        self._submitted += 1
        # FIFO in (arrival, submit order): open-loop traces arrive sorted,
        # but direct submit() calls may not
        self.queue.sort(key=lambda q: (q.arrival_s, q.submit_order))

    def _reserved_positions(self, prompt_len: int, max_tokens: int) -> int:
        eff = self.cfg.effective_max_tokens(prompt_len, max_tokens)
        return prompt_len + eff - 1

    # -- queries ---------------------------------------------------------------

    def outstanding(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def next_arrival(self) -> Optional[float]:
        future = [q.arrival_s for q in self.queue if q.arrival_s > self.clock]
        return min(future) if future else None

    def slot_state(self, slot: int) -> Optional[_Slot]:
        return self.slots[slot]

    def advance(self, dt: float) -> None:
        self.clock += dt

    def skip_to(self, t: float) -> None:
        self.clock = max(self.clock, t)

    # -- the policy ------------------------------------------------------------

    def plan_step(self) -> StepPlan:
        """Admit, pick a prefill chunk, gather the decode batch.

        Admission mutates scheduler state (slot assignment + block
        reservation); token-level progress happens in :meth:`commit` after
        the engine/twin has executed the plan.
        """
        admitted: list[tuple[int, int]] = []
        for slot in range(self.cfg.slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            head = self.queue[0]
            if head.arrival_s > self.clock:
                break  # FIFO: later requests must not jump an unarrived head
            needed = blocks_for_tokens(
                head.prompt_len + head.max_tokens - 1, self.cfg.block_size
            )
            if not self.allocator.can_alloc(needed):
                break  # head-of-line blocking, by design
            self.queue.pop(0)
            blocks = self.allocator.alloc(needed, head.rid)
            self.slots[slot] = _Slot(
                rid=head.rid, prompt_len=head.prompt_len,
                max_tokens=head.max_tokens, blocks=blocks,
            )
            admitted.append((head.rid, slot))

        prefill: Optional[PrefillChunk] = None
        for slot in range(self.cfg.slots):
            s = self.slots[slot]
            if s is not None and s.phase == "prefill":
                width = min(self.cfg.chunk, s.prompt_len - s.pos)
                prefill = PrefillChunk(
                    slot=slot, rid=s.rid, start=s.pos, width=width,
                    bucket=self.cfg.bucket(width),
                    final=s.pos + width >= s.prompt_len,
                )
                break

        decode_slots = tuple(
            i for i, s in enumerate(self.slots)
            if s is not None and s.phase == "decode"
        )
        plan = StepPlan(
            index=self.step_index, admitted=tuple(admitted),
            prefill=prefill, decode_slots=decode_slots,
        )
        if not plan.empty:
            self.step_index += 1
        return plan

    # -- progress --------------------------------------------------------------

    def commit(
        self, plan: StepPlan, eos_slots: frozenset[int] = frozenset()
    ) -> CommitResult:
        """Advance per-slot progress for an executed plan.

        ``eos_slots``: decode slots whose *new* token was EOS (engine-side
        knowledge; the DES twin always passes the empty set).
        """
        out = CommitResult()
        if plan.prefill is not None:
            s = self.slots[plan.prefill.slot]
            if s is None or s.rid != plan.prefill.rid:
                raise ValueError(
                    f"step {plan.index}: prefill chunk targets request "
                    f"{plan.prefill.rid} in slot {plan.prefill.slot}, but the "
                    f"slot holds "
                    f"{'no request' if s is None else f'request {s.rid}'} "
                    f"(statically detectable as R006)"
                )
            s.pos += plan.prefill.width
            if plan.prefill.final:
                s.phase = "decode"
                s.length = s.prompt_len
                s.emitted = 1
                done = s.emitted >= s.max_tokens
                out.tokens.append(TokenEvent(s.rid, first=True, done=done))
                if done:
                    self._finish(plan.prefill.slot, plan.index, out)
        for slot in plan.decode_slots:
            s = self.slots[slot]
            if s is None or s.phase != "decode":
                raise ValueError(
                    f"step {plan.index}: decode batch includes slot {slot}, "
                    f"which holds "
                    f"{'no request' if s is None else f'request {s.rid} still in {s.phase}'} "
                    f"(statically detectable as R006)"
                )
            s.length += 1
            s.emitted += 1
            done = s.emitted >= s.max_tokens or slot in eos_slots
            out.tokens.append(TokenEvent(s.rid, first=False, done=done))
            if done:
                self._finish(slot, plan.index, out)
        return out

    def _finish(self, slot: int, step_index: int, out: CommitResult) -> None:
        s = self.slots[slot]
        if s is None:
            raise ValueError(
                f"step {step_index}: cannot finish slot {slot}: no request "
                f"admitted (statically detectable as R006)"
            )
        self.allocator.free_owner(s.rid)
        self.slots[slot] = None
        out.finished.append(s.rid)
