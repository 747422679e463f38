"""Continuous-batching serving engine over a paged KV pool.

The engine is a host loop around two device functions
(``repro_torch.serve.paged``): one prefill *chunk* (batch 1, pow2-bucketed
width) and one full-batch decode step (static batch = slots).  All
scheduling decisions — admission, block reservation, chunk selection, the
decode batch — come from :class:`repro_torch.serve.policy.ServeScheduler`,
the exact object the DES twin (``repro_torch.serve.sim``) drives, so a
simulated timeline replays the engine's step compositions verbatim.

Per-request latency is recorded against the *scheduler clock*: each step's
measured duration is accumulated into ``sched.clock``, and the clock
fast-forwards over idle gaps while waiting for open-loop arrivals (a trace
replay never sleeps).  Driving admission off accumulated measured time —
not raw wall time — means inter-step host overhead never drifts the
scheduling clock away from the recorded ``step_durations``, so
``repro_torch.serve.sim.replay_schedule(trace, cfg, engine.step_durations)``
reproduces the engine's step compositions AND its latency report exactly.

The greedy argmax readbacks (``int(...)`` for a final prefill chunk,
``.cpu()`` for the decode batch) synchronise the host with the card, as the
JAX engine's readbacks do, so a step's measured duration covers its device
work.  :meth:`ServeEngine.warmup` runs every function the engine can
dispatch once, so kernel builds and cuBLAS heuristics stay out of measured
steps.  Serving runs under ``torch.inference_mode()``.

A hybrid stack (Mamba-2 and attention mixers) keeps each slot's recurrent
state in the pool beside the KV blocks (``serve.paged``): the engine passes
a chunk's slot to the prefill and zeroes the slot's state when a request is
admitted to it (``state_resets`` counts them).

``mesh`` (``repro_torch.dist.mesh.make_mesh((n,), ("serve",), device)``)
slot-shards the decode batch as the JAX engine does (not a hybrid stack's:
its state pool is not sharded): params and pool
replicated, each of the ``n`` ranks decoding its contiguous ``slots // n``
lanes (``serve.paged.decode_slot_sharded``; the same tensors for ranks that
share a card, a copy for a rank on another), prefill replicated.  The step
log, the scheduler and the twins do not change.

:func:`splice_cache` is the JAX package's whole-cache helper for the
non-paged path; neither engine calls it.

While a ``torch.profiler`` runs, the host loop is named by host ranges
(``obs.record.prange(..., device=False)``: host events that leave the
device operations to a caller's range around the step or the paged call;
without a profiler each costs a flag read):

* ``serve.step`` — the whole :meth:`ServeEngine.step` call;
* ``serve.plan`` — ``plan_step`` and ``skip_to``: admission and batching;
* ``serve.inputs`` — the admitted slots' table writes, and each call's
  numpy tokens, lengths and tables with their device copies;
* ``serve.prefill`` / ``serve.decode`` — the call into the paged forward
  (``paged.prefill_chunk`` / ``decode_batch``, looked up on the module at
  each call, so a wrapper set on the module sees every call);
* ``serve.readback`` — the argmax and its ``int()`` or ``.cpu()``;
* ``serve.commit`` — ``sched.commit`` through finishing requests and the
  Recorder's counters.

The step's measured duration (``step_durations``) keeps its two clock
reads: the first ahead of ``serve.inputs``, the second inside
``serve.commit`` right after ``sched.commit``, where they were before the
ranges.  The paged forward's own ranges are ``paged.kv_gather``,
``paged.head`` and ``moe.ffn``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.models.build import Model, compute_params, to_device
from repro_torch.obs.record import Recorder, prange
from repro_torch.serve import paged
from repro_torch.serve.policy import ServeConfig, ServeScheduler, StepPlan


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int = 16
    arrival_s: float = 0.0       # open-loop arrival offset (trace replay)
    output: list[int] = field(default_factory=list)
    done: bool = False
    # latency record (virtual-clock seconds, filled by the engine)
    ttft_s: Optional[float] = None
    e2e_s: Optional[float] = None
    token_times_s: list[float] = field(default_factory=list)


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params,
        slots: int = 4,
        max_len: int = 256,
        eos_id: Optional[int] = None,
        block_size: int = 16,
        chunk: int = 32,
        num_blocks: int = 0,
        device="cuda",
        mesh=None,
        clock: Callable[[], float] = time.perf_counter,
        recorder: Optional[Recorder] = None,
    ):
        paged.check_family(model.cfg)
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.serve_cfg = ServeConfig(
            slots=slots, max_len=max_len, block_size=block_size,
            num_blocks=num_blocks, chunk=chunk,
        )
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.mesh = mesh
        if mesh is not None:
            if self.cfg.family == "hybrid" or self.cfg.is_mla:
                raise ValueError(
                    f"{self.cfg.name}: a slot-sharded engine does not serve "
                    f"the hybrid family or latent attention (its per-slot "
                    f"state or latent pool is not sharded)")
            paged.check_slot_sharding(slots, mesh)
        self.sched = ServeScheduler(self.serve_cfg)
        self.requests: dict[int, Request] = {}
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.finished: list[Request] = []
        # per-step records for the parity report / latency attribution
        self.step_log: list[tuple] = []
        self.step_durations: list[float] = []
        # slots whose recurrent state was zeroed at admission (hybrid stacks)
        self.state_resets = 0

        mb = self.serve_cfg.max_blocks_per_slot
        self._tables = np.full(
            (slots, mb), self.sched.scratch_block, np.int32
        )
        self.params = compute_params(to_device(params, self.device), self.cfg)
        self.pool = paged.init_pool(self.cfg, self.serve_cfg, self.device)
        self._replicas = (
            paged.replicas(self.params, self.pool, mesh)
            if mesh is not None else None
        )
        # duration source only — scheduling time is sched.clock (see module
        # docstring); injectable for deterministic tests.  Without a
        # recorder, a disabled one over the same clock measures each step
        # through exactly two clock reads.
        self._rec = (recorder if recorder is not None
                     else Recorder(enabled=False, clock=clock))
        self._clock = self._rec.clock

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _prefill(self, toks, start: int, width: int, row, slot=None):
        """One chunk through the paged forward; ``toks`` and ``row`` are
        device tensors (:meth:`_tensor`); ``slot``: the request's (None in
        the warm-up)."""
        if self._replicas is not None:
            return paged.prefill_replicated(
                self._replicas, toks, start, width, row,
                self.sched.scratch_block, self.cfg, self.serve_cfg,
            )
        return paged.prefill_chunk(
            self.params, self.pool, toks, start, width, row,
            self.sched.scratch_block, self.cfg, self.serve_cfg, slot=slot,
        )

    def _decode(self, toks, lengths, tables):
        """The decode batch through the paged forward; the inputs are
        device tensors (:meth:`_tensor`)."""
        if self._replicas is not None:
            return paged.decode_slot_sharded(
                self._replicas, toks, lengths, tables, self.cfg,
                self.serve_cfg, self.mesh,
            )
        return paged.decode_batch(
            self.params, self.pool, toks, lengths, tables, self.cfg,
            self.serve_cfg,
        )

    # -- warmup ----------------------------------------------------------------

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every function this engine can dispatch (decode, slot-sharded
        where the engine has a mesh, + all pow2 prefill buckets) once on
        throwaway inputs, with their readbacks, so
        first-call costs (kernel builds, library heuristics) never land
        inside a measured step.  The dummy tables point at the scratch
        block, whose contents are never read unmasked, and a hybrid stack's
        chunks run in the state pool's scratch lane, so no request state
        changes."""
        scfg = self.serve_cfg
        scratch = self.sched.scratch_block
        row = self._tensor(
            np.full((scfg.max_blocks_per_slot,), scratch, np.int32))
        bucket = 1
        while bucket <= scfg.chunk:
            toks = self._tensor(np.zeros((1, bucket), np.int32))
            logits, _ = self._prefill(toks, 0, bucket, row)
            int(torch.argmax(logits[0, -1]))
            bucket *= 2
        logits, _ = self._decode(
            self._tensor(np.zeros((self.slots, 1), np.int32)),
            self._tensor(np.zeros((self.slots,), np.int32)),
            self._tensor(np.full_like(self._tables, scratch)),
        )
        torch.argmax(logits[:, -1], dim=-1).cpu()

    # -- admission -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.sched.submit(
            req.rid, len(req.prompt), req.max_new_tokens, req.arrival_s
        )
        self.requests[req.rid] = req

    # -- one engine step -------------------------------------------------------

    def step(self) -> bool:
        """Execute one scheduler step; False if nothing can progress."""
        with prange("serve.step", device=False):
            with prange("serve.plan", device=False):
                plan = self.sched.plan_step()
                if plan.empty:
                    nxt = self.sched.next_arrival()
                    if nxt is None:
                        return False
                    # open-loop replay: jump the clock to the next arrival
                    # instead of sleeping through the gap
                    self.sched.skip_to(nxt)
                    plan = self.sched.plan_step()
                    if plan.empty:
                        return False
            with torch.inference_mode():
                self._execute(plan)
        return True

    def _execute(self, plan: StepPlan) -> None:
        rec = self._rec
        iv = rec.interval(
            f"step{plan.index}", "host", kind="serve-step", role="step"
        )
        scratch = self.sched.scratch_block
        with prange("serve.inputs", device=False):
            for rid, slot in plan.admitted:
                req = self.requests[rid]
                self.slot_req[slot] = req
                state = self.sched.slot_state(slot)
                if state is None:
                    raise RuntimeError(
                        f"step {plan.index}: request {rid} admitted to slot "
                        f"{slot} but the scheduler holds no slot state "
                        f"(statically detectable as R006)"
                    )
                blocks = state.blocks
                self._tables[slot] = scratch
                self._tables[slot, : len(blocks)] = blocks
                if "ssm" in self.pool:
                    paged.reset_slot_state(self.pool, slot)
                    self.state_resets += 1

        new_tokens: dict[int, int] = {}
        if plan.prefill is not None:
            pf = plan.prefill
            with prange("serve.inputs", device=False):
                req = self.slot_req[pf.slot]
                if req is None or req.rid != pf.rid:
                    held = ("no request" if req is None
                            else f"request {req.rid}")
                    raise RuntimeError(
                        f"step {plan.index}: prefill chunk targets request "
                        f"{pf.rid} in slot {pf.slot}, but the slot holds "
                        f"{held} (statically detectable as R006)"
                    )
                toks = np.zeros((1, pf.bucket), np.int32)
                end = pf.start + pf.width
                toks[0, : pf.width] = req.prompt[pf.start : end]
                t0 = rec.clock() if rec.enabled else 0.0
                toks_t = self._tensor(toks)
                row_t = self._tensor(self._tables[pf.slot])
            with prange("serve.prefill", device=False):
                logits, self.pool = self._prefill(
                    toks_t, pf.start, pf.width, row_t, pf.slot
                )
            with prange("serve.readback", device=False):
                if pf.final:
                    new_tokens[pf.slot] = int(torch.argmax(logits[0, -1]))
                if rec.enabled:
                    synchronize(self.device)
                    rec.emit(
                        f"step{plan.index}/prefill"
                        f"[r{pf.rid}@{pf.start}+{pf.width}]",
                        "chip", t0, rec.clock(), kind="prefill",
                        rid=pf.rid, slot=pf.slot, bucket=pf.bucket,
                    )

        eos_slots: set[int] = set()
        if plan.decode_slots:
            with prange("serve.inputs", device=False):
                toks = np.zeros((self.slots, 1), np.int32)
                lengths = np.zeros((self.slots,), np.int32)
                tables = np.full_like(self._tables, scratch)
                for s in plan.decode_slots:
                    req = self.slot_req[s]
                    state = self.sched.slot_state(s)
                    if req is None or state is None:
                        raise RuntimeError(
                            f"step {plan.index}: decode batch includes slot "
                            f"{s} with no admitted request (statically "
                            f"detectable as R006)"
                        )
                    toks[s, 0] = req.output[-1]
                    lengths[s] = state.length
                    tables[s] = self._tables[s]
                t0 = rec.clock() if rec.enabled else 0.0
                toks_t = self._tensor(toks)
                lengths_t = self._tensor(lengths)
                tables_t = self._tensor(tables)
            with prange("serve.decode", device=False):
                logits, self.pool = self._decode(toks_t, lengths_t, tables_t)
            with prange("serve.readback", device=False):
                nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
                if rec.enabled:
                    rec.emit(
                        f"step{plan.index}/decode[{len(plan.decode_slots)}]",
                        "chip", t0, rec.clock(), kind="decode",
                        slots=len(plan.decode_slots),
                    )
                for s in plan.decode_slots:
                    tok = int(nxt[s])
                    new_tokens[s] = tok
                    if self.eos_id is not None and tok == self.eos_id:
                        eos_slots.add(s)

        with prange("serve.commit", device=False):
            res = self.sched.commit(plan, frozenset(eos_slots))
            dur = iv.stop()
            self.sched.advance(dur)
            t_end = self.sched.clock
            self.step_log.append(plan.signature())
            self.step_durations.append(dur)
            for slot, tok in new_tokens.items():
                req = self.slot_req[slot]
                if req is None:
                    raise RuntimeError(
                        f"step {plan.index}: token produced for slot {slot} "
                        f"with no admitted request (statically detectable "
                        f"as R006)"
                    )
                req.output.append(tok)
                req.token_times_s.append(t_end)
                if len(req.output) == 1:
                    req.ttft_s = t_end - req.arrival_s
            for rid in res.finished:
                req = self.requests[rid]
                req.done = True
                req.e2e_s = t_end - req.arrival_s
                self.finished.append(req)
                for s, r in enumerate(self.slot_req):
                    if r is not None and r.rid == rid:
                        self.slot_req[s] = None
                        self._tables[s] = scratch
            if rec.enabled:
                rec.counter(
                    "kv_free_blocks", "chip", self.sched.allocator.num_free
                )
                rec.counter(
                    "live_slots", "chip",
                    sum(r is not None for r in self.slot_req),
                )

    def run_until_done(self, max_steps: int = 100_000) -> list[Request]:
        steps = 0
        while self.sched.outstanding():
            if not self.step():
                queued = [q.rid for q in self.sched.queue]
                live = [r.rid for r in self.slot_req if r is not None]
                raise RuntimeError(
                    f"serving stalled at step {len(self.step_log)} with "
                    f"work outstanding (queued requests {queued}, live "
                    f"requests {live})"
                )
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"serving did not converge within {max_steps} steps "
                    f"({len(self.finished)}/{len(self.requests)} requests "
                    f"finished)"
                )
        return self.finished


# -- cache splicing helpers ----------------------------------------------------


def _batch_axis(full, one) -> int:
    """First axis where the shapes differ (slots vs 1: the batch axis)."""
    for i, (f, o) in enumerate(zip(full.shape, one.shape)):
        if o != f:
            return i
    return 0


def splice_cache(full, one, slot: int):
    """Functional helper: write sequence-0 of ``one`` into slot ``slot`` of
    ``full`` (non-paged whole-cache path), leaf by leaf over dicts, lists
    and tuples; returns new tensors and leaves ``full`` unchanged.  As
    ``jax.lax.dynamic_update_slice``: ``one``'s leaf is written whole, cast
    to ``full``'s dtype, at ``slot`` along the batch axis and 0 along the
    others, each start clamped so that the leaf fits."""

    def leaf(f, o):
        ax = _batch_axis(f, o)
        at = [slice(0, n) for n in o.shape]
        start = min(max(slot, 0), f.shape[ax] - o.shape[ax])
        at[ax] = slice(start, start + o.shape[ax])
        out = f.clone()
        out[tuple(at)] = o.to(f.dtype)
        return out

    def walk(f, o):
        if isinstance(f, dict):
            return {k: walk(f[k], o[k]) for k in f}
        if isinstance(f, (list, tuple)):
            return type(f)(walk(a, b) for a, b in zip(f, o))
        return leaf(f, o)

    return walk(full, one)
