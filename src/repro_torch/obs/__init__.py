"""repro_torch.obs — unified runtime telemetry: spans, counters, overlays, diffs.

The paper's claim is that an offline-profiled simulation predicts real
system timelines; this package makes that claim *inspectable* instead of a
single parity percentage.  Three pieces:

* :mod:`repro_torch.obs.record` — a structured span/counter recorder
  (:class:`Recorder`) with a monotonic clock, device/stage/request labels,
  nesting, and a zero-cost disabled mode.  The real executors — the train
  step loop (``launch/train.py``), the scheduled pipeline replay
  (:mod:`repro_torch.obs.replay`) and the :class:`~repro_torch.serve.engine.ServeEngine`
  host loop — emit spans under the *same node-uid vocabulary* the
  simulator's :class:`~repro_torch.core.graph.DataflowGraph` /
  :class:`~repro_torch.serve.policy.StepPlan` use, so a real run produces a
  timeline in the same schema as :class:`~repro_torch.core.simulator.SimResult`.

* :mod:`repro_torch.obs.overlay` — one Perfetto/Chrome JSON with aligned
  ``sim:`` and ``real:`` tracks per device, pricing provenance and byte
  twins as trace args, and counter tracks (in-flight microbatches, KV
  blocks, link concurrency).

* :mod:`repro_torch.obs.diff` — the divergence attributor: joins real spans to
  simulated intervals by uid and emits a ranked
  :class:`~repro_torch.analysis.Report` — per-op and per-provenance-class
  absolute/relative error, the top-k ops responsible for the step-time
  gap, and the O-code diagnostic family (O001 real span with no simulated
  twin, O002 simulated node never observed, O003 provenance-class error
  over tolerance).

:func:`~repro_torch.obs.record.prange` names a stretch of the program
for ``torch.profiler``: the train step's phases, the kernel ops'
gradients (plain VJPs, and flash attention's backward kernels), the paged
forward's gathers and head and the MoE FFN as host events with device-side
ranges, the serve engine's host loop as host events alone.  It costs a
flag read when no profiler runs.

Entry points: ``launch/train.py --pp 2 --obs --trace-out t.json`` and
``launch/serve.py --trace ... --obs --trace-out s.json``.  ``diff`` and
``overlay`` are copies of the JAX package's modules; ``replay`` re-executes
the ops on the port's logical-rank mesh (``repro_torch.dist.mesh``).
"""
from repro_torch.obs.diff import divergence_report  # noqa: F401
from repro_torch.obs.overlay import (  # noqa: F401
    derive_sim_counters,
    overlay_chrome_trace,
)
from repro_torch.obs.record import (  # noqa: F401
    Counter,
    Recorder,
    Span,
    SpanError,
    prange,
)
from repro_torch.obs.replay import replay_pipeline_ops  # noqa: F401
