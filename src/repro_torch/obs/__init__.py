"""Runtime telemetry: the span/counter recorder.  The overlay, divergence
report and op replay are not ported yet (ROADMAP, ``--obs``)."""
from repro_torch.obs.record import Counter, Recorder, Span, SpanError  # noqa: F401
