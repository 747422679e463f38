"""prefill_step_ms.p50: the median of the engine's step durations over the
window's un-profiled steps that carry a prefill chunk."""
import statistics

from portbench.metrics._serve import window_steps


def read(run):
    if run.kind != "serve":
        return None
    steps = window_steps(run, chunk=True)
    return 1e3 * statistics.median(s["dur"] for s in steps) if steps else None
