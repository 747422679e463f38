"""decode_step_ms.p50: the median of the engine's own step durations
(``ServeEngine.step_durations``) over the window's un-profiled steps that
carry no prefill chunk."""
import statistics

from portbench.metrics._serve import window_steps


def read(run):
    if run.kind != "serve":
        return None
    steps = window_steps(run, chunk=False)
    return 1e3 * statistics.median(s["dur"] for s in steps) if steps else None
