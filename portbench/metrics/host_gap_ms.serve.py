"""host_gap_ms.serve: the mean wall time on the harness's clock between one
engine step's return and the next step's call, over consecutive un-profiled
steps of the window with work still pending in between."""
from portbench.metrics._serve import window_steps


def read(run):
    if run.kind != "serve":
        return None
    steps = window_steps(run)
    gaps = [b["start"] - a["end"] for a, b in zip(steps, steps[1:])
            if a["pending_after"]]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
