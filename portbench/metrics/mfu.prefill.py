"""mfu.prefill: the model FLOPs of the window's un-profiled steps that carry
a prefill chunk (the chunk's real tokens and the decode lanes beside it)
over their engine durations, as a share of the bf16 peak."""
from portbench.lib import peaks, work
from portbench.metrics._serve import window_steps


def read(run):
    if run.kind != "serve":
        return None
    steps = window_steps(run, chunk=True)
    if not steps:
        return None
    flops = 0.0
    for s in steps:
        _, _, start, width, _ = s["prefill"]
        flops += work.moe_prefill_flops(run.dims, start, width)
        flops += work.moe_decode_flops(run.dims, s["lengths"])
    secs = sum(s["dur"] for s in steps)
    return 100.0 * flops / (secs * peaks.BF16_FLOPS)
