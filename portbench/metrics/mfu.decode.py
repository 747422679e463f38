"""mfu.decode: the model FLOPs of the window's un-profiled decode-only steps
(``lib.work``: each live lane's token through the top-k experts, attention
over its length, its logits) over their engine durations, as a share of
the bf16 peak."""
from portbench.lib import peaks, work
from portbench.metrics._serve import window_steps


def read(run):
    if run.kind != "serve":
        return None
    steps = window_steps(run, chunk=False)
    if not steps:
        return None
    flops = sum(work.moe_decode_flops(run.dims, s["lengths"]) for s in steps)
    secs = sum(s["dur"] for s in steps)
    return 100.0 * flops / (secs * peaks.BF16_FLOPS)
