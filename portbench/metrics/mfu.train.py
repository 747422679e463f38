"""mfu.train: the whole train step's model FLOPs (``lib.work``, recomputation
not counted) over the step time of the window's un-profiled steps, as a
share of the bf16 peak."""
from portbench.lib import peaks


def read(run):
    if run.kind != "train":
        return None
    x = run.extra
    return 100.0 * x["step_flops"] / (x["step_s"] * peaks.BF16_FLOPS)
