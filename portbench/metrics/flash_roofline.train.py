"""flash_roofline.train: the attention calls' least time (``lib.work``: the
encoder's, the decoder's causal and cross calls, each forward and each
recompute) over the device time of the flash kernels in the profiled train
steps."""
from portbench.lib import devtrace, peaks


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    dev = sum(e - s for n, s, e in t.kernels()
              if any(k in n for k in devtrace.FLASH_FORWARD)) / 1e6
    if dev <= 0:
        return None
    least = sum(peaks.least_seconds(f, b) for f, b in run.extra["flash_calls"])
    return 100.0 * least * run.extra["profiled_steps"] / dev
