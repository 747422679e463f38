"""flash_roofline.prefill: the prefill chunks' attention least time
(``lib.work``: each real query over the keys up to its position, by layer)
over the device time of the flash kernels inside the profiled
``portbench.prefill`` ranges."""
from portbench.lib import devtrace, peaks, work
from portbench.metrics._serve import matched


def read(run):
    pairs = matched(run, "prefill")
    if not pairs:
        return None
    least = dev = 0.0
    for step, ops in pairs:
        _, _, start, width, _ = step["prefill"]
        least += sum(peaks.least_seconds(f, b) for f, b in
                     work.flash_prefill_calls(run.dims, start, width))
        dev += sum(e - s for n, s, e in ops
                   if any(k in n for k in devtrace.FLASH_FORWARD)) / 1e6
    return 100.0 * least / dev if dev > 0 else None
