"""flash_roofline.decode: the decode calls' attention least time (``lib.work``:
each live lane's keys up to its length, by layer) over the device time of
the flash kernels (split and combine) inside the profiled
``portbench.decode`` ranges."""
from portbench.lib import devtrace, peaks, work
from portbench.metrics._serve import matched


def read(run):
    pairs = matched(run, "decode")
    if not pairs:
        return None
    least = dev = 0.0
    for step, ops in pairs:
        least += sum(peaks.least_seconds(f, b) for f, b in
                     work.flash_decode_calls(run.dims, step["lengths"]))
        dev += sum(e - s for n, s, e in ops
                   if any(k in n for k in devtrace.FLASH_FORWARD)) / 1e6
    return 100.0 * least / dev if dev > 0 else None
