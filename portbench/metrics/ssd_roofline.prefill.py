"""ssd_roofline.prefill: the SSD scan's least time over its kernels' device
time inside the profiled ``portbench.prefill`` ranges.  Each call's least
time is ``lib.ssd_work.cost`` at the shapes the call hands the scan (one
sequence, the chunk's bucket padded to the scan's chunk; the run's
``dims``), and the calls are counted by their first kernel in the trace."""
from portbench.lib import peaks, ssd_work
from portbench.metrics._serve import matched


def read(run):
    pairs = matched(run, "prefill")
    if not pairs or "ssm_heads" not in run.dims:
        return None
    d = run.dims
    least = dev = 0.0
    for step, ops in pairs:
        width = step["prefill"][3]
        s = ssd_work.padded_len(width, run.extra["serve"]["chunk"],
                                d["chunk"])
        calls = sum(1 for n, _, _ in ops
                    if any(k in n for k in ssd_work.FIRST))
        least += calls * peaks.least_seconds(*ssd_work.cost(
            1, s, d["ssm_heads"], d["ssm_head_dim"], d["d_state"],
            d["ngroups"], d["chunk"]))
        dev += sum(e - s_ for n, s_, e in ops
                   if any(k in n for k in ssd_work.KERNELS)) / 1e6
    return 100.0 * least / dev if dev > 0 else None
