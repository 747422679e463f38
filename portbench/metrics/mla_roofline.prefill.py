"""mla_roofline.prefill: the chunk calls' latent-attention least time
(``lib.mla_work``: the chunk's real tokens, each over its rows to its
position, every MLA layer, the smaller of the absorbed and the expanded
form's, the expanded at a long prefix) over the device time of the paged
MLA kernels inside the profiled ``portbench.prefill`` ranges."""
from portbench.lib import mla_work, peaks
from portbench.metrics._serve import matched


def read(run):
    pairs = matched(run, "prefill")
    if not pairs or "v_dim" not in run.dims:
        return None
    d = run.dims
    least = dev = 0.0
    for step, ops in pairs:
        _, _, start, width, _ = step["prefill"]
        forms = mla_work.prefill(d, start, width)
        least += d["mla_layers"] * min(peaks.least_seconds(*f) for f in forms)
        dev += sum(e - s for n, s, e in ops
                   if any(k in n for k in mla_work.KERNELS)) / 1e6
    return 100.0 * least / dev if dev > 0 else None
