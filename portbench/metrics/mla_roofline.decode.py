"""mla_roofline.decode: the decode calls' latent-attention least time
(``lib.mla_work``: each live lane's rows to its length, every MLA layer,
the smaller of the absorbed and the expanded form's, the absorbed at
decode) over the device time of the paged MLA kernels (split and combine)
inside the profiled ``portbench.decode`` ranges."""
from portbench.lib import mla_work, peaks
from portbench.metrics._serve import matched


def read(run):
    pairs = matched(run, "decode")
    if not pairs or "v_dim" not in run.dims:
        return None
    d = run.dims
    least = dev = 0.0
    for step, ops in pairs:
        forms = mla_work.decode(d, step["lengths"])
        least += d["mla_layers"] * min(peaks.least_seconds(*f) for f in forms)
        dev += sum(e - s for n, s, e in ops
                   if any(k in n for k in mla_work.KERNELS)) / 1e6
    return 100.0 * least / dev if dev > 0 else None
