"""mla_ms.decode: device milliseconds a decode call of the kernels inside
the program's ``mla.attn`` ranges (each latent attention mixer:
projections, the latent entry's write, the paged kernel and ``o_proj``)
within the profiled ``portbench.decode`` calls (``_mla.ms_per_call``)."""
from portbench.metrics._mla import ms_per_call


def read(run):
    return ms_per_call(run, "decode")
