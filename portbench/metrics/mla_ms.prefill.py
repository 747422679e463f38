"""mla_ms.prefill: device milliseconds a chunk call of the kernels inside
the program's ``mla.attn`` ranges (each latent attention mixer:
projections, the latent entry's write, the paged kernel and ``o_proj``)
within the profiled ``portbench.prefill`` calls (``_mla.ms_per_call``)."""
from portbench.metrics._mla import ms_per_call


def read(run):
    return ms_per_call(run, "prefill")
