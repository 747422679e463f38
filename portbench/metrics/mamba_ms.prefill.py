"""mamba_ms.prefill: device milliseconds a prefill chunk call of the
operations inside the program's ``mamba.mixer`` ranges within its
``serve.prefill`` ranges, over the profiled chunk calls."""
from portbench.metrics._ranges import ms_per_call


def read(run):
    return ms_per_call(run, "mamba.mixer", "serve.prefill")
