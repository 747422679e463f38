"""moe_ms.prefill: device milliseconds a prefill chunk call of the
operations inside the program's ``moe.ffn`` ranges within its
``serve.prefill`` ranges, over the profiled chunk calls."""
from portbench.metrics._ranges import ms_per_call


def read(run):
    return ms_per_call(run, "moe.ffn", "serve.prefill")
