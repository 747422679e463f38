"""moe_ms.decode: device milliseconds a decode call of the operations inside
the program's ``moe.ffn`` ranges (``models/moe.py::moe_ffn``, routing to
combine) within its ``serve.decode`` ranges, over the profiled decode
calls."""
from portbench.metrics._ranges import ms_per_call


def read(run):
    return ms_per_call(run, "moe.ffn", "serve.decode")
