"""kv_gather_ms.decode: device milliseconds a decode call of the operations
inside the program's ``paged.kv_gather`` ranges (the gathers of each
layer's K and V view through the block tables,
``serve/paged.py::_paged_attention``) within its ``serve.decode`` ranges."""
from portbench.metrics._ranges import ms_per_call


def read(run):
    return ms_per_call(run, "paged.kv_gather", "serve.decode")
