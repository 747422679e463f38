"""mamba_ms.decode: device milliseconds a decode call of the operations inside
the program's ``mamba.mixer`` ranges (``serve/paged.py``: each Mamba
layer's mixer with its state read and write-back) within its
``serve.decode`` ranges, over the profiled decode calls."""
from portbench.metrics._ranges import ms_per_call


def read(run):
    return ms_per_call(run, "mamba.mixer", "serve.decode")
