"""head_ms.decode: device milliseconds a decode call of the operations
inside the program's ``paged.head`` range (the head's weight and its
logits, ``serve/paged.py::decode_batch``) within its ``serve.decode``
ranges."""
from portbench.metrics._ranges import ms_per_call


def read(run):
    return ms_per_call(run, "paged.head", "serve.decode")
