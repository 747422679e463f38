"""idle_engine_ms.decode: the mean, over the profiled decode-only steps (a
host ``serve.step`` holding a ``serve.decode`` and no ``serve.prefill``),
of the time the device runs no operation while the host is inside the
step's ``serve.step`` range but outside its ``serve.decode``: the device
waiting on the engine's planning, inputs, readback and commit."""
from portbench.metrics._ranges import decode_step_idle, mean_of


def read(run):
    return mean_of(decode_step_idle(run), 0)
