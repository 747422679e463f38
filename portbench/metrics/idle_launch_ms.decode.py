"""idle_launch_ms.decode: the mean, over the profiled decode-only steps (a
host ``serve.step`` holding a ``serve.decode`` and no ``serve.prefill``),
of the time the device runs no operation while the host is inside the
step's ``serve.decode`` range: the device waiting on the paged forward's
launches."""
from portbench.metrics._ranges import decode_step_idle, mean_of


def read(run):
    return mean_of(decode_step_idle(run), 1)
