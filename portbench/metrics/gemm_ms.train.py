"""gemm_ms.train: device milliseconds a train step of the library's matrix
products (the ``gemm`` kinds of the frozen ``KERNEL_KINDS``)."""
from portbench.lib import devtrace


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    ms = sum(e - s for n, s, e in t.kernels()
             if devtrace.kind_of(n).startswith("gemm"))
    if ms <= 0:
        return None
    return 1e-3 * ms / run.extra["profiled_steps"]
