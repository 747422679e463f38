"""The paper's contribution, as far as the port has it: the ProfileDB, the
op-time estimator (DB hit -> analytic roofline; the learned stage waits for
ROADMAP A5), the dataflow graph and the discrete-event simulator."""
from repro_torch.core.database import ProfileDB, ProfileEntry  # noqa: F401
from repro_torch.core.estimator import OpTimeEstimator  # noqa: F401
from repro_torch.core.graph import DataflowGraph, OpNode  # noqa: F401
from repro_torch.core.hardware import (  # noqa: F401
    CPU_HOST,
    H100_SXM,
    PLATFORMS,
    TPU_V5E,
    collective_time,
    platform_for_device,
    wire_bytes,
)
from repro_torch.core.simulator import SimResult, Simulator, simulate  # noqa: F401
