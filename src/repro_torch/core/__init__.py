"""The paper's contribution: offline-profiling-based performance simulation.

Pipeline:  traced train step --(fx_graph)--> DataflowGraph
           --(estimator + ProfileDB)--> per-op durations
           --(simulator)--> makespan / timelines
"""
from repro_torch.core.database import ProfileDB, ProfileEntry  # noqa: F401
from repro_torch.core.estimator import OpTimeEstimator, fit_time_model  # noqa: F401
from repro_torch.core.fx_graph import graph_from_fx, step_summary  # noqa: F401
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
from repro_torch.core.newop import NewOpProfiler  # noqa: F401
from repro_torch.core.profiler import OfflineProfiler, calibrate_host  # noqa: F401
from repro_torch.core.simulator import SimResult, Simulator, simulate  # noqa: F401
