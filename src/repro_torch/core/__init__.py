"""The paper's contribution: offline-profiling-based performance simulation.

Pipeline:  traced train step --(fx_graph)--> DataflowGraph
           compiled HLO text --(hlo_parser)--> DataflowGraph
           --(estimator + ProfileDB)--> per-op durations
           --(simulator)--> makespan / timelines
           --(autotuner)--> best parallelization strategy

Both producers also give a module summary (``fx_graph.step_summary``,
``hlo_parser.module_summary``) that ``roofline.build_report`` turns into
compute, memory and collective terms.
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
from repro_torch.core.hlo_parser import (  # noqa: F401
    MeshInfo,
    module_summary,
    parse_module,
    to_graph,
)
from repro_torch.core.newop import NewOpProfiler  # noqa: F401
from repro_torch.core.profiler import OfflineProfiler, calibrate_host  # noqa: F401
from repro_torch.core.roofline import RooflineReport, build_report, model_flops  # noqa: F401
from repro_torch.core.simulator import SimResult, Simulator, simulate  # noqa: F401
from repro_torch.core.strategy import LayerCost, Strategy, pipeline_graph  # noqa: F401
from repro_torch.core.timeline import to_chrome_trace  # noqa: F401
from repro_torch.core.autotuner import Autotuner, TuneResult, layer_cost_from_config  # noqa: F401
