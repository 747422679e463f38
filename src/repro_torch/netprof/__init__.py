"""Offline interconnect profiling (netprof): measured collective time models.

The paper's offline-profiling thesis applied to the network half of the
simulator: a host runs the sweep harness once (``repro_torch.netprof.sweep``;
``python -m repro_torch.netprof.calibrate``), the measurements land in the
ordinary :class:`repro_torch.core.database.ProfileDB`, and every later
simulation on that host prices collectives through the measured chain

    exact DB hit  ->  fitted CollectiveModel  ->  ring fallback

(:class:`repro_torch.netprof.pricing.CollectivePricer`, wired into
``repro_torch.core.estimator.OpTimeEstimator``).  The sweep runs over a mesh
of logical ranks: on one card it measures collectives among ranks that
share the card, which its DB stamps.
"""
from repro_torch.netprof.model import (  # noqa: F401
    COLLECTIVES,
    CollectiveModel,
    fit_collective_models,
)
from repro_torch.netprof.pricing import (  # noqa: F401
    PROV_DB,
    PROV_FIT,
    PROV_NOOP,
    PROV_RING,
    CollectivePricer,
    graph_provenance,
)
from repro_torch.netprof.sweep import SweepConfig, mesh_plans, sweep_collectives  # noqa: F401
