"""Measured collective time models: the fitted models and the pricing chain
(exact DB hit -> fitted CollectiveModel -> ring fallback).  The sweep that
measures them is not ported yet (ROADMAP, A14)."""
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
