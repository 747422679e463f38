"""Serving pair: continuous-batching engine + its DES twin.

``engine``/``paged``/``blocks`` execute real tokens over a paged KV pool;
``policy`` is the scheduler both the engine and the simulator
(``sim``/``cost``) drive; ``trace``/``report`` are the shared workload and
latency vocabulary.
"""
from repro_torch.serve.engine import Request, ServeEngine, splice_cache  # noqa: F401
from repro_torch.serve.policy import ServeConfig, ServeScheduler  # noqa: F401
