"""Executable parallelization primitives (the real side of the sim-vs-real
loop), the torch counterpart of the JAX package's ``repro.dist``:

  * :mod:`repro_torch.dist.mesh`      — a mesh of logical ranks with named
    axes, each bound to a device, and the collectives over an axis
    (``psum``, ``pmean``, ``ppermute``, ``all_gather``, ``all_to_all``);
  * :mod:`repro_torch.dist.compress`  — int8 / top-k gradient compression
    with error feedback, and ``compressed_psum`` over a data axis;
  * :mod:`repro_torch.dist.pp`        — the scheduled pipeline executor
    over a ``stage`` axis, and the forward wavefront;
  * :mod:`repro_torch.dist.ep_a2a`    — expert-parallel MoE FFN with
    explicit all-to-all dispatch (``moe_ffn_ep_a2a``) and its byte twin;
  * :mod:`repro_torch.dist.schedules` — GPipe / 1F1B / interleaved-1F1B as
    explicit step tables, which the simulator's ``pipeline_graph`` and the
    executor both consume (a copy of the reference's).
"""
from repro_torch.dist.compress import (  # noqa: F401
    compress_with_feedback,
    compressed_allreduce_bytes,
    compressed_psum,
    compressed_psum_bytes,
    dequantize_int8,
    init_compression_state,
    init_feedback_state,
    leaf_elems,
    quantize_int8,
    topk_sparsify,
    tree_allreduce_bytes,
)
from repro_torch.dist.ep_a2a import moe_a2a_bytes, moe_ffn_ep_a2a  # noqa: F401
from repro_torch.dist.mesh import Mesh, make_mesh  # noqa: F401
from repro_torch.dist.pp import (  # noqa: F401
    pipeline_schedule_shard_map,
    pipeline_step_shard_map,
    pipeline_transfer_bytes,
    schedule_transfer_bytes,
)
from repro_torch.dist.schedules import (  # noqa: F401
    ExecutorPlan,
    GPipeSchedule,
    InterleavedOneFOneBSchedule,
    OneFOneBSchedule,
    PipelineSchedule,
    Step,
    build_executor_plan,
    make_schedule,
)
