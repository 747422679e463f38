"""Hand-written Hopper kernels for the hot ops of the serve and train paths.

Each kernel package holds three pieces:
  csrc/*.cu — the CUDA C++ kernel for sm_90a, built by ``_build`` with nvcc
  ops.py    — the wrapper: checks, launch, launch counter; plain version on CPU
  ref.py    — the plain PyTorch version of the same function

The TPU kernels they replace live in the JAX package under ``kernels/``;
each of the three has its counterpart here.  ``mamba_step`` replaces no TPU
kernel: it fuses the Mamba-2 decode step, plain ``jnp`` in the JAX package,
whose state update is bound by bytes.  Nor does ``moe_experts``: the dropless
MoE expert path of serving (routing, grouped GEMMs over each expert's routed
rows, combine), where the JAX package's MoE is one-hot einsums; it is bound by
the experts' weight bytes.  The ops are registered with ``torch.library`` (one
traced node per launch, gradient through the plain version's VJP; the decode
step has none), save ``moe_experts``'s plain functions, which run only without
autograd and outside the dry run.
"""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.mamba_step.ops import mamba_step  # noqa: F401
from repro_torch.kernels.moe_experts.ops import moe_experts  # noqa: F401
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm  # noqa: F401
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
