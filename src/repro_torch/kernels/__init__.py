"""Hand-written Hopper kernels for the hot ops of the serve and train paths.

Each kernel package holds three pieces:
  csrc/*.cu — the CUDA C++ kernel for sm_90a, built by ``_build`` with nvcc
  ops.py    — the wrapper: checks, launch, launch counter; plain version on CPU
  ref.py    — the plain PyTorch version of the same function

The TPU kernels they replace live in the JAX package under ``kernels/``;
each of the three has its counterpart here.  The ops are registered with
``torch.library`` (one traced node per launch, gradient through the plain
version's VJP).
"""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm  # noqa: F401
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
