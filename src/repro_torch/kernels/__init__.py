"""Hand-written Hopper kernels for the hot ops of the serve path.

Each kernel package holds three pieces:
  csrc/*.cu — the CUDA C++ kernel for sm_90a, built by ``_build`` with nvcc
  ops.py    — the wrapper: checks, launch, launch counter; plain version on CPU
  ref.py    — the plain PyTorch version of the same function

The TPU kernels they replace live in the JAX package under ``kernels/``;
``ssd_scan`` is not ported yet.
"""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm  # noqa: F401
