"""Mamba-2 decode step's recurrent core: CUDA kernel, wrapper and plain version."""
