"""Fused RMSNorm: CUDA kernel, wrapper and plain version."""
