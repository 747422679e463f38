"""Mamba-2 SSD chunked scan: CUDA kernel, wrapper and plain version."""
