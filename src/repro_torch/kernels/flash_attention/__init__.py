"""Flash-attention forward: CUDA kernel, wrapper and plain version."""
