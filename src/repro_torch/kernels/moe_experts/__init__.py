"""Dropless MoE experts: routing, grouped-GEMM and combine CUDA kernels, wrapper and plain version."""
