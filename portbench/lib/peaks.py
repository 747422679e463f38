"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  Every share the benchmark
prints is taken against these, with the card's name and power limit beside
it (``lib.device.card``)."""

BF16_FLOPS = 989e12      # bf16 / fp16 tensor-core operations a second
FP32_FLOPS = 67e12       # fp32 outside the tensor cores
HBM_BYTES = 3.35e12      # HBM3 bytes a second


def least_seconds(flops: float, nbytes: float,
                  flops_rate: float = BF16_FLOPS) -> float:
    """The least time the card could take for this work: the larger of its
    operations at the peak rate and its bytes at the memory rate."""
    return max(flops / flops_rate, nbytes / HBM_BYTES)
