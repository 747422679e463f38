"""phi4-mini-3.8b — dense decoder LM.  [arXiv:2412.08905; hf]

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.

Note: 24 query heads do not divide the 16-way ``model`` mesh axis, so the
sharding resolver replicates attention head sharding on the baseline path
(see models/sharding.py); the §Perf log explores head padding to 32 as a
beyond-paper optimization.
"""
from repro_torch.configs.base import ArchConfig, register


@register("phi4-mini-3.8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200_064,
        rope_theta=10_000.0,
        tie_embeddings=True,
        param_dtype="float32",
        remat_policy="dots",
        grad_accum=4,
        source="arXiv:2412.08905; hf",
    )
