"""granite-3-2b — dense decoder LM.  [hf:ibm-granite/granite-3.0-2b-base; hf]

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.

Note: vocab 49155 = 3 * 5 * 29 * 113 is not divisible by the 16-way model
axis; the sharding resolver replicates the embedding table (logged drop).
"""
from repro_torch.configs.base import ArchConfig, register


@register("granite-3-2b")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-3-2b",
        family="dense",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49_155,
        rope_theta=10_000.0,
        tie_embeddings=True,
        param_dtype="float32",
        remat_policy="dots",
        grad_accum=4,
        source="hf:ibm-granite/granite-3.0-2b-base; hf",
    )
