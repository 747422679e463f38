"""qwen1.5-110b — dense decoder LM with QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen1.5-110b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49_152,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        param_dtype="float32",
        remat_policy="full",
        grad_accum=8,
        fsdp_params=True,
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
