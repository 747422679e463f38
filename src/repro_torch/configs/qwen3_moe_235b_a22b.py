"""qwen3-moe-235b-a22b — 128-expert top-8 MoE.  [hf:Qwen/Qwen3-30B-A3B; hf]

94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("qwen3-moe-235b-a22b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151_936,
        rope_theta=1_000_000.0,
        moe=MoEConfig(
            num_experts=128,
            top_k=8,
            d_ff_expert=1536,
            num_shared_experts=0,
            every_k=1,
            capacity_factor=1.25,
            group_size=512,
        ),
        param_dtype="bfloat16",
        optimizer="adafactor",
        remat_policy="full",
        grad_accum=8,
        fsdp_params=True,
        source="hf:Qwen/Qwen3-30B-A3B; hf",
    )
