"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.

Layer i is attention iff i % 8 == 0 (1 attention : 7 mamba per period-8
block); MoE replaces the dense FFN on every other layer (i % 2 == 1).
Runs the ``long_500k`` cell: the mamba layers decode in O(1) state updates and
the 9 attention layers decode against a sequence-sharded KV cache.
"""
from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig, register


@register("jamba-1.5-large-398b")
def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24_576,
        vocab_size=65_536,
        rope_theta=10_000.0,
        attn_every=8,
        attn_offset=0,
        moe=MoEConfig(
            num_experts=16,
            top_k=2,
            d_ff_expert=24_576,
            every_k=2,
            offset=1,
            capacity_factor=1.25,
            group_size=512,
        ),
        mamba=MambaConfig(
            d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256
        ),
        param_dtype="bfloat16",
        optimizer="adafactor",
        remat_policy="full",
        grad_accum=8,
        fsdp_params=True,
        source="arXiv:2403.19887; hf",
    )
