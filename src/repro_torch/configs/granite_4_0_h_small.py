"""granite-4.0-h-small — hybrid Mamba-2 / attention stack, MoE 72e top-10
plus a shared expert.  [hf:ibm-granite/granite-4.0-h-small; config.json]

40L d_model=4096; 36 Mamba-2 mixers (128 heads of 64, d_state 128, conv 4
with bias, 1 group, chunk 256) and 4 GQA attention mixers (32 query, 8 KV
heads of 128, no position encoding, softmax scale 1/128) at layers 5, 15,
25 and 35; every layer's FFN is 72 routed SwiGLU experts of width 768, top
10, beside one shared SwiGLU of width 1536.  The embedding is scaled by 12,
each residual branch by 0.22 and the logits divided by 16; vocab 100352,
tied.

The public ``granitemoehybrid`` router takes the top 10 logits and a
softmax over them, which equals the port's softmax over all experts, top
10 and renormalisation.  The capacity factor E/k = 7.2 makes a dispatch
group's capacity the group itself, so no token is dropped.
"""
from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig, register


@register("granite-4.0-h-small")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-4.0-h-small",
        family="hybrid",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=100_352,
        rope_theta=0.0,
        norm_eps=1e-5,
        tie_embeddings=True,
        attn_every=10,
        attn_offset=5,
        moe=MoEConfig(
            num_experts=72,
            top_k=10,
            d_ff_expert=768,
            num_shared_experts=1,
            d_ff_shared=1536,
            every_k=1,
            offset=0,
            capacity_factor=7.2,
            group_size=512,
            router_aux_loss=0.0,
        ),
        mamba=MambaConfig(
            d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256,
            ngroups=1, conv_bias=True,
        ),
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=0.0078125,
        logits_scaling=16.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        optimizer="adafactor",
        remat_policy="full",
        source="hf:ibm-granite/granite-4.0-h-small; config.json",
    )
