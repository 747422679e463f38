"""kimi-k2-1t-a32b — trillion-parameter MoE.  [arXiv:2501.kimi2; unverified]

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384 experts top-8
(+1 shared expert, DeepSeek-style).

Memory policy: bf16 params + Adafactor (factored second moment) — with 1T
parameters an AdamW fp32 state does not fit 256 x 16 GB.

This is the JAX package's twin (``repro.configs``), field for field, and it
is not the published model: where Kimi-K2-Instruct has multi-head latent
attention (q rank 1,536, a 512-wide latent and 64 rotary dims, YaRN RoPE),
this has GQA with 8 KV heads; where the published model's first layer is a
dense SwiGLU of 18,432, every layer here is MoE; where it routes by sigmoid
scores with a selection bias (``noaux_tc``) and scales the gates by 2.827,
this routes by softmax.  The published configuration is
``portbench/configs/kimi-k2-instruct-12l-ep16.json``, which sets the port's
opt-in fields (``mla_*``, ``yarn_*``, ``moe.scoring``, ``moe.first_dense``,
``moe.held_experts`` ...) on this registration.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("kimi-k2-1t-a32b")
def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=2048,  # dense-FFN width used by the shared expert path
        vocab_size=163_840,
        rope_theta=50_000.0,
        moe=MoEConfig(
            num_experts=384,
            top_k=8,
            d_ff_expert=2048,
            num_shared_experts=1,
            every_k=1,
            capacity_factor=1.25,
            group_size=512,
        ),
        param_dtype="bfloat16",
        optimizer="adafactor",
        remat_policy="full",
        grad_accum=8,
        fsdp_params=True,
        source="arXiv:2501.kimi2; unverified",
    )
