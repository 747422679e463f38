"""mamba2-2.7b — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060; unverified]

64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128.

Runs the ``long_500k`` cell (O(1)-state decode).
"""
from repro_torch.configs.base import ArchConfig, MambaConfig, register


@register("mamba2-2.7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=1,           # unused by the SSM mixer
        num_kv_heads=1,
        d_ff=0,
        vocab_size=50_280,
        mamba=MambaConfig(
            d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256
        ),
        param_dtype="float32",
        remat_policy="dots",
        grad_accum=2,
        source="arXiv:2405.21060; unverified",
    )
