"""Architecture configs — one module per assigned architecture.

Importing this package registers every architecture in the registry used by
``repro_torch.configs.base.get_config`` / ``list_archs``.
"""
from repro_torch.configs import (  # noqa: F401
    phi4_mini_3_8b,
    qwen1_5_110b,
    llama3_2_1b,
    granite_3_2b,
    pixtral_12b,
    kimi_k2_1t_a32b,
    qwen3_moe_235b_a22b,
    jamba_1_5_large_398b,
    granite_4_0_h_small,
    seamless_m4t_large_v2,
    mamba2_2_7b,
)
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    MambaConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    get_config,
    list_archs,
    shape_applicable,
    smoke_shape,
    smoke_variant,
)
