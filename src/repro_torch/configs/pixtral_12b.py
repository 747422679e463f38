"""pixtral-12b — VLM: pixtral-ViT frontend (STUB) + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

The modality frontend is a stub by design: ``input_specs()`` provides
precomputed patch embeddings at the vision-encoder output dim (1024); the
backbone owns the real 2-layer multimodal projector into d_model.
"""
from repro_torch.configs.base import ArchConfig, register


@register("pixtral-12b")
def config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        vocab_size=131_072,
        rope_theta=1_000_000.0,
        num_patches=1024,
        vision_dim=1024,
        param_dtype="float32",
        remat_policy="dots",
        grad_accum=4,
        source="hf:mistralai/Pixtral-12B-2409; unverified",
    )
