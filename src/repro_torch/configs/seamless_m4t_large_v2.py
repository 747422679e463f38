"""seamless-m4t-large-v2 — encoder-decoder, multimodal.  [arXiv:2308.11596; hf]

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.

The audio frontend is a STUB by design: ``input_specs()`` provides
precomputed frame embeddings at d_model.  24 layers are split 24 encoder +
24 decoder (enc-dec); decode shapes exercise the decoder with a fixed-length
encoded source (source_len).
"""
from repro_torch.configs.base import ArchConfig, register


@register("seamless-m4t-large-v2")
def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,          # decoder depth
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256_206,
        rope_theta=10_000.0,
        frontend_dim=1024,
        source_len=4096,
        param_dtype="float32",
        remat_policy="dots",
        grad_accum=2,
        source="arXiv:2308.11596; hf",
    )
