"""Config system: architecture configs, input-shape configs, run plans.

Every assigned architecture is expressed as an :class:`ArchConfig`.  The same
dataclass drives model construction (``repro_torch.models.build``), sharding rule
resolution, the dry-run (``repro_torch.launch.dryrun``) and the benchmarks, so a
config file is the single source of truth for one architecture.

Shape configs (``train_4k`` / ``prefill_32k`` / ``decode_32k`` / ``long_500k``)
are global and paired with per-arch applicability rules (see
:func:`shape_applicable`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for one FFN block."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # MoE replaces the dense FFN in layers where ``layer_idx % every_k == offset``.
    every_k: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    # Tokens are dispatched within groups of this many tokens (GShard-style
    # grouped dispatch keeps the dispatch mask O(N * k * group) instead of
    # O(N * E * C)).
    group_size: int = 512
    router_aux_loss: float = 0.01
    # width of the shared SwiGLU expert; 0: ``num_shared_experts`` times the
    # config's ``d_ff`` (the transformer block's sizing)
    d_ff_shared: int = 0
    # "einsum": GSPMD places the collectives (baseline).  "ep_a2a": explicit
    # shard_map all-to-all expert parallelism — experts sharded over `data`,
    # expert FFN width over `model`; only routed activations move.
    impl: str = "einsum"
    # DeepSeek-style routing; each default adds no operation: "softmax"
    # (probabilities over the experts, top-k, renormalised) or "sigmoid"
    # (fp32 sigmoid scores, top-k of the scores plus the selection bias
    # ``router_bias`` where ``score_bias``, gates the chosen scores
    # renormalised over the k (+1e-20)); the gates times ``routed_scaling``
    scoring: str = "softmax"
    score_bias: bool = False
    routed_scaling: float = 1.0
    # the first ``first_dense`` layers keep the dense SwiGLU of width d_ff
    # (the MoE replaces it from there on)
    first_dense: int = 0
    # the experts this rank holds of the ``num_experts`` the router scores:
    # [held_offset, held_offset + held_experts); 0: all of them.  Choices
    # of other experts add nothing here (their ranks compute them)
    held_experts: int = 0
    held_offset: int = 0


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-2 SSD mixer settings."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    ngroups: int = 1
    # a bias on each channel of the depthwise conv, added before its SiLU
    conv_bias: bool = False


@dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture.

    ``family`` is one of ``dense | moe | hybrid | ssm | vlm | audio`` and
    selects the model constructor.  All transformer families share the attention /
    FFN substrate in ``repro_torch.models.layers``.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # hybrid interleave: layer i is attention iff i % attn_every == attn_offset
    attn_every: int = 1
    attn_offset: int = 0
    # vlm: number of image patches prepended to the text sequence, and the
    # (stub) vision-encoder output dim projected into d_model.
    num_patches: int = 0
    vision_dim: int = 0
    # audio/encdec: encoder depth and the (stub) frontend feature dim.
    encoder_layers: int = 0
    frontend_dim: int = 0
    source_len: int = 4096         # encoder source length used by decode shapes
    # numerics / memory policy
    param_dtype: str = "float32"   # master parameter dtype
    compute_dtype: str = "bfloat16"
    remat_policy: str = "dots"     # none | dots | full   (see repro_torch.train.step)
    grad_accum: int = 1            # microbatch count for train_4k
    optimizer: str = "adamw"       # adamw | adafactor
    # attention implementation: "auto" picks blockwise (online-softmax) above
    # this many KV tokens, plain dense below it.
    attn_impl: str = "auto"
    attn_block_kv: int = 512
    flash_threshold: int = 8192
    # GQA KV replication target: 0 -> repeat KV heads all the way to H
    # (baseline); N -> repeat only to N heads (e.g. the TP width) and use the
    # grouped-attention einsum, cutting KV HBM traffic by H/N while keeping
    # the head dim shardable.
    gqa_repeat_to: int = 0
    # KV-cache storage: "bfloat16" (baseline) or "int8" (per-token-per-head
    # symmetric quantization; halves decode cache reads — §Perf).
    kv_cache_dtype: str = "bfloat16"
    # per-arch sharding rule overrides (see models/sharding.py), e.g. phi4
    # trades head sharding (24 % 16 != 0) for sequence sharding of attention.
    sharding_overrides: Optional[dict] = None
    # FSDP-style parameter sharding over the data axis (ZeRO-3/"fsdp" in
    # maxtext terms) — required for >=100B configs to fit per-chip HBM.
    fsdp_params: bool = False
    # logical axes excluded from FSDP (e.g. ("experts",): expert weights are
    # already model-sharded and regathering all E experts per microbatch when
    # only top-k are active is pure waste).
    fsdp_exclude: tuple = ()
    # chunked cross-entropy: max (seq*vocab) elements per device before the
    # loss switches to a seq-chunked logsumexp scan.
    loss_chunk: int = 512
    # scalings of the granite families; each default adds no operation:
    # the embedding's output times ``embedding_multiplier``, every residual
    # branch (mixer, FFN) times ``residual_multiplier`` before its add, the
    # attention softmax's scale ``attention_multiplier`` (0: 1/sqrt(head
    # dim)), the logits divided by ``logits_scaling``
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    # multi-head latent attention (DeepSeek-V2/V3, Kimi-K2), on where
    # ``mla_kv_rank`` > 0: q from a rank-``mla_q_rank`` latent, k and v from
    # one ``mla_kv_rank`` latent a token shared by every head, per head
    # ``mla_nope_dim`` key dims without position and ``mla_rope_dim`` with
    # RoPE (one k_pe for all heads), values of ``mla_v_dim``
    mla_q_rank: int = 0
    mla_kv_rank: int = 0
    mla_nope_dim: int = 0
    mla_rope_dim: int = 0
    mla_v_dim: int = 0
    # YaRN RoPE scaling of the latent attention's rotary dims, on where
    # ``yarn_factor`` > 1: the frequencies past the correction range over
    # ``yarn_original_max`` positions divided by the factor, cos and sin
    # times mscale(factor, yarn_mscale) / mscale(factor,
    # yarn_mscale_all_dim), the softmax scale times mscale(factor,
    # yarn_mscale_all_dim)^2
    yarn_factor: float = 1.0
    yarn_original_max: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    # citation / provenance string of the published config
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_mla(self) -> bool:
        return self.mla_kv_rank > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n = v * d                       # token embedding
        if not self.tie_embeddings:
            n += v * d                  # output head
        attn = d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2
        if self.is_mla:
            qr, kr, H = self.mla_q_rank, self.mla_kv_rank, self.num_heads
            qk = self.mla_nope_dim + self.mla_rope_dim
            attn = (d * qr + qr + qr * H * qk + d * (kr + self.mla_rope_dim)
                    + kr + kr * H * (self.mla_nope_dim + self.mla_v_dim)
                    + H * self.mla_v_dim * d)
        dense_ffn = 3 * d * self.d_ff if self.d_ff else 0
        mamba_p = 0
        if self.mamba is not None:
            d_in = self.mamba.expand * d
            nheads = d_in // self.mamba.head_dim
            # in_proj (x, z, B, C, dt) + out_proj + conv + A/D
            d_bc = 2 * self.mamba.ngroups * self.mamba.d_state
            mamba_p = d * (2 * d_in + d_bc + nheads) + d_in * d + 4 * (
                d_in + d_bc
            ) + 2 * nheads
            if self.mamba.conv_bias:
                mamba_p += d_in + d_bc
        for i in range(self.num_layers):
            is_attn = (i % self.attn_every) == self.attn_offset
            if self.family == "ssm":
                n += mamba_p + d  # mixer + norm
                continue
            if is_attn:
                n += attn + 2 * d
            else:
                n += mamba_p + d
            # FFN (dense or MoE) — hybrid archs attach FFN to every layer
            if (self.moe is not None and i >= self.moe.first_dense
                    and i % self.moe.every_k == self.moe.offset):
                e = self.moe
                n += (e.held_experts or e.num_experts) * 3 * d * e.d_ff_expert
                if e.d_ff_shared:
                    n += 3 * d * e.d_ff_shared
                else:
                    n += e.num_shared_experts * 3 * d * e.d_ff_expert
                n += d * self.moe.num_experts  # router
            elif self.d_ff:
                n += dense_ffn
        if self.encoder_layers:
            n += self.encoder_layers * (attn + dense_ffn + 3 * d)
            n += attn + 2 * d  # decoder cross-attention reuse approximation
        if self.num_patches:
            n += self.vision_dim * d + d * d  # 2-layer projector
        return n

    def active_params(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.num_params()
        e = self.moe
        total = self.num_params()
        moe_layers = len(
            [i for i in range(self.num_layers) if i % e.every_k == e.offset]
        )
        all_experts = moe_layers * e.num_experts * 3 * self.d_model * e.d_ff_expert
        # a shared expert of its own width is already in the total
        per_token = e.top_k + (0 if e.d_ff_shared else e.num_shared_experts)
        active = moe_layers * per_token * 3 * self.d_model * e.d_ff_expert
        return total - all_experts + active


# ---------------------------------------------------------------------------
# Shape configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Arch families allowed to run the 500k-decode cell (sub-quadratic mixers).
_LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, reason-if-not).  See DESIGN.md §4 for the skip policy."""
    if shape.name == "long_500k" and arch.family not in _LONG_CONTEXT_FAMILIES:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{arch.name} is pure full-attention (family={arch.family})"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ArchConfig:
    # import the per-arch modules lazily so `configs.base` has no cycles
    from repro_torch import configs as _pkg  # noqa: F401  (triggers registration)

    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from repro_torch import configs as _pkg  # noqa: F401

    return sorted(_REGISTRY)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """A reduced config of the same family for CPU smoke tests.

    Small layers/width, few experts, tiny vocab — exercises the exact same
    model-building code path as the full config.
    """
    changes: dict = {
        "num_layers": min(cfg.num_layers, 4),
        "d_model": 128,
        "num_heads": 4,
        "num_kv_heads": min(cfg.num_kv_heads, 2),
        "head_dim": 32,
        "d_ff": 256 if cfg.d_ff else 0,
        "vocab_size": 512,
        "grad_accum": 1,
        "param_dtype": "float32",
        "compute_dtype": "float32",
    }
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=2,
            d_ff_expert=64,
            group_size=32,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff_shared=128 if cfg.moe.d_ff_shared else 0,
        )
    if cfg.mamba is not None:
        changes["mamba"] = dataclasses.replace(
            cfg.mamba, d_state=16, head_dim=16, chunk_size=16
        )
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
        changes["frontend_dim"] = 64
        changes["source_len"] = 64
    if cfg.num_patches:
        changes["num_patches"] = 8
        changes["vision_dim"] = 64
    # keep hybrid interleave pattern meaningful at 4 layers
    if cfg.attn_every > 1:
        changes["attn_every"] = 2
        changes["attn_offset"] = cfg.attn_offset % 2
        changes["num_layers"] = 4
    return dataclasses.replace(cfg, **changes)


def smoke_shape(kind: str = "train") -> ShapeConfig:
    if kind == "train":
        return ShapeConfig("smoke_train", 64, 4, "train")
    if kind == "prefill":
        return ShapeConfig("smoke_prefill", 64, 2, "prefill")
    return ShapeConfig("smoke_decode", 64, 2, "decode")
