"""Model facade over every family of the JAX package: dense, moe and vlm
(``transformer``), ssm and hybrid (``hybrid``), audio (``encdec``).

``build_model(cfg)`` returns a :class:`Model` whose members are plain
functions on tensors::

    params = model.init(torch.Generator(device).manual_seed(0))
    loss, metrics = model.loss(params, batch)       # metrics: ce, aux
    logits, cache = model.prefill(params, tokens)   # (B, S) tokens
                                                    # [+ patches or frames]
    logits, cache = model.decode(params, cache, token, cache_len)
    axes = model.param_axes()                       # logical axes
    shapes, axes = model.abstract_params()          # nothing allocated
    cache = model.abstract_cache(batch, max_len)    # likewise

The JAX package's ``prefill(params, batch)`` reads ``batch["patches"]``
(vlm) and ``batch["frames"]`` (audio); here they are the keyword arguments
``patches=`` and ``frames=``.

:func:`load_jax_params` takes the JAX package's parameter tree of any family
(as numpy arrays, same keys and shapes, blocks, superblocks or the encoder
and decoder stacked on a leading layer axis), so both packages compute the
same thing in the tests.
:func:`compute_params` casts the block weights to the compute dtype once,
which is what the JAX code does at every use (identical numbers).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.tree import tree_map

_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": hybrid, "hybrid": hybrid, "audio": encdec}


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable  # generator -> params on generator.device
    loss: Callable  # (params, batch) -> (loss, metrics)
    # (params, tokens, max_len=None, patches=None, frames=None)
    #   -> (logits, cache)
    prefill: Callable
    decode: Callable  # (params, cache, token, cache_len) -> (logits, cache)
    init_cache: Callable  # (batch, max_len, dtype, device) -> cache
    cache_axes: Callable  # () -> logical-axes tree matching init_cache
    # () -> logical-axes tree matching init's parameters (the JAX package's
    # ``init`` returns it second)
    param_axes: Callable

    def abstract_params(self, seed: int = 0):
        """``(tree, axes)``: the parameter tree's shapes and dtypes
        (:class:`ShapeDtype` leaves) without allocating it, ``init`` run on
        fake tensors, and :meth:`param_axes`."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            fake = self.init(torch.Generator().manual_seed(seed))
        axes = self.param_axes()
        return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype),
                        fake), axes

    def abstract_cache(self, batch: int, max_len: int,
                       dtype=torch.bfloat16):
        """The cache tree's shapes and dtypes (:class:`ShapeDtype` leaves)
        without allocating it: ``init_cache`` run on fake tensors."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            fake = self.init_cache(batch, max_len, dtype, device="cpu")
        return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), fake)


@dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype (the counterpart of
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def build_model(cfg: ArchConfig) -> Model:
    mod = _MODULES.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown family {cfg.family!r}")

    def init(gen: torch.Generator):
        return mod.init_params(gen, cfg)

    def loss(params, batch):
        return mod.loss_fn(params, batch, cfg)

    def prefill(params, tokens, max_len=None, patches=None, frames=None):
        if max_len is None:
            max_len = tokens.shape[1] + cfg.num_patches
        if cfg.family == "audio":
            return mod.prefill(params, tokens, cfg, max_len, frames=frames)
        if frames is not None:
            raise ValueError(f"{cfg.name}: frames are the audio family's")
        if patches is None:
            return mod.prefill(params, tokens, cfg, max_len)
        return mod.prefill(params, tokens, cfg, max_len, patches=patches)

    def decode(params, cache, token, cache_len):
        return mod.decode_step(params, cache, token, cache_len, cfg)

    def init_cache(batch, max_len, dtype=torch.bfloat16, device="cuda"):
        return mod.init_cache(batch, max_len, cfg, dtype, device)

    def cache_axes():
        return mod.cache_axes(cfg)

    def param_axes():
        return mod.param_axes(cfg)

    return Model(cfg=cfg, init=init, loss=loss, prefill=prefill,
                 decode=decode, init_cache=init_cache, cache_axes=cache_axes,
                 param_axes=param_axes)


# ---------------------------------------------------------------------------
# Input specs (ShapeDtype) per (arch x shape) cell
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Abstract inputs for the step function of this cell.

    train/prefill: the token batch (plus stub modality inputs).
    decode: the new token; the KV/SSM cache is ``Model.abstract_cache``'s.
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        text_len = S - cfg.num_patches if cfg.num_patches else S
        assert text_len > 0
        specs = {"tokens": ShapeDtype((B, text_len), i32)}
        if shape.kind == "train":
            specs["labels"] = ShapeDtype((B, text_len), i32)
        if cfg.num_patches:
            specs["patches"] = ShapeDtype((B, cfg.num_patches,
                                           cfg.vision_dim), torch.bfloat16)
        if cfg.family == "audio":
            specs["frames"] = ShapeDtype((B, S, cfg.frontend_dim),
                                         torch.bfloat16)
        return specs
    # decode: one new token against a cache of S tokens
    return {"token": ShapeDtype((B, 1), i32)}


def batch_logical_axes(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Logical axes for each entry of :func:`input_specs`."""
    if shape.kind in ("train", "prefill"):
        axes = {"tokens": ("batch", None)}
        if shape.kind == "train":
            axes["labels"] = ("batch", None)
        if cfg.num_patches:
            axes["patches"] = ("batch", None, None)
        if cfg.family == "audio":
            axes["frames"] = ("batch", None, None)
        return axes
    return {"token": ("batch", None)}


def make_concrete_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                        device="cuda") -> dict:
    """Real inputs matching :func:`input_specs`, on ``device``: the JAX
    package's ``make_concrete_batch`` bit for bit (the same numpy draws in
    the same order; floats drawn in fp32 and rounded to the spec's dtype)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, sds in input_specs(cfg, shape).items():
        if sds.dtype.is_floating_point:
            a = rng.standard_normal(sds.shape, dtype=np.float32)
            out[k] = torch.from_numpy(a).to(device=device, dtype=sds.dtype)
        else:
            a = rng.integers(0, cfg.vocab_size, size=sds.shape,
                             dtype=np.int32)
            out[k] = torch.from_numpy(a).to(device)
    return out


def load_jax_params(tree, device="cuda") -> dict:
    """The JAX package's parameter tree (numpy leaves) as tensors on
    ``device``, keys, shapes and dtypes unchanged (the mamba tree's fp32
    ``A_log``, ``dt_bias`` and ``D_skip`` and the MoE router stay fp32
    beside bf16 weights; the experts' ``wg``/``wu``/``wd`` stay stacked
    (L, E, ., .))."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":   # ml_dtypes bf16: go through fp32
            return torch.tensor(a.astype(np.float32), device=device).to(
                torch.bfloat16)
        return torch.tensor(a, device=device)   # a copy: jax's are read-only

    return tree_map(leaf, tree)


def to_device(params, device) -> dict:
    return tree_map(lambda t: t.to(device), params)


def compute_params(params, cfg: ArchConfig) -> dict:
    """Serving copy of the parameters (dense and moe): the block matmul
    weights cast to the compute dtype once.  Norm scales stay in their
    parameter dtype (the norms read them in fp32), and so do the embedding
    (the logits head multiplies in fp32) and the MoE router and its
    selection bias (routing is fp32).  Leading dense layers
    (``dense_blocks``) are cast as the stack is."""
    cdt = L.dtype_of(cfg.compute_dtype)
    out = dict(params)
    for stack in ("blocks", "dense_blocks"):
        if stack not in params:
            continue
        blocks = dict(params[stack])
        for group in ("attn", "mlp", "shared_mlp"):
            if group in blocks:
                blocks[group] = tree_map(lambda t: t.to(cdt), blocks[group])
        if "moe" in blocks:
            blocks["moe"] = {k: v if k in ("router", "router_bias")
                             else v.to(cdt) for k, v in blocks["moe"].items()}
        out[stack] = blocks
    return out
