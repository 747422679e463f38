"""Model facade over the ported families (dense, moe, vlm and ssm, so far).

``build_model(cfg)`` returns a :class:`Model` whose members are plain
functions on tensors::

    params = model.init(torch.Generator(device).manual_seed(0))
    loss, metrics = model.loss(params, batch)       # metrics: ce, aux
    logits, cache = model.prefill(params, tokens)   # (B, S) tokens [+ patches]
    logits, cache = model.decode(params, cache, token, cache_len)

:func:`load_jax_params` takes the JAX package's parameter tree (as numpy
arrays, same keys and shapes, ``blocks`` stacked on a leading layer axis),
so both packages compute the same thing in the tests.
:func:`compute_params` casts the block weights to the compute dtype once,
which is what the JAX code does at every use (identical numbers).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import hybrid, transformer
from repro_torch.tree import tree_map

# JAX-package families still to port, and the ROADMAP.md item that ports them
_WAITING = {
    "hybrid": "the jamba superblock",
    "audio": "encdec",
}
_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": hybrid}


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable  # generator -> params on generator.device
    loss: Callable  # (params, batch) -> (loss, metrics)
    # (params, tokens, max_len=None, patches=None) -> (logits, cache)
    prefill: Callable
    decode: Callable  # (params, cache, token, cache_len) -> (logits, cache)
    init_cache: Callable  # (batch, max_len, dtype, device) -> cache


def build_model(cfg: ArchConfig) -> Model:
    mod = _MODULES.get(cfg.family)
    if mod is None:
        item = _WAITING.get(cfg.family, "?")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md, {item!r})"
        )

    def init(gen: torch.Generator):
        return mod.init_params(gen, cfg)

    def loss(params, batch):
        return mod.loss_fn(params, batch, cfg)

    def prefill(params, tokens, max_len=None, patches=None):
        if max_len is None:
            max_len = tokens.shape[1] + cfg.num_patches
        if patches is None:
            return mod.prefill(params, tokens, cfg, max_len)
        return mod.prefill(params, tokens, cfg, max_len, patches=patches)

    def decode(params, cache, token, cache_len):
        return mod.decode_step(params, cache, token, cache_len, cfg)

    def init_cache(batch, max_len, dtype=torch.bfloat16, device="cuda"):
        return mod.init_cache(batch, max_len, cfg, dtype, device)

    return Model(cfg=cfg, init=init, loss=loss, prefill=prefill,
                 decode=decode, init_cache=init_cache)


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
    """Serving copy of the parameters: the block matmul weights cast to the
    compute dtype once.  Norm scales stay in their parameter dtype (the
    norms read them in fp32) and so does the embedding (the logits head
    multiplies in fp32)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    blocks = dict(params["blocks"])
    for group in ("attn", "mlp"):
        blocks[group] = tree_map(lambda t: t.to(cdt), blocks[group])
    out = dict(params)
    out["blocks"] = blocks
    return out
