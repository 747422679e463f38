"""Paged-KV device functions: block pool + chunked prefill + batched decode.

The device-side half of the paged cache (host bookkeeping lives in
``repro_torch.serve.blocks``).  One KV *pool* holds every slot's cache:

    pool["k"], pool["v"]: (num_layers, num_blocks, block_size, K, hd)

A request's cache positions map through its block table — a row of
``max_blocks_per_slot`` pool indices, padded with the scratch block — so
view index ``v`` of the gathered per-slot cache

    pool[layer][table_row].reshape(view_len, K, hd)

is exactly logical position ``v``.  Two functions, both running every
layer through ``repro_torch.models.transformer.prenorm_layer`` (the same
rmsnorms, residuals and FFN as the non-paged forward: the SwiGLU MLP, or
in the ``moe`` family the routed experts plus any shared expert, and none
where a hybrid layer has no FFN):

* :func:`prefill_chunk` — one prompt chunk of one request (batch 1, padded
  to a pow2 ``bucket``), scatter-writes the chunk's K/V into the pool and
  attends over the gathered view with an absolute-position causal mask;
* :func:`decode_batch` — one token for ALL slots (static batch = slots);
  inactive lanes are routed to the scratch block with length 0.

Where this differs from the JAX package's ``repro.serve.paged``:

* the pool is written IN PLACE (``index_put_``) and the same dict is
  returned; the JAX version returns a new pool, which its engine rebinds;
* the mask is expressed per row as ``q_offset`` / ``kv_len`` device tensors
  handed to the flash-attention op (prefill: ``q_offset = start``, decode:
  ``q_offset = lengths``; ``kv_len = view_len`` for both), which is exactly
  the JAX causal mask ``kv_pos <= pos``.  No row of either mask is fully
  masked, so the plain version's masking and the kernel's zeroing of a
  fully masked row never differ here;
* out-of-range block-table reads of padded prefill lanes are clamped, as
  JAX clamps them, before those lanes are routed to the scratch block.

An MoE block routes the tokens of the call, as the JAX package's does: its
dispatch groups and capacity come from how many tokens the call holds (a
prefill chunk's bucket, padding included, or one token a slot), so a chunked
prefill may drop a choice that a whole-prompt prefill keeps, and the
reverse.

**Slot sharding** (the JAX engine's ``mesh``: params and pool replicated,
the decode batch's tokens, lengths and block tables sharded over the mesh's
first axis).  :func:`replicas` holds the params and the pool once a device
of the mesh (the same tensors for every rank on the caller's device, a copy
for a rank on another); :func:`prefill_replicated` runs a chunk on every
replica, as JAX's replicated prefill runs on every device; and
:func:`decode_slot_sharded` runs each rank's contiguous ``slots // n``
lanes on its own device through :func:`decode_batch`, its shards of the
inputs being views (``models.sharding.shards``).  A pool block belongs to
one slot, so the ranks' writes never overlap, and every position a rank
reads was written by a prefill (on every replica) or by that rank's own
decode.  The logits come back in slot order on the caller's device.

The write-then-gather order is kept: the chunk's own K/V are in the view it
attends over.  The gather stays in PyTorch (a kernel that reads through the
block table is later work).  The pool always stores ``cfg.compute_dtype``.

**The hybrid family** (Mamba-2 and attention mixers, ``models/hybrid.py``)
keeps two kinds of cache side by side.  The KV pool covers the attention
layers alone, ``(n_attention_layers, num_blocks, block_size, K, hd)``, and a
*state pool* ``pool["ssm"]`` holds each Mamba layer's recurrent state a
slot, in the layout of ``models.mamba.init_mamba_cache``: conv tails
``conv_x``/``conv_B``/``conv_C`` (n_mamba, slots + 1, w-1, ...) in the
compute dtype and ``state`` (n_mamba, slots + 1, heads, d_state, head_dim)
in fp32.  Lane ``slots`` is scratch: a prefill given no slot (the engine's
warm-up) runs there.  :func:`prefill_chunk` continues the slot's state from
chunk to chunk (``mamba_forward``'s ``conv_tails``/``init_state``; the
bucket's right-padding has dt 0 and leaves both alone) and writes it back;
:func:`decode_batch` steps every lane's state in place (``mamba_step``'s
``state_out``: the decode-step kernel reads and writes the pool's state
once), and a lane that comes in with length 0 (idle, or its prompt still
mid-prefill) keeps its state and tails as they were (``mamba_step``'s
``active``).
:func:`reset_slot_state` zeroes a slot's state when a request is admitted.

**Latent attention** (``cfg.is_mla``, ``models/mla.py``) keeps one latent
pool in place of K and V:

    pool["latent"]: (num_layers, num_blocks, block_size, kv_rank + rope)

a token's normed latent and rotated ``k_pe`` a layer, shared by every head
(576 values at the published widths, where per-head K/V would hold 64 x
(192 + 128)).  Each new token's entry is written in place, as K/V are, and
every token then attends over its lane's entries up to its own position
through the paged kernel ``kernels/mla_attention`` (absorbed form; no view
is gathered), in a prefill chunk as in a decode call.  Leading dense layers
(``dense_blocks``) run ahead of the stack's (``transformer.stack_layers``).

``torch.profiler`` ranges (``obs.record.prange``): ``paged.kv_gather``
around each layer's two gathers of the view, ``paged.head`` around the
head's weight and logits in both functions, ``mamba.mixer`` around each
Mamba layer's mixer (its state read and write-back included: in a
decode call, the decode-step kernel), ``mla.attn`` around each latent
attention mixer (projections, the entry's write, the kernel and
``o_proj``); the MoE FFN is ``moe.ffn``.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import mla as MLA
from repro_torch.models.sharding import P, shards
from repro_torch.models.transformer import logits, prenorm_layer, stack_layers
from repro_torch.obs.record import prange
from repro_torch.serve.policy import ServeConfig
from repro_torch.tree import tree_map

SUPPORTED_FAMILIES = ("dense", "moe", "hybrid")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in SUPPORTED_FAMILIES or cfg.num_patches:
        raise ValueError(
            f"paged serving in the port supports text-only "
            f"{SUPPORTED_FAMILIES} families, not {cfg.family!r}"
            + (" with patches" if cfg.num_patches else "")
        )


def attention_layers(cfg: ArchConfig) -> list[int]:
    """The layers whose mixer is attention: every layer, or in the hybrid
    family those at ``attn_offset`` of each period."""
    if cfg.family != "hybrid":
        return list(range(cfg.num_layers))
    return [i for i in range(cfg.num_layers)
            if i % cfg.attn_every == cfg.attn_offset]


def init_pool(cfg: ArchConfig, scfg: ServeConfig, device) -> dict:
    """Zero-initialized paged KV pool for every attention layer (a latent
    pool ``"latent"`` where the config has latent attention); in the hybrid
    family also the state pool of every Mamba layer (``"ssm"``, ``slots +
    1`` lanes, the last one scratch)."""
    shape = (
        len(attention_layers(cfg)),
        scfg.resolved_num_blocks(),
        scfg.block_size,
        cfg.num_kv_heads,
        cfg.resolved_head_dim,
    )
    dt = L.dtype_of(cfg.compute_dtype)
    if cfg.is_mla:
        return {"latent": torch.zeros(
            shape[:3] + (cfg.mla_kv_rank + cfg.mla_rope_dim,), dtype=dt,
            device=device)}
    pool = {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.family == "hybrid":
        n_mamba = cfg.num_layers - len(attention_layers(cfg))
        one = MB.init_mamba_cache(scfg.slots + 1, cfg, dt, device)
        pool["ssm"] = {k: torch.zeros((n_mamba,) + tuple(v.shape),
                                      dtype=v.dtype, device=device)
                       for k, v in one.items()}
    return pool


def reset_slot_state(pool: dict, slot: int) -> None:
    """Zero a slot's recurrent state in every Mamba layer (in place): a
    request admitted to the slot starts from position 0."""
    for t in pool["ssm"].values():
        t[:, slot].zero_()


def _paged_attention(attn_p, h, cfg, pool_k, pool_v, *, positions, write_bi,
                     write_off, tables, q_offset, kv_len):
    """Project, scatter-write into the pool layer (in place), attend over the
    gathered views.

    h: (B, S, d); write_bi/write_off: (B*S,) flat pool coordinates for each
    new token's K/V; tables: (B, max_blocks) pool block ids; q_offset,
    kv_len: (B,) int32.  Returns the attention output (B, S, d).
    """
    cdt = L.dtype_of(cfg.compute_dtype)
    b, s, _ = h.shape
    q, k, v = L._project_qkv(attn_p, h, cfg, positions)
    khd = k.shape[-2:]
    pool_k.index_put_((write_bi, write_off),
                      k.reshape((b * s,) + khd).to(pool_k.dtype))
    pool_v.index_put_((write_bi, write_off),
                      v.reshape((b * s,) + khd).to(pool_v.dtype))
    view = tables.shape[1] * pool_k.shape[1]
    with prange("paged.kv_gather"):
        k_view = pool_k[tables].reshape((b, view) + khd)
        v_view = pool_v[tables].reshape((b, view) + khd)
    out = L._sdpa(q, k_view, v_view, cfg, q_offset=q_offset, kv_len=kv_len)
    return torch.einsum("bqhk,hkd->bqd", out, attn_p["wo"].to(cdt))


def _stack_forward(params, pool, tokens, cfg, *, mamba=None, **attn):
    """Embedding, every layer and the final norm.  ``attn``: the keywords
    of :func:`_paged_attention` past the pool layers; ``mamba(p, i, h)``:
    the hybrid family's Mamba mixer of the i-th Mamba layer."""
    h = L.embed(params["embed"], tokens, cfg)
    if cfg.family == "hybrid":
        layers = HY.stack_layers(params, cfg)
    else:
        layers = (("attn", i, bp) for i, bp in enumerate(stack_layers(params)))

    def attention(p, i, n):
        if cfg.is_mla:
            with prange("mla.attn"):
                return MLA.paged(p, n, cfg, pool["latent"][i],
                                 positions=attn["positions"],
                                 write_bi=attn["write_bi"],
                                 write_off=attn["write_off"],
                                 tables=attn["tables"])
        return _paged_attention(p, n, cfg, pool["k"][i], pool["v"][i], **attn)

    mixers = {"attn": attention, "mamba": mamba}
    for mixer, i, bp in layers:
        h, _ = prenorm_layer(bp, h, cfg,
                             ("norm1", partial(mixers[mixer], bp[mixer], i)))
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.compute_dtype)


def prefill_chunk(params, pool, tokens, start: int, width: int, table_row,
                  scratch_block: int, cfg: ArchConfig, scfg: ServeConfig,
                  slot: int | None = None):
    """One prompt chunk of one request through the whole stack.

    tokens: (1, bucket) int, right-padded with zeros beyond ``width``; the
    chunk covers prompt positions [start, start+width); table_row:
    (max_blocks_per_slot,) int; slot: the request's slot, whose recurrent
    state a hybrid stack continues (None: the scratch lane).  Returns
    (last-real-token logits (1, 1, vocab), pool) — the pool is updated in
    place.
    """
    dev = tokens.device
    bucket = tokens.shape[1]
    bs = scfg.block_size
    idx = torch.arange(bucket, dtype=torch.int64, device=dev)
    pos = start + idx                        # absolute prompt positions
    real = idx < width                       # padded lanes -> scratch
    blk = table_row.to(torch.int64)[
        (pos // bs).clamp(max=table_row.shape[0] - 1)
    ]
    write_bi = torch.where(real, blk, torch.full_like(blk, scratch_block))
    write_off = torch.where(real, pos % bs, torch.zeros_like(pos))
    rows = torch.full((1,), start, dtype=torch.int32, device=dev)
    lane = scfg.slots if slot is None else slot

    def mamba(p, i, n):
        with prange("mamba.mixer"):
            st = {k: v[i, lane:lane + 1] for k, v in pool["ssm"].items()}
            y, new = MB.mamba_forward(
                p, n, cfg, init_state=st["state"], length=width,
                conv_tails={k: v for k, v in st.items() if k != "state"})
            for k, v in new.items():
                st[k].copy_(v)
            return y

    h = _stack_forward(
        params, pool, tokens, cfg, mamba=mamba, positions=pos[None, :],
        write_bi=write_bi, write_off=write_off,
        tables=table_row.to(torch.int64)[None],
        q_offset=rows, kv_len=torch.full_like(rows, scfg.view_len),
    )
    last = h[:, width - 1:width]
    with prange("paged.head"):
        return logits(params, last, cfg), pool


def decode_batch(params, pool, tokens, lengths, tables, cfg: ArchConfig,
                 scfg: ServeConfig):
    """One decode token for every slot lane (static batch = slots).

    tokens: (S, 1) int; lengths: (S,) cache positions already written (the
    new token lands at position ``lengths[s]``); tables: (S,
    max_blocks_per_slot) int.  Inactive lanes must come in with length 0
    and an all-scratch table row — they compute garbage that only ever
    writes to the scratch block, and leave a hybrid stack's recurrent state
    as it was.  Returns (logits (S, 1, vocab), pool) — the pool is updated
    in place.
    """
    s = tokens.shape[0]
    bs = scfg.block_size
    lengths64 = lengths.to(torch.int64)
    tables64 = tables.to(torch.int64)
    write_bi = tables64[torch.arange(s, device=tokens.device),
                        lengths64 // bs]
    write_off = lengths64 % bs
    q_offset = lengths.to(torch.int32)
    active = lengths64 > 0 if "ssm" in pool else None

    def mamba(p, i, n):
        # the pool's lanes step in place: the state by the kernel itself,
        # no temporary of its size and no copy back
        with prange("mamba.mixer"):
            st = {k: v[i, :s] for k, v in pool["ssm"].items()}
            return MB.mamba_step(p, n, cfg, st, active=active,
                                 state_out=st["state"])[0]

    h = _stack_forward(
        params, pool, tokens, cfg, mamba=mamba, positions=lengths64[:, None],
        write_bi=write_bi, write_off=write_off, tables=tables64,
        q_offset=q_offset,
        kv_len=torch.full_like(q_offset, scfg.view_len),
    )
    with prange("paged.head"):
        return logits(params, h, cfg), pool


# -- slot sharding ---------------------------------------------------------------


def check_slot_sharding(slots: int, mesh) -> None:
    """A slot-sharded decode splits the slots evenly over the mesh's first
    axis (the JAX launcher's message)."""
    n = mesh.shape[0]
    if slots % n:
        raise ValueError(
            f"--shard needs slots ({slots}) divisible by device count ({n})"
        )


def replicas(params, pool, mesh) -> dict:
    """``{device: (params, pool)}`` over the devices of ``mesh``: first the
    given tensors on their own device (the caller's), then a copy on every
    other device."""
    home = pool["k"].device
    out = {home: (params, pool)}
    for d in mesh.devices:
        if d not in out:
            out[d] = (tree_map(lambda t: t.to(d), params),
                      {k: v.to(d) for k, v in pool.items()})
    return out


def prefill_replicated(reps: dict, tokens, start: int, width: int,
                       table_row, scratch_block: int, cfg: ArchConfig,
                       scfg: ServeConfig):
    """:func:`prefill_chunk` on every replica of :func:`replicas` (each pool
    gets the chunk's K/V); returns the caller's replica's ``(logits,
    pool)``."""
    out = [prefill_chunk(params, pool, tokens.to(dev), start, width,
                         table_row.to(dev), scratch_block, cfg, scfg)
           for dev, (params, pool) in reps.items()]
    return out[0]


def decode_slot_sharded(reps: dict, tokens, lengths, tables,
                        cfg: ArchConfig, scfg: ServeConfig, mesh):
    """:func:`decode_batch` with the lanes split over the mesh's first
    axis: rank ``r`` decodes lanes ``[r * S/n, (r+1) * S/n)`` on its device
    from its replica of :func:`replicas`.  Returns (logits (S, 1, vocab) in
    slot order on the caller's device, the caller's pool)."""
    home = next(iter(reps))
    ax = mesh.axis_names[0]
    cut = P(ax)
    parts = [shards(t, cut, mesh) for t in (tokens, lengths, tables)]
    logits = []
    for c in mesh.group(ax, (0,) * len(mesh.shape)):
        params, pool = reps[mesh.device(c)]
        lg, _ = decode_batch(params, pool, parts[0][c], parts[1][c],
                             parts[2][c], cfg, scfg)
        logits.append(lg.to(home))
    return torch.cat(logits), reps[home][1]
