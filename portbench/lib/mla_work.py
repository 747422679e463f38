"""The paged latent-attention kernel's least work and its kernels' names,
frozen from ``src/repro_torch/kernels/mla_attention/ops.py`` (``work``,
``KERNELS``), so a later change to the program does not move the yardstick.

A call of one layer: each token sees its lane's latent rows up to its own
position (``keys`` = position + 1) with every head; two operations a
multiply-add of each score over the whole row (``width``: the latent and
the rotary key dims) and of each output column (``rank``: the latent).
Bytes: each lane's rows read once (to its largest position), the tokens'
query rows read once and their outputs written once, in bf16.

The least time of a call is the smaller of two forms' (``forms``): the
kernel's absorbed form above, and the published expanded form
(``expanded``), which first expands each lane's latent rows into per-head
keys and values.  At a 2,048-token chunk over a long prefix the expanded
form does ~2.8x fewer operations; at decode the expansion of the whole
prefix for one token makes it far dearer.
"""
from __future__ import annotations

KERNELS = ("mla_attn_kernel", "mla_combine_kernel")
WIDTH, RANK = 576, 512


def work(keys: list[int], lane_keys: list[int], heads: int,
         width: int = WIDTH, rank: int = RANK,
         el: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one layer's call."""
    ops = 2.0 * sum(keys) * heads * (width + rank)
    nbytes = (sum(lane_keys) * width
              + len(keys) * heads * (width + rank)) * el
    return ops, float(nbytes)


def expanded(keys: list[int], lane_keys: list[int], d: dict,
             el: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one layer's call in the expanded form: each
    lane's latent rows times ``kv_b`` (``kv_rank`` by heads x (nope + v)),
    then two operations a multiply-add of every score (nope + rope) and
    every output column (v).  Bytes: each lane's latent rows and ``kv_b``
    read once, the tokens' query rows read and outputs written once; the
    per-head keys and values are taken to stay on the chip."""
    h, r = d["heads"], d["kv_rank"]
    qk, v = d["nope_dim"] + d["rope_dim"], d["v_dim"]
    ops = (2.0 * sum(keys) * h * (qk + v)
           + 2.0 * sum(lane_keys) * r * h * (d["nope_dim"] + v))
    nbytes = (sum(lane_keys) * (r + d["rope_dim"])
              + r * h * (d["nope_dim"] + v) + len(keys) * h * (qk + v)) * el
    return ops, float(nbytes)


def forms(d: dict, keys: list[int], lane_keys: list[int]) -> list:
    """(operations, bytes) of both forms of one layer's call: the absorbed
    (the kernel's ``work``) and the expanded."""
    return [work(keys, lane_keys, d["heads"], d["kv_rank"] + d["rope_dim"],
                 d["kv_rank"]),
            expanded(keys, lane_keys, d)]


def decode(d: dict, lengths: list) -> list:
    """A decode call of one layer, both forms: each live lane (a length,
    not None) sees its rows 0 .. length."""
    keys = [n + 1 for n in lengths if n is not None]
    return forms(d, keys, keys)


def prefill(d: dict, start: int, width: int) -> list:
    """A prefill chunk of one layer, both forms: the chunk's real tokens at
    positions start .. start + width - 1 of one lane."""
    keys = [start + i + 1 for i in range(width)]
    return forms(d, keys, [start + width])
