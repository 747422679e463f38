"""The benchmark's own count of the work a model needs.

Model FLOPs count the multiply-adds of the projections, the experts a token
is routed to (top-k, never the capacity slots) and the attention over the
keys each query sees (a causal query sees its own position and those before
it); the backward pass counts twice the forward, and recomputation is not
counted.  A kernel's least work reads each input once and writes each output
once, with key/value positions counted up to what each lane sees, not the
padded view.  So a share of the peak reads the same work whatever
implements the model.

``m`` is a configuration's ``dims`` (``portbench/configs/<name>.json``):
``d_model``, ``heads``, ``kv_heads``, ``head_dim``, ``d_ff``, ``vocab``,
``layers``, ``encoder_layers``, ``frontend_dim``, ``experts``, ``top_k``,
``d_ff_expert``.
"""
from __future__ import annotations

BF16 = 2   # bytes


def _proj_self(m: dict) -> float:
    """q, k, v and o projections of one token through one attention."""
    d, h, k, hd = m["d_model"], m["heads"], m["kv_heads"], m["head_dim"]
    return 2.0 * d * (2 * h * hd + 2 * k * hd)


def _attn(m: dict, keys: float) -> float:
    """Q K^T and P V of one query over ``keys`` keys (all heads)."""
    return 4.0 * m["heads"] * m["head_dim"] * keys


def _mlp(m: dict) -> float:
    return 2.0 * 3 * m["d_model"] * m["d_ff"]


def _causal_keys(n: int) -> float:
    """Keys seen by n causal queries from position 0: 1 + 2 + ... + n."""
    return n * (n + 1) / 2.0


def encdec_train_flops(m: dict, batch: int, src: int, tgt: int) -> float:
    """Model FLOPs of one training step of the encoder-decoder: ``batch``
    rows of ``src`` frames and ``tgt`` target tokens, forward and backward."""
    d, hd = m["d_model"], m["head_dim"]
    enc = m["encoder_layers"] * (src * (_proj_self(m) + _mlp(m))
                                 + src * _attn(m, src))
    frontend = src * 2.0 * m["frontend_dim"] * d
    cross_q_o = 2.0 * d * 2 * m["heads"] * hd
    cross_k_v = 2.0 * d * 2 * m["kv_heads"] * hd
    dec = m["layers"] * (tgt * (_proj_self(m) + cross_q_o + _mlp(m))
                         + src * cross_k_v
                         + _attn(m, _causal_keys(tgt))
                         + tgt * _attn(m, src))
    head = tgt * 2.0 * d * m["vocab"]
    return 3.0 * batch * (frontend + enc + dec + head)


def moe_token_flops(m: dict, keys: float, head: bool = True) -> float:
    """Model FLOPs of one token through the MoE decoder stack, attending
    over ``keys`` positions in every layer; ``head``: its logits too."""
    d = m["d_model"]
    per_layer = (_proj_self(m) + _attn(m, keys) + 2.0 * d * m["experts"]
                 + m["top_k"] * 2.0 * 3 * d * m["d_ff_expert"])
    return m["layers"] * per_layer + (2.0 * d * m["vocab"] if head else 0.0)


def moe_decode_flops(m: dict, lengths: list[int]) -> float:
    """A decode call over live lanes that hold ``lengths`` positions each
    (the new token sees its own position too)."""
    return sum(moe_token_flops(m, n + 1) for n in lengths)


def moe_prefill_flops(m: dict, start: int, width: int) -> float:
    """A prefill chunk of ``width`` real tokens from position ``start``:
    logits for its last token only, as the engine reads them."""
    d = m["d_model"]
    keys = width * start + _causal_keys(width)
    body = width * moe_token_flops(m, 0.0, head=False)
    return body + m["layers"] * _attn(m, keys) + 2.0 * d * m["vocab"]


def flash_least(m: dict, queries: int, keys_seen: float, keys_read: int,
                rows: int = 1) -> tuple[float, float]:
    """(operations, bytes) of one attention call: ``rows`` batch rows of
    ``queries`` queries that see ``keys_seen`` keys in all (per row) and
    read ``keys_read`` key/value positions (per row), bf16."""
    h, k, hd = m["heads"], m["kv_heads"], m["head_dim"]
    flops = rows * _attn(m, keys_seen)
    nbytes = rows * BF16 * (2 * queries * h * hd + 2 * keys_read * k * hd)
    return flops, nbytes


def flash_train_calls(m: dict, rows: int, src: int, tgt: int) -> list:
    """The encoder-decoder's attention calls of one forward pass over
    ``rows`` rows: (operations, bytes) each (encoder self, decoder self,
    decoder cross, by layer)."""
    enc = flash_least(m, src, src * src, src, rows)
    dec_self = flash_least(m, tgt, _causal_keys(tgt), tgt, rows)
    # the cross call reads q (tgt) and the memory's k, v (src)
    h, k, hd = m["heads"], m["kv_heads"], m["head_dim"]
    cross = (rows * _attn(m, tgt * src),
             rows * BF16 * (2 * tgt * h * hd + 2 * src * k * hd))
    return ([enc] * m["encoder_layers"]
            + [dec_self, cross] * m["layers"])


def flash_decode_calls(m: dict, lengths: list[int]) -> list:
    """One decode call's attention (all live lanes), per layer."""
    flops = nbytes = 0.0
    for n in lengths:
        f, b = flash_least(m, 1, n + 1, n + 1)
        flops, nbytes = flops + f, nbytes + b
    return [(flops, nbytes)] * m["layers"]


def flash_prefill_calls(m: dict, start: int, width: int) -> list:
    """One prefill chunk's attention, per layer."""
    call = flash_least(m, width, width * start + _causal_keys(width),
                       start + width)
    return [call] * m["layers"]
