"""Kimi-K2's mechanisms in the port, against the plain float32 reference
(``portbench/reference/kimi_mla.py``: the published, expanded equations over
a whole sequence) on seeded random weights at a small size: multi-head
latent attention with YaRN RoPE, sigmoid routing with a selection bias and a
routed scaling over a share of the experts, a dense first layer.

Covered: the model's forward; prefill in chunks and then decode through the
latent pool of the paged engine; the paged kernel's plain version against
the expanded form; the routing; YaRN's frequencies and scales against their
formulas at the published widths; the expert shares of a layer summing to
the uncut layer; the new config fields' defaults adding no operation.
"""
import dataclasses
import math
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import kimi_mla as K  # noqa: E402
from portbench.reference.common import Precision  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels.mla_attention.ref import (  # noqa: E402
    mla_attention_ref,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import paged  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

# Relative to the reference logits' largest magnitude.  Program and
# reference compute in float32; they differ in the order of their products
# (the absorbed form against the expanded one, the latent pool's pages, the
# dropless experts' rows), measured at 8.9e-7.  A latent pool stored in
# bfloat16 reads 5.6e-3 here, so 5e-5 passes the program with ~55x room and
# fails that fault by ~110x.
TOL = 5e-5


def tiny(**moe):
    """Kimi-K2 cut to a CPU size, in float32: 3 layers (one dense, two MoE),
    MLA with YaRN over 64 original positions (so the ramp falls inside the
    rotary dims), 16 experts top-4, 4 held from offset 4."""
    base = get_config("kimi-k2-1t-a32b")
    kw = dict(num_experts=16, top_k=4, d_ff_expert=32, d_ff_shared=32,
              capacity_factor=4.0, group_size=64, scoring="sigmoid",
              score_bias=True, routed_scaling=2.5, first_dense=1,
              held_experts=4, held_offset=4)
    kw.update(moe)
    return dataclasses.replace(
        base, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=96, vocab_size=256, norm_eps=1e-6,
        param_dtype="float32", compute_dtype="float32", mla_q_rank=32,
        mla_kv_rank=32, mla_nope_dim=16, mla_rope_dim=16, mla_v_dim=24,
        yarn_factor=32.0, yarn_original_max=64, yarn_beta_fast=32.0,
        yarn_beta_slow=1.0, yarn_mscale=1.0, yarn_mscale_all_dim=0.707,
        moe=dataclasses.replace(base.moe, **kw))


def weights(cfg, seed=0):
    p = build_model(cfg).init(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    p["blocks"]["moe"]["router_bias"].normal_(generator=g).mul_(0.05)
    return p


def ref_logits(p, cfg, seq, at=None):
    seq = torch.as_tensor(np.asarray(seq), dtype=torch.int64)
    at = torch.arange(len(seq)) if at is None else at
    return K.logits(p, seq, K.dims(cfg), Precision("fp32"), at, block=5)


def test_forward_matches_reference():
    """The non-paged forward (embedding, the stack with its dense first
    layer, the head) at every position."""
    cfg = tiny()
    p = weights(cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(1, 256, 23))
    with torch.no_grad():
        h, pos, _ = T._embed_inputs(p, {"tokens": toks[None]}, cfg)
        h, _ = T.run_stack(p, h, cfg, positions=pos)
        h = L.rmsnorm(h, p["final_norm"], cfg.norm_eps, cfg.compute_dtype)
        got = T.logits(p, h, cfg)[0]
    want = ref_logits(p, cfg, toks.numpy())
    assert (got - want).abs().max() <= TOL * want.abs().max()


def _serve(monkeypatch, cfg, p, fault=None):
    """Three requests through the engine, chunks of 8, a slot each: the
    engine, its requests and every logit it computed, by (slot, position
    of the token it predicts from).  ``fault`` "bf16_pool": the latent
    pool rounded to bfloat16 after every call."""
    got = {}
    prefill, decode = paged.prefill_chunk, paged.decode_batch

    def bf16(pool):
        if fault == "bf16_pool":
            pool["latent"].copy_(pool["latent"].to(torch.bfloat16).float())

    def pf(params, pool, tokens, start, width, row, scratch, c, scfg,
           slot=None):
        lg, pool = prefill(params, pool, tokens, start, width, row, scratch,
                           c, scfg, slot=slot)
        bf16(pool)
        if slot is not None:
            got[(slot, start + width - 1)] = lg[0, -1].clone()
        return lg, pool

    def dc(params, pool, tokens, lengths, tables, c, scfg):
        lg, pool = decode(params, pool, tokens, lengths, tables, c, scfg)
        bf16(pool)
        for s, n in enumerate(lengths.tolist()):
            if n > 0:
                got[(s, n)] = lg[s, -1].clone()
        return lg, pool

    monkeypatch.setattr(paged, "prefill_chunk", pf)
    monkeypatch.setattr(paged, "decode_batch", dc)
    eng = ServeEngine(build_model(cfg), p, slots=3, max_len=48,
                      block_size=8, chunk=8, device="cpu")
    eng.warmup()
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(1, 256, n).astype(np.int32), m)
            for i, (n, m) in enumerate(((19, 6), (5, 9), (30, 4)))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return eng, reqs, got


@pytest.mark.parametrize("fault", [None, "bf16_pool"],
                         ids=["sound", "bf16_pool"])
def test_engine_prefill_then_decode_matches_reference(monkeypatch, fault):
    """Every logit the engine computes, prefill chunks and decode steps
    through the latent pool, against the reference's full forward pass
    over the prompt and the tokens before it: within TOL of the largest
    logit; a latent pool rounded to bfloat16 fails it."""
    cfg = tiny()
    p = weights(cfg)
    eng, reqs, got = _serve(monkeypatch, cfg, p, fault)
    # chunks past a prompt's first ran while the other slot decoded
    assert any(sig[2] is not None and sig[2][2] > 0 and sig[3]
               for sig in eng.step_log)
    slot = {rid: s for sig in eng.step_log for rid, s in sig[1]}
    worst = 0.0
    for r in reqs:
        assert r.done and len(r.output) == r.max_new_tokens
        seq = np.concatenate([r.prompt, r.output[:-1]])
        n = len(r.prompt)
        want = ref_logits(p, cfg, seq, torch.arange(n - 1, len(seq)))
        mine = torch.stack([got[(slot[r.rid], n - 1 + k)]
                            for k in range(len(r.output))])
        worst = max(worst, float((mine - want).abs().max()
                                 / want.abs().max()))
    if fault is None:
        assert worst <= TOL
    else:
        assert worst > TOL


def test_engine_runs_every_layer_through_the_latent_pool(monkeypatch):
    """The pool holds one latent row a token a layer (no K/V), the MLA
    mixers run under ``mla.attn`` and no ``paged.kv_gather`` runs; the MoE
    layers take the dropless path over the held experts."""
    cfg = tiny()
    pool = paged.init_pool(cfg, paged.ServeConfig(slots=2, max_len=48,
                                                  block_size=8), "cpu")
    assert set(pool) == {"latent"}
    assert pool["latent"].shape == (3, 13, 8, 48)
    names = Counter()
    real = paged.prange

    def spy(name, *a, **k):
        names[name] += 1
        return real(name, *a, **k)

    M.reset_ep_calls()
    monkeypatch.setattr(paged, "prange", spy)
    _serve(monkeypatch, cfg, weights(cfg))
    assert names["mla.attn"] > 0 and names["paged.kv_gather"] == 0
    assert M.EP_CALLS.get("dropless", 0) > 0
    assert M.EP_CALLS.get("einsum", 0) == 0


def test_plain_kernel_matches_expanded_form():
    """The paged kernel's plain version (absorbed: scores over the latent
    rows, the latent's weighted sum) against the expanded form (per-head
    keys and values from kv_b), over a shuffled block table and mixed
    positions."""
    cfg = tiny()
    p = weights(cfg)["blocks"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    g = torch.Generator().manual_seed(3)
    s, bs = 21, 8
    x = torch.randn(1, s, cfg.d_model, generator=g)
    pos = torch.arange(s)[None]
    q_nope, q_pe, lat = MLA.project(p, x, cfg, pos)
    pages = torch.zeros(6, bs, lat.shape[-1])
    table = torch.tensor([[4, 1, 5]], dtype=torch.int32)
    for j in range(s):
        pages[table[0, j // bs], j % bs] = lat[0, j]
    q = MLA.absorb(p, q_nope, q_pe, cfg)
    at = torch.tensor([0, 7, 8, 20], dtype=torch.int32)
    o_lat = mla_attention_ref(q[at.long()], pages, table,
                              torch.zeros(4, dtype=torch.int32), at,
                              cfg.mla_kv_rank, MLA.softmax_scale(cfg))
    got = MLA.output(p, o_lat, cfg, (1, 4))[0]
    # the expanded form, as the published model computes it
    kvb = lat[0, :, :cfg.mla_kv_rank] @ p["wkv_b"]
    kvb = kvb.view(s, cfg.num_heads, -1)
    k = torch.cat([kvb[..., :cfg.mla_nope_dim], lat[0, :, None,
                   cfg.mla_kv_rank:].expand(s, cfg.num_heads, -1)], -1)
    v = kvb[..., cfg.mla_nope_dim:]
    qf = torch.cat([q_nope, q_pe], -1)[0]
    want = []
    for t in at.tolist():
        sc = torch.einsum("hd,jhd->hj", qf[t], k[:t + 1]) \
            * MLA.softmax_scale(cfg)
        o = torch.einsum("hj,jhv->hv", torch.softmax(sc, -1), v[:t + 1])
        want.append(o.flatten() @ p["wo"].flatten(0, 1))
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-5, atol=1e-5)


def test_sigmoid_routing_matches_reference_formulas():
    """Sigmoid scores in fp32, the top-k of the scores plus the bias, gates
    the chosen scores over their sum times the routed scaling; the held
    share's output equals the reference's expert part."""
    cfg = tiny()
    p = {k: v[0] for k, v in weights(cfg)["blocks"]["moe"].items()}
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    probs, gates, idx = M.route(p, x, cfg.moe)
    scores = torch.sigmoid(x[0] @ p["router"])
    want_idx = torch.topk(scores + p["router_bias"], 4).indices
    assert torch.equal(idx[0], want_idx)
    chosen = scores.gather(-1, want_idx)
    torch.testing.assert_close(
        gates[0], chosen / (chosen.sum(-1, keepdim=True) + 1e-20) * 2.5)
    torch.testing.assert_close(probs[0], scores)
    with torch.inference_mode():
        y, _ = M.moe_ffn(p, x, cfg.moe, "float32")
    want = K._moe(Precision("fp32"), p, x[0], K.dims(cfg))
    torch.testing.assert_close(y[0], want, rtol=1e-5, atol=1e-6)


def test_yarn_frequencies_and_scales_at_published_widths():
    """Kimi-K2's YaRN (theta 50,000, factor 32 over 4,096 positions, beta
    1 and 1, mscale 1 and 1) on 64 rotary dims: the correction range 19 to
    20, the frequencies below 19 as RoPE's, above 20 divided by 32, the
    softmax scale 192^-0.5 (0.1 ln 32 + 1)^2 and cos/sin unscaled."""
    cfg = dataclasses.replace(
        get_config("kimi-k2-1t-a32b"), mla_q_rank=1536, mla_kv_rank=512,
        mla_nope_dim=128, mla_rope_dim=64, mla_v_dim=128, yarn_factor=32.0,
        yarn_original_max=4096, yarn_beta_fast=1.0, yarn_beta_slow=1.0,
        yarn_mscale=1.0, yarn_mscale_all_dim=1.0)
    assert MLA.correction_range(cfg) == (19, 20)
    i = torch.arange(32, dtype=torch.float32)
    extra = 1.0 / 50_000 ** (2 * i / 64)
    mask = 1 - torch.clamp((i - 19) / (20 - 19), 0, 1)
    want = extra / 32 * (1 - mask) + extra * mask
    torch.testing.assert_close(MLA.rope_freqs(cfg, "cpu"), want)
    assert MLA.softmax_scale(cfg) == pytest.approx(
        192 ** -0.5 * (0.1 * math.log(32) + 1) ** 2, rel=1e-12)
    assert MLA.rope_scale(cfg) == 1.0
    inv, cs = K.yarn(K.dims(cfg), "cpu")
    torch.testing.assert_close(inv, want)
    assert cs == 1.0 and K.softmax_scale(K.dims(cfg)) == \
        pytest.approx(MLA.softmax_scale(cfg), rel=1e-12)


@pytest.mark.parametrize("grad", [False, True])
def test_shares_sum_to_the_whole_layer(grad):
    """16 experts in 4 shares of 4: each share's part of the layer (the
    dropless path without autograd, the einsum path with it) summed over
    the shares, the shared expert counted once, equals the uncut layer."""
    cfg = tiny(held_experts=0, held_offset=0)
    whole = {k: v[0] for k, v in weights(cfg)["blocks"]["moe"].items()}
    sh = {k: v[0] for k, v in weights(cfg)["blocks"]["shared_mlp"].items()}
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    with torch.set_grad_enabled(grad), torch.inference_mode(not grad):
        want = M.moe_ffn(whole, x, cfg.moe, "float32")[0] + \
            L.mlp(sh, x, "float32")
        parts = L.mlp(sh, x, "float32")
        for s in range(4):
            m = dataclasses.replace(cfg.moe, held_experts=4, held_offset=4 * s)
            p = dict(whole, **{k: whole[k][4 * s:4 * s + 4]
                               for k in ("wg", "wu", "wd")})
            parts = parts + M.moe_ffn(p, x, m, "float32")[0]
    torch.testing.assert_close(parts, want, rtol=1e-5, atol=1e-6)


def _aten_ops(fn) -> list[str]:
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return ops


def test_new_field_defaults_add_no_operation():
    """The paged qwen3-moe forward at the new fields' defaults runs exactly
    the operations of the same forward with a routed scaling on, less its
    one product a MoE layer."""
    cfg = dataclasses.replace(smoke_variant(get_config("qwen3-moe-235b-a22b")),
                              num_layers=2)
    p = build_model(cfg).init(torch.Generator().manual_seed(0))
    scfg = paged.ServeConfig(slots=2, max_len=32, block_size=8, chunk=8)
    row = torch.arange(1, scfg.max_blocks_per_slot + 1, dtype=torch.int32)
    toks = torch.ones((1, 8), dtype=torch.int32)

    def ops(c):
        pool = paged.init_pool(c, scfg, "cpu")
        with torch.inference_mode():
            return Counter(_aten_ops(lambda: paged.prefill_chunk(
                p, pool, toks, 0, 8, row, 0, c, scfg)))

    base = ops(cfg)
    on = ops(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, routed_scaling=2.0)))
    assert on - base == Counter({"aten.mul": cfg.num_layers})
    assert not base - on
