"""The paged latent-attention kernel and the held-expert MoE kernels on a
card (marked ``cuda``; they skip without one).  Run them on the card with::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_mla_cuda.py

(``--noconftest``: the shared conftest imports JAX.)  Every case runs at
the Kimi-K2 cell's widths: 64 heads, latent rows of 512 + 64, pages of 64.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.cuda

H, WIDTH, RANK, PAGE = 64, 576, 512, 64
# bf16 output of an fp32 softmax-weighted mean whose weights the kernel
# rounds to bf16 once (as flash-style kernels do): a few bf16 ulps
TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _pool(dev, lanes: int, max_len: int, seed: int):
    """A latent pool layer of random rows, each lane's pages scattered over
    it (a shuffled block table), and the tables."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mb = -(-max_len // PAGE)
    blocks = lanes * mb + 1
    pages = torch.randn(blocks, PAGE, WIDTH, generator=g, device=dev)
    perm = torch.randperm(blocks - 1, generator=g, device=dev) + 1
    tables = perm[:lanes * mb].view(lanes, mb).to(torch.int32)
    return pages.to(torch.bfloat16), tables


def _check(dev, lanes, pos, max_len, seed=0):
    from repro_torch.kernels.mla_attention import ops
    from repro_torch.kernels.mla_attention.ref import mla_attention_ref

    pages, tables = _pool(dev, int(max(lanes)) + 1, max_len, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    q = torch.randn(len(pos), H, WIDTH, generator=g, device=dev)
    q = q.to(torch.bfloat16)
    lane = torch.tensor(lanes, dtype=torch.int32, device=dev)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    scale = 192 ** -0.5 * (0.1 * np.log(32) + 1) ** 2
    n0 = ops.LAUNCHES.count
    got = ops.mla_attention(q, pages, tables, lane, pos, RANK, scale)
    torch.cuda.synchronize()
    splits = ops.launch_plan(len(lanes), H, tables.shape[1] * PAGE,
                             ops.sm_count(0))
    assert ops.LAUNCHES.count - n0 == 1 + (splits > 1)
    want = mla_attention_ref(q, pages, tables, lane, pos, RANK, scale)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("length", [1, 2047, 33000])
def test_mla_decode_one_lane(dev, length):
    """One token at position ``length`` - 1 of one lane."""
    _check(dev, [0], [length - 1], 33792)


def test_mla_decode_mixed_lanes(dev):
    """A decode call of 32 lanes at mixed lengths, idle lanes (position 0)
    among them, as the engine hands them."""
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 33000, 32)
    pos[[3, 17]] = 0
    pos[5], pos[9] = 2047, 63
    _check(dev, list(range(32)), pos.tolist(), 33792, seed=2)


@pytest.mark.parametrize("start,width", [(0, 2048), (6144, 2048),
                                         (30720, 100), (0, 1)])
def test_mla_prefill_chunk(dev, start, width):
    """A chunk of one lane's tokens at consecutive positions (causal within
    the chunk), as a prefill call hands them."""
    _check(dev, [0] * width, list(range(start, start + width)), 33792,
           seed=5)


def test_held_experts_match_plain_version(dev):
    """24 of 384 experts held (offset 24), Kimi's widths: the kernels'
    output equals the plain version's on the same routing, the other
    experts' choices adding nothing, and the routing table the plain
    one's."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels.moe_experts import ops as mx
    from repro_torch.kernels.moe_experts import ref
    from repro_torch.models import moe

    T, k, E, held, D, Fe = 64, 8, 384, 24, 7168, 2048
    m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=Fe, scoring="sigmoid",
                  score_bias=True, routed_scaling=2.827, held_experts=held,
                  held_offset=24)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(T, D, generator=g, device=dev).to(torch.bfloat16)
    p = {"router": torch.randn(D, E, generator=g, device=dev) / D ** 0.5,
         "router_bias": 0.02 * torch.randn(E, generator=g, device=dev)}
    for w, shape in (("wg", (held, D, Fe)), ("wu", (held, D, Fe)),
                     ("wd", (held, Fe, D))):
        p[w] = (torch.randn(shape, generator=g, device=dev)
                / shape[1] ** 0.5).to(torch.bfloat16)
    with torch.inference_mode():
        _, gate, idx = moe.route(p, x[None], m)
        idx = moe.held_choices(idx.reshape(T, k), m)
        gate = gate.reshape(T, k)
        assert (idx >= 0).any() and (idx < 0).any()
        rows = mx.route(idx, held, partial=True)
        want = ref.route_ref(idx, held, partial=True)
        for key in ("row_of", "offsets"):
            assert torch.equal(rows[key], want[key]), key
        n = int(want["offsets"][-1])
        assert torch.equal(rows["src_tok"][:n], want["src_tok"][:n])
        tiles = want["tiles"][:, 0] >= 0
        assert torch.equal(rows["tiles"][tiles], want["tiles"][tiles])
        got = mx.moe_experts(x, gate, idx, p["wg"], p["wu"], p["wd"],
                             partial=True)
        plain = ref.moe_experts_ref(x, gate, idx, p["wg"], p["wu"], p["wd"],
                                    partial=True)
        # every token with no held choice gets zeros
        none = (idx < 0).all(-1)
        assert none.any() and not got[none].any()
        torch.testing.assert_close(got, plain, rtol=2e-2, atol=2e-2)


def _mla_model(dev):
    """Two layers (a dense one, then an MoE one) at the cell's attention
    widths, with a narrow residual stream and few experts."""
    from repro_torch.configs.base import get_config

    cfg = get_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(
        cfg, num_layers=2, d_model=1024, num_kv_heads=64, d_ff=2048,
        vocab_size=4096, param_dtype="bfloat16", compute_dtype="bfloat16",
        mla_q_rank=1536, mla_kv_rank=512, mla_nope_dim=128, mla_rope_dim=64,
        mla_v_dim=128, yarn_factor=32.0, yarn_beta_fast=1.0,
        yarn_beta_slow=1.0, yarn_mscale_all_dim=1.0, norm_eps=1e-6,
        moe=dataclasses.replace(
            cfg.moe, num_experts=32, top_k=4, d_ff_expert=256,
            d_ff_shared=256, capacity_factor=8.0, scoring="sigmoid",
            score_bias=True, routed_scaling=2.5, first_dense=1,
            held_experts=8, held_offset=8))
    return cfg


def test_paged_mla_serving_matches_reference(dev):
    """Prefill in chunks of 256, then decode through the latent pool, on the
    card in bf16: every step's logits against the plain fp32 reference's
    full forward pass (``portbench/reference/kimi_mla.py``), two MLA
    launches a layer at most, no gather."""
    from portbench.reference import kimi_mla
    from portbench.reference.common import Precision, strict_fp32
    from repro_torch.kernels.mla_attention import ops
    from repro_torch.models import build_model
    from repro_torch.models.build import compute_params
    from repro_torch.serve import paged
    from repro_torch.serve.policy import ServeConfig

    cfg = _mla_model(dev)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    params["blocks"]["moe"]["router_bias"].normal_(
        generator=torch.Generator(device=dev).manual_seed(1)).mul_(0.02)
    cp = compute_params(params, cfg)
    scfg = ServeConfig(slots=2, max_len=1536, block_size=64, chunk=256)
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, 1000,
                                               dtype=np.int32)
    pool = paged.init_pool(cfg, scfg, dev)
    mb = scfg.max_blocks_per_slot
    table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)
    seq, steps = list(prompt), []
    with torch.inference_mode():
        start = 0
        while start < len(prompt):
            width = min(scfg.chunk, len(prompt) - start)
            toks = np.zeros((1, scfg.bucket(width)), np.int32)
            toks[0, :width] = prompt[start:start + width]
            logits, pool = paged.prefill_chunk(
                cp, pool, torch.as_tensor(toks, device=dev), start, width,
                table, 0, cfg, scfg)
            start += width
        steps.append(logits[0, -1].float())
        tables = torch.stack([table, torch.zeros_like(table)])
        for _ in range(8):
            tok = int(torch.argmax(steps[-1]))
            seq.append(tok)
            n0 = ops.LAUNCHES.count
            logits, pool = paged.decode_batch(
                cp, pool, torch.tensor([[tok], [0]], device=dev),
                torch.tensor([len(seq) - 1, 0], dtype=torch.int32,
                             device=dev), tables, cfg, scfg)
            assert ops.LAUNCHES.count - n0 <= 2 * cfg.num_layers
            steps.append(logits[0, -1].float())
    strict_fp32()
    d = kimi_mla.dims(cfg)
    ids = torch.as_tensor(np.asarray(seq), device=dev)
    at = torch.arange(len(prompt) - 1, len(seq), device=dev)
    ref = kimi_mla.logits(params, ids, d, Precision("fp32"), at)
    low = kimi_mla.logits(params, ids, d, Precision("fp8"), at)
    got = torch.stack(steps)
    # bf16 weights and activations against fp32 products: the logits' mean
    # distance from the fp32 reference's, relative to their spread, under
    # half of the same distance of the reference in float8
    err = float((got - ref).abs().mean() / ref.std())
    ctrl = float((low - ref).abs().mean() / ref.std())
    assert err < 0.5 * ctrl, (err, ctrl)
