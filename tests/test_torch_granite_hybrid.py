"""granite-4.0-h-small, the hybrid Mamba-2 / attention / MoE family, served
by the port's paged engine, against the plain float32 reference
(``portbench/reference/granite_hybrid.py``: the published equations over a
whole sequence, the Mamba-2 mixer as its per-token recurrence) on seeded
random weights (``portbench/lib/hybrid_weights.py``) at a small size.

The engine serves three requests through the same entry points as every
family (``ServeEngine``, ``paged.prefill_chunk``, ``paged.decode_batch``):
two prompts prefill in several chunks while the other slots decode, and
every logit the engine computes is compared with the reference's at its
position.  Also: lanes that are not decoding keep their state through a
decode call; the bucket's right-padding leaves the state alone; the new
config fields' defaults add no operation to a qwen3, a jamba, a mamba2 or
a seamless forward, or to the pipelined step; jamba through the paged functions, also with no dense FFN;
the slot-sharded engine and the priced serve twin refuse the family; the
``mamba.mixer`` ranges, the SSD op calls and the engine's state resets.
"""
import dataclasses
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib.hybrid_weights import make_weights  # noqa: E402
from portbench.reference import granite_hybrid as G  # noqa: E402
from portbench.reference.common import Precision  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import paged  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.policy import ServeConfig  # noqa: E402

CPU = torch.device("cpu")
# Relative to the largest reference logit.  Program and reference compute
# in float32 throughout; they differ in the order of their sums (the
# chunked SSD scan against the token-by-token recurrence, the flash op's
# blocks, the capacity dispatch's one-hot products), measured at ~7e-7.
# A state stored in bfloat16 (8 mantissa bits) reads ~2e-3 here, a state
# lost at a chunk boundary ~1, so 1e-5 passes the first with ~14x room and
# fails both faults by 100x or more.
TOL = 1e-5
SERVE = dict(slots=3, max_len=64, block_size=8, chunk=8)


def tiny(num_layers=4, attn_every=2, attn_offset=1):
    """granite-4.0-h-small cut to a CPU size, in float32: every mechanism
    kept (NoPE attention at its offset, conv bias, the shared expert, the
    four scalings); capacity E/k, so no token is dropped."""
    base = get_config("granite-4.0-h-small")
    return dataclasses.replace(
        base, num_layers=num_layers, attn_every=attn_every,
        attn_offset=attn_offset, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, vocab_size=256, attention_multiplier=1 / 16,
        moe=dataclasses.replace(base.moe, num_experts=8, top_k=2,
                                d_ff_expert=32, d_ff_shared=48,
                                capacity_factor=4.0),
        mamba=dataclasses.replace(base.mamba, d_state=16, head_dim=16,
                                  chunk_size=16),
        param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def model_and_weights():
    cfg = tiny()
    model = build_model(cfg)
    layout, _ = model.abstract_params()
    return model, make_weights(layout, 1234, CPU, cfg.embedding_multiplier)


def _requests():
    rng = np.random.default_rng(0)
    return [Request(0, rng.integers(1, 256, 5).astype(np.int32), 12),
            Request(1, rng.integers(1, 256, 29).astype(np.int32), 6),
            Request(2, rng.integers(1, 256, 17).astype(np.int32), 5)]


def _serve(monkeypatch, model, weights, fault=None):
    """Serve :func:`_requests`; returns the engine, its requests and every
    logit it computed, by (slot, position of the token it predicts from).
    ``fault``: "state_reset" zeroes the slot's state before each chunk past
    the first; "bf16_state" rounds the state pool to bfloat16 after every
    call."""
    got = {}
    prefill, decode = paged.prefill_chunk, paged.decode_batch

    def bf16(pool):
        if fault == "bf16_state":
            st = pool["ssm"]["state"]
            st.copy_(st.to(torch.bfloat16).float())

    def pf(params, pool, tokens, start, width, row, scratch, cfg, scfg,
           slot=None):
        if fault == "state_reset" and slot is not None and start > 0:
            paged.reset_slot_state(pool, slot)
        lg, pool = prefill(params, pool, tokens, start, width, row, scratch,
                           cfg, scfg, slot=slot)
        bf16(pool)
        if slot is not None:
            got[(slot, start + width - 1)] = lg[0, -1].clone()
        return lg, pool

    def dc(params, pool, tokens, lengths, tables, cfg, scfg):
        lg, pool = decode(params, pool, tokens, lengths, tables, cfg, scfg)
        bf16(pool)
        for s, n in enumerate(lengths.tolist()):
            if n > 0:
                got[(s, n)] = lg[s, -1].clone()
        return lg, pool

    monkeypatch.setattr(paged, "prefill_chunk", pf)
    monkeypatch.setattr(paged, "decode_batch", dc)
    eng = ServeEngine(model, weights, device=CPU, **SERVE)
    eng.warmup()
    reqs = _requests()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return eng, reqs, got


def _worst_gap(eng, reqs, got, weights, cfg) -> float:
    """The largest |program - reference| logit over every served position,
    relative to the largest reference logit there."""
    slot = {rid: s for sig in eng.step_log for rid, s in sig[1]}
    d = G.dims(cfg)
    worst = 0.0
    for r in reqs:
        seq = torch.as_tensor(np.concatenate([r.prompt, r.output[:-1]]))
        ref = G.logits(weights, seq.long(), d, Precision("fp32"))
        p = len(r.prompt)
        mine = torch.stack([got[(slot[r.rid], p - 1 + k)]
                            for k in range(len(r.output))])
        want = ref[p - 1:p - 1 + len(r.output)]
        worst = max(worst, float((mine - want).abs().max()
                                 / want.abs().max()))
    return worst


@pytest.mark.parametrize("fault", [None, "state_reset", "bf16_state"],
                         ids=["sound", "state_reset", "bf16_state"])
def test_engine_against_reference(monkeypatch, model_and_weights, fault):
    model, weights = model_and_weights
    eng, reqs, got = _serve(monkeypatch, model, weights, fault)
    # chunks past a prompt's first ran while other slots decoded
    assert any(sig[2] is not None and sig[2][2] > 0 and sig[3]
               for sig in eng.step_log)
    assert all(r.done for r in reqs)
    worst = _worst_gap(eng, reqs, got, weights, model.cfg)
    if fault is None:
        assert worst <= TOL
    else:
        assert worst > TOL


def _filled_pool(cfg, scfg, seed=0):
    pool = paged.init_pool(cfg, scfg, CPU)
    g = torch.Generator().manual_seed(seed)
    for t in pool["ssm"].values():
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return pool


def test_lanes_not_decoding_keep_their_state(model_and_weights):
    """A decode call steps lane 0; lane 1 (a prompt mid-prefill), lane 2
    (idle) and the scratch lane come in with length 0 and keep their conv
    tails and fp32 state bit for bit."""
    model, weights = model_and_weights
    cfg = model.cfg
    scfg = ServeConfig(**SERVE)
    from repro_torch.models.build import compute_params

    params = compute_params(weights, cfg)
    pool = _filled_pool(cfg, scfg)
    before = {k: v.clone() for k, v in pool["ssm"].items()}
    mb = scfg.max_blocks_per_slot
    tables = torch.zeros((scfg.slots, mb), dtype=torch.int32)
    tables[0] = torch.arange(1, mb + 1)
    paged.decode_batch(params, pool, torch.tensor([[7], [0], [0]]),
                       torch.tensor([9, 0, 0], dtype=torch.int32), tables,
                       cfg, scfg)
    for k, v in pool["ssm"].items():
        assert not torch.equal(v[:, 0], before[k][:, 0]), k
        assert torch.equal(v[:, 1:], before[k][:, 1:]), k


def test_padding_leaves_the_state_alone(model_and_weights):
    """A chunk of 5 tokens padded to a bucket of 8 leaves the slot's state
    and tails where the same 5 tokens unpadded leave them."""
    model, weights = model_and_weights
    cfg = model.cfg
    scfg = ServeConfig(**SERVE)
    from repro_torch.models.build import compute_params

    params = compute_params(weights, cfg)
    row = torch.arange(1, scfg.max_blocks_per_slot + 1, dtype=torch.int32)
    toks = torch.tensor([[5, 9, 31, 2, 77]])
    out = []
    for pad in (0, 3):
        pool = _filled_pool(cfg, scfg)
        padded = torch.cat([toks, torch.zeros((1, pad), dtype=toks.dtype)],
                           dim=1)
        paged.prefill_chunk(params, pool, padded, 11, 5, row, 0, cfg, scfg,
                            slot=1)
        out.append(pool["ssm"])
    for k in out[0]:
        torch.testing.assert_close(out[0][k], out[1][k], rtol=0, atol=1e-6)


def test_warmup_leaves_every_slot_state_zero(model_and_weights):
    model, weights = model_and_weights
    eng = ServeEngine(model, weights, device=CPU, **SERVE)
    eng.warmup()
    for t in eng.pool["ssm"].values():
        assert not t[:, :SERVE["slots"]].any()
    # the warm-up's chunks ran in the scratch lane
    assert eng.pool["ssm"]["state"][:, SERVE["slots"]].any()


def test_state_pool_covers_only_what_each_layer_holds(model_and_weights):
    model, _ = model_and_weights
    cfg = model.cfg
    scfg = ServeConfig(**SERVE)
    pool = paged.init_pool(cfg, scfg, CPU)
    assert paged.attention_layers(cfg) == [1, 3]
    assert pool["k"].shape[0] == 2
    assert pool["ssm"]["state"].shape == (2, SERVE["slots"] + 1, 8, 16, 16)
    assert pool["ssm"]["state"].dtype == torch.float32


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


def _forward(cfg):
    """A qwen3 (dense stack, paged), jamba (hybrid superblocks), mamba2
    (SSM layers) or seamless (encoder-decoder) prefill and decode at smoke
    size; returns (aten ops, logits)."""
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    out = []
    if cfg.family in ("hybrid", "ssm", "audio"):
        kw = {}
        if cfg.family == "audio":
            kw["frames"] = torch.randn(
                1, cfg.source_len, cfg.frontend_dim,
                generator=torch.Generator().manual_seed(1))

        def fn():
            lg, cache = model.prefill(params, toks, max_len=16, **kw)
            out.append(lg)
            out.append(model.decode(params, cache, toks[:, :1], 8)[0])
    else:
        scfg = ServeConfig(slots=2, max_len=32, block_size=8, chunk=8)
        from repro_torch.models.build import compute_params

        cp = compute_params(params, cfg)
        pool = paged.init_pool(cfg, scfg, CPU)
        row = torch.arange(1, scfg.max_blocks_per_slot + 1,
                           dtype=torch.int32)

        def fn():
            out.append(paged.prefill_chunk(cp, pool, toks, 0, 8, row, 0,
                                           cfg, scfg)[0])
            out.append(paged.decode_batch(
                cp, pool, toks[:, :1].expand(2, 1).contiguous(),
                torch.tensor([8, 0], dtype=torch.int32),
                torch.stack([row, torch.zeros_like(row)]), cfg, scfg)[0])
    with torch.inference_mode():
        ops = _aten_ops(fn)
    return ops, out


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b", "mamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_new_field_defaults_add_no_operation(arch):
    """At the defaults the forward runs exactly the operations of the same
    forward with the scalings on, less the scalings' own products; and the
    softmax scale given explicitly as its default value changes no bit."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), num_layers=2)
    ops, logits = _forward(cfg)
    on = dataclasses.replace(cfg, embedding_multiplier=2.0,
                             residual_multiplier=0.5, logits_scaling=4.0)
    ops_on, _ = _forward(on)
    # per forward: the embedding, the residual branches of every layer (a
    # mixer and an FFN; the mixer alone in the ssm family; self and cross
    # attention and an FFN in an encoder-decoder's decoder), the logits;
    # the prefill also runs the encoder's two branches a layer
    branches = {"ssm": 1, "audio": 3}.get(cfg.family, 2)
    extra = Counter(ops_on) - Counter(ops)
    assert extra == Counter({
        "aten.mul": 2 * (1 + branches * cfg.num_layers)
        + 2 * cfg.encoder_layers, "aten.div": 2})
    assert not Counter(ops) - Counter(ops_on)
    scale = dataclasses.replace(
        cfg, attention_multiplier=1.0 / cfg.resolved_head_dim ** 0.5)
    _, same = _forward(scale)
    assert all(torch.equal(a, b) for a, b in zip(logits, same))


def test_new_field_defaults_add_no_operation_to_the_pipelined_step():
    """The pipelined step (pp 2, two microbatches, 1F1B) embeds, adds its
    residual branches and reads its head through the same functions: with
    the scalings on it runs the same operations plus their products, a
    ``mul`` for the embedding and each block's two branches, forward and
    backward, in every microbatch, and the logits' ``div``s."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import pipeline
    from repro_torch.models.build import make_concrete_batch

    cfg = dataclasses.replace(
        smoke_variant(get_config("llama3.2-1b")), num_layers=4, d_model=64,
        num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256,
        remat_policy="none")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = make_concrete_batch(cfg, ShapeConfig("ops", 16, 4, "train"),
                                device="cpu")
    mesh = make_mesh((2,), ("stage",), device="cpu")

    def step_ops(c):
        plan = pipeline.make_plan(c, 2, 2, schedule="1f1b")
        return Counter(_aten_ops(lambda: pipeline.pipeline_loss_and_grads(
            plan, params, batch, mesh)))

    ops = step_ops(cfg)
    extra = step_ops(dataclasses.replace(
        cfg, embedding_multiplier=2.0, residual_multiplier=0.5,
        logits_scaling=4.0)) - ops
    assert set(extra) == {"aten.mul", "aten.div"}
    assert extra["aten.mul"] == 2 * 2 * (1 + 2 * cfg.num_layers)


def test_slot_sharded_engine_refuses_the_hybrid(model_and_weights):
    from repro_torch.dist.mesh import make_mesh

    model, weights = model_and_weights
    mesh = make_mesh((2,), ("serve",), "cpu")
    with pytest.raises(ValueError, match="hybrid"):
        ServeEngine(model, weights, device=CPU, mesh=mesh,
                    **dict(SERVE, slots=2))


def test_priced_twin_refuses_the_hybrid(model_and_weights):
    from repro_torch.core.database import ProfileDB
    from repro_torch.serve.cost import calibrate_serve

    model, weights = model_and_weights
    paged.check_family(model.cfg)          # the paged forward serves it
    with pytest.raises(ValueError, match="priced serve twin"):
        calibrate_serve(ProfileDB(), model, weights, ServeConfig(**SERVE),
                        device="cpu")


def test_granite_config_counts():
    cfg = get_config("granite-4.0-h-small")
    assert paged.attention_layers(cfg) == [5, 15, 25, 35]
    assert round(cfg.num_params() / 1e9, 1) == 32.2        # "32B-A9B"
    assert round(cfg.active_params() / 1e9, 1) == 8.8
    half = dataclasses.replace(cfg, num_layers=20)
    assert round(half.num_params() / 1e9, 2) == 16.31


# -- tracing --------------------------------------------------------------------


def _events(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def test_mixer_ranges_and_ssd_calls_a_call():
    """At the cell's pattern (20 layers, attention at 5 and 15): a chunk
    call holds 18 ``mamba.mixer`` ranges, each around one SSD op call; a
    decode call 18 ranges and no SSD call."""
    cfg = dataclasses.replace(tiny(20, 10, 5), vocab_size=64)
    model = build_model(cfg)
    layout, _ = model.abstract_params()
    eng = ServeEngine(model, make_weights(layout, 5, CPU), device=CPU,
                      **SERVE)
    scfg, row = eng.serve_cfg, torch.from_numpy(eng._tables[0])
    toks = torch.arange(1, 9)[None]
    with torch.inference_mode():
        chunk = _events(lambda: paged.prefill_chunk(
            eng.params, eng.pool, toks, 0, 8, row, 0, cfg, scfg, slot=0))
        decode = _events(lambda: paged.decode_batch(
            eng.params, eng.pool, toks[:, :3].T.contiguous(),
            torch.tensor([8, 0, 0], dtype=torch.int32),
            torch.from_numpy(eng._tables), cfg, scfg))
    for events, ssd in ((chunk, 18), (decode, 0)):
        mixers = [e for e in events if e[0] == "mamba.mixer"]
        calls = [e for e in events if e[0] == "repro_torch::ssd_scan"]
        assert len(mixers) == 18 and len(calls) == ssd
        assert all(any(m[1] <= c[1] and c[2] <= m[2] for m in mixers)
                   for c in calls)


def test_state_resets_equal_admissions(model_and_weights):
    model, weights = model_and_weights
    eng = ServeEngine(model, weights, device=CPU, **SERVE)
    reqs = _requests() + [Request(3, np.arange(1, 12, dtype=np.int32), 3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    admitted = sum(len(sig[1]) for sig in eng.step_log)
    assert eng.state_resets == admitted == len(reqs)


def test_jamba_paged_matches_its_non_paged_forward():
    """The other hybrid the port registers (attention at offset 0, a dense
    MLP and an MoE on alternate layers) through the paged functions: two
    chunks then a decode step, against ``models.hybrid``'s whole-prompt
    prefill and its decode step, in float32; capacity E/k, so no dispatch
    group drops a choice whatever tokens it holds."""
    _jamba_paged_against_non_paged()


def test_jamba_without_dense_ffn_paged_matches_its_non_paged_forward():
    """The same with ``d_ff`` 0: the layers without an MoE have no FFN at
    all, in the paged forward as in the non-paged one."""
    _jamba_paged_against_non_paged(d_ff=0)


def _jamba_paged_against_non_paged(**changes):
    from repro_torch.models.build import compute_params

    cfg = smoke_variant(get_config("jamba-1.5-large-398b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k),
        **changes)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    cp = compute_params(params, cfg)
    scfg = ServeConfig(slots=2, max_len=32, block_size=8, chunk=8)
    pool = paged.init_pool(cfg, scfg, CPU)
    row = torch.arange(1, scfg.max_blocks_per_slot + 1, dtype=torch.int32)
    toks = torch.tensor([[7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 11, 13, 1]])
    with torch.inference_mode():
        paged.prefill_chunk(cp, pool, toks[:, :8], 0, 8, row, 0, cfg, scfg,
                            slot=1)
        got, _ = paged.prefill_chunk(
            cp, pool, torch.cat([toks[:, 8:], torch.zeros((1, 3),
                                                          dtype=toks.dtype)],
                                dim=1), 8, 5, row, 0, cfg, scfg, slot=1)
        want, cache = model.prefill(params, toks, max_len=32)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        nxt = torch.tensor([[12], [12]])
        got, _ = paged.decode_batch(
            cp, pool, nxt, torch.tensor([0, 13], dtype=torch.int32),
            torch.stack([torch.zeros_like(row), row]), cfg, scfg)
        want, _ = model.decode(params, cache, nxt[:1], 13)
        torch.testing.assert_close(got[1], want[0], rtol=1e-5, atol=1e-5)
