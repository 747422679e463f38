"""MoE in the port's paged serving path, on the CPU.

* ``check_family`` accepts and refuses the same configs as the JAX
  package's ``repro.serve.paged.check_family``;
* the analytic serve-cost terms of an MoE config (active-parameter bytes,
  flops a token, a step's features) equal the JAX package's for the
  published qwen3-moe-235b-a22b, its smoke variant and the chip's depth cut;
* ``prefill_chunk`` / ``decode_batch`` on the smoke qwen3-moe equal the
  port's sequential greedy decode (``Model.prefill`` / ``decode``) at a
  capacity no dispatch group can overflow: a prefill chunk routes its
  bucket, a decode step one token a slot, and a whole-prompt prefill the
  whole prompt, so where the capacity binds they keep different tokens
  (ROADMAP C1);
* the engine at the config's capacity against the priced twin on the
  synthetic DB: the same step compositions, step for step, and the
  launcher's ``--parity`` verdict.

fp32; logits within 1e-4.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.serve import cost as jax_cost  # noqa: E402
from repro.serve import paged as jax_paged  # noqa: E402
from repro.serve.policy import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core.database import ProfileDB  # noqa: E402
from repro_torch.core.estimator import OpTimeEstimator  # noqa: E402
from repro_torch.core.hardware import CPU_HOST  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine, cost, paged  # noqa: E402
from repro_torch.serve.policy import ServeConfig  # noqa: E402
from repro_torch.serve.sim import simulate_serve  # noqa: E402
from repro_torch.serve.trace import TraceRequest  # noqa: E402

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"
TOL = dict(rtol=1e-4, atol=1e-4)
SERVE = dict(slots=2, max_len=48, block_size=8, chunk=8)


def _smoke(configs, roomy=False):
    cfg = dataclasses.replace(
        configs.smoke_variant(configs.get_config(ARCH)), num_layers=2)
    if roomy:
        # capacity factor E / k: C = group, no expert of any group overflows
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    return cfg


def _chip_cut(configs):
    """The chip's depth cut: the published widths, 4 of 94 layers."""
    return dataclasses.replace(configs.get_config(ARCH), num_layers=4)


@pytest.fixture(scope="module")
def model_and_params():
    model = build_model(_smoke(port_configs, roomy=True))
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_check_family_agrees_with_jax(arch):
    """The port refuses what the JAX package refuses, except the hybrid
    family, which the port's paged forward serves from a state pool."""
    for configs_of in (lambda c: c.get_config(arch),
                       lambda c: c.smoke_variant(c.get_config(arch))):
        jcfg, tcfg = configs_of(jax_configs), configs_of(port_configs)
        try:
            jax_paged.check_family(jcfg)
            refused = False
        except ValueError:
            refused = True
        if refused and tcfg.family != "hybrid":
            with pytest.raises(ValueError, match=tcfg.family):
                paged.check_family(tcfg)
        else:
            paged.check_family(tcfg)
    assert paged.SUPPORTED_FAMILIES == \
        jax_paged.SUPPORTED_FAMILIES + ("hybrid",)


@pytest.mark.parametrize("cfg_of", [
    lambda c: c.get_config(ARCH), lambda c: _smoke(c), _chip_cut],
    ids=["published", "smoke", "chip-cut"])
def test_moe_serve_cost_terms_equal_jax(cfg_of):
    jcfg, tcfg = cfg_of(jax_configs), cfg_of(port_configs)
    kw = dict(slots=8, max_len=2048, block_size=16, chunk=256)
    jscfg, tscfg = JaxServeConfig(**kw), ServeConfig(**kw)
    assert [cost._is_moe_layer(tcfg, i) for i in range(tcfg.num_layers)] == \
        [jax_cost._is_moe_layer(jcfg, i) for i in range(jcfg.num_layers)]
    assert all(cost._is_moe_layer(tcfg, i) for i in range(tcfg.num_layers))
    assert cost._param_bytes(tcfg) == jax_cost._param_bytes(jcfg)
    for view in (16, 2048):
        assert cost._flops_per_token(tcfg, view) == \
            jax_cost._flops_per_token(jcfg, view)
    for fam, x in ((cost.FAMILY_PREFILL, 256), (cost.FAMILY_DECODE, 8)):
        assert cost.serve_node_features(tcfg, tscfg, fam, x) == \
            jax_cost.serve_node_features(jcfg, jscfg, fam, x)


def _sequential(model, params, prompt, n_new, max_len):
    """Whole-prompt ``Model.prefill`` and one-token ``decode``, greedy: the
    tokens and each step's logits."""
    logits, cache = model.prefill(params, torch.from_numpy(prompt[None]),
                                  max_len)
    out = [logits]
    clen = len(prompt)
    for _ in range(n_new - 1):
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        logits, cache = model.decode(params, cache, tok, clen)
        out.append(logits)
        clen += 1
    return out


def test_prefill_chunk_and_decode_batch_match_sequential_decode(
        model_and_params, rng):
    """Two requests (prompts 13 and 6, chunks of 8) prefilled chunk by chunk
    into the pool, then decoded together, four steps: every step's logits
    against each request's sequential decode."""
    model, params = model_and_params
    cfg, scfg = model.cfg, ServeConfig(**SERVE)
    n_new = 5
    prompts = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
               for n in (13, 6)]
    want = [_sequential(model, params, p, n_new, SERVE["max_len"])
            for p in prompts]
    pool = paged.init_pool(cfg, scfg, "cpu")
    tables = torch.tensor([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]],
                          dtype=torch.int32)
    toks = []
    for slot, prompt in enumerate(prompts):
        start = 0
        while start < len(prompt):
            width = min(scfg.chunk, len(prompt) - start)
            chunk = np.zeros((1, scfg.bucket(width)), np.int32)
            chunk[0, :width] = prompt[start:start + width]
            logits, pool = paged.prefill_chunk(
                params, pool, torch.from_numpy(chunk), start, width,
                tables[slot], 0, cfg, scfg)
            start += width
        np.testing.assert_allclose(logits.numpy(), want[slot][0].numpy(),
                                   **TOL)
        toks.append(int(torch.argmax(logits[0, -1])))
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for step in range(1, n_new):
        logits, pool = paged.decode_batch(
            params, pool, torch.tensor(toks, dtype=torch.int32)[:, None],
            lengths, tables, cfg, scfg)
        for slot in range(2):
            np.testing.assert_allclose(logits[slot:slot + 1].numpy(),
                                       want[slot][step].numpy(), **TOL)
        toks = torch.argmax(logits[:, -1], -1).tolist()
        lengths = lengths + 1


def test_engine_matches_sequential_greedy(model_and_params, rng):
    model, params = model_and_params
    prompts = [rng.integers(1, model.cfg.vocab_size, n, dtype=np.int32)
               for n in (21, 9, 14)]
    eng = ServeEngine(model, params, device="cpu", **SERVE)
    eng.warmup()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
    done = {r.rid: r.output for r in eng.run_until_done()}
    for rid, p in enumerate(prompts):
        want = [int(torch.argmax(lg[0, -1]))
                for lg in _sequential(model, params, p, 5, SERVE["max_len"])]
        assert done[rid] == want


def test_engine_compositions_equal_the_priced_twin(rng):
    """At the config's capacity (drops allowed): the engine and the DES twin
    priced from the synthetic serve grid plan the same steps."""
    cfg = _smoke(port_configs)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    trace = [TraceRequest(rid=i, arrival_s=0.0, prompt_len=n,
                          max_new_tokens=m)
             for i, (n, m) in enumerate(((21, 5), (9, 7), (14, 3), (30, 4)))]
    scfg = ServeConfig(**SERVE)
    eng = ServeEngine(model, params, device="cpu", **SERVE)
    for t in trace:
        eng.submit(Request(rid=t.rid, prompt=rng.integers(
            1, cfg.vocab_size, t.prompt_len, dtype=np.int32),
            max_new_tokens=t.max_new_tokens, arrival_s=t.arrival_s))
    eng.run_until_done()
    db = ProfileDB()
    cost.synthetic_serve_calibration(db, cfg.name, views=(scfg.view_len,))
    sim = simulate_serve(trace, cfg, scfg,
                         OpTimeEstimator(CPU_HOST, db=db, use_learned=False))
    assert eng.step_log == sim.step_log
    assert any(s[2] is not None for s in eng.step_log)
    assert any(s[3] for s in eng.step_log)


def test_launch_serve_parity_on_the_smoke_moe(capsys):
    """``launch.serve --arch qwen3-moe-235b-a22b --smoke --device cpu``:
    engine, replay twin and priced twin, one parity verdict (compositions
    exact; the latency half compares against the synthetic grid, hence the
    loose tolerance)."""
    rc = serve_launcher.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--trace", "poisson",
        "--requests", "6", "--max-len", "64", "--chunk", "8",
        "--block-size", "8", "--parity", "--synthetic-db",
        "--tol-rel", "1e9"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "qwen3-moe-235b-a22b" in out


def test_compute_params_casts_experts_once_and_keeps_the_router(rng):
    """The serving copy of an MoE model: expert and attention weights in
    the compute dtype, the router fp32 (routing is fp32); the same numbers
    as casting at every use."""
    from repro_torch.models import compute_params

    cfg = dataclasses.replace(_smoke(port_configs), compute_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    cast = compute_params(params, cfg)
    for k in ("wg", "wu", "wd"):
        assert cast["blocks"]["moe"][k].dtype == torch.bfloat16
    assert cast["blocks"]["moe"]["router"].dtype == torch.float32
    assert cast["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 9),
                                           dtype=np.int32))
    assert torch.equal(model.prefill(params, tokens)[0],
                       model.prefill(cast, tokens)[0])
