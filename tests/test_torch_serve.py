"""The port's serving path against the JAX package's, on the CPU.

* ``prefill_chunk`` / ``decode_batch``: logits and pool contents equal
  ``repro.serve.paged``'s (the port writes its pool in place; the JAX
  functions return a new one);
* the engine on the dense chunked-prefill workload of
  tests/test_serve_engine.py, with a deterministic injected clock: the same
  step compositions, step durations and tokens as ``repro``'s engine;
* the engine against the port's own sequential greedy decode, EOS early exit
  included (the JAX EOS test fails on this tree, ROADMAP C1, so the port's
  greedy loop is the oracle there);
* ``calibrate_serve`` writes entries of the same families and args.

2-layer smoke llama3.2-1b, fp32; logits within 1e-4.
"""
import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.core.database import ProfileDB as JaxDB  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import paged as jax_paged  # noqa: E402
from repro.serve.cost import calibrate_serve as jax_calibrate  # noqa: E402
from repro.serve.policy import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core.database import ProfileDB  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import paged  # noqa: E402
from repro_torch.serve.cost import calibrate_serve  # noqa: E402
from repro_torch.serve.policy import ServeConfig  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _tiny(configs):
    return dataclasses.replace(
        configs.smoke_variant(configs.get_config("llama3.2-1b")), num_layers=2
    )


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(_tiny(jax_configs))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, build_model(_tiny(port_configs)), tparams


def _fake_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def test_prefill_chunk_and_decode_batch_match_jax(pair, rng):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    kw = dict(slots=2, max_len=32, block_size=8, chunk=8)
    jscfg, tscfg = JaxServeConfig(**kw), ServeConfig(**kw)
    jpool = jax_paged.init_pool(jmodel.cfg, jscfg)
    tpool = paged.init_pool(cfg, tscfg, "cpu")
    # slot 0 owns blocks 1..4, slot 1 owns 5..8; 0 is scratch
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    prompts = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
               for n in (13, 6)]
    for slot, prompt in enumerate(prompts):
        start = 0
        while start < len(prompt):
            width = min(8, len(prompt) - start)
            bucket = tscfg.bucket(width)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :width] = prompt[start:start + width]
            jl, jpool = jax_paged.prefill_chunk(
                jparams, jpool, jnp.asarray(toks), jnp.int32(start),
                jnp.int32(width), jnp.asarray(tables[slot]), 0, jmodel.cfg,
                jscfg)
            tl, tpool = paged.prefill_chunk(
                tparams, tpool, torch.from_numpy(toks), start, width,
                torch.from_numpy(tables[slot]), 0, cfg, tscfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            start += width
    lengths = np.asarray([13, 6], np.int32)
    toks = rng.integers(1, cfg.vocab_size, (2, 1), dtype=np.int32)
    jl, jpool = jax_paged.decode_batch(
        jparams, jpool, jnp.asarray(toks), jnp.asarray(lengths),
        jnp.asarray(tables), jmodel.cfg, jscfg)
    tl, tpool2 = paged.decode_batch(
        tparams, tpool, torch.from_numpy(toks), torch.from_numpy(lengths),
        torch.from_numpy(tables), cfg, tscfg)
    assert tpool2 is tpool      # written in place, same dict returned
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpool[k].numpy(), np.asarray(jpool[k]),
                                   **TOL)


def test_engine_matches_jax_engine_step_for_step(pair, rng):
    """tests/test_serve_engine.py's dense chunked-prefill workload (prompts
    21 and 9, chunk 8, two slots), with the second request arriving later
    so the injected clock drives admission."""
    jmodel, jparams, tmodel, tparams = pair
    prompts = [rng.integers(1, tmodel.cfg.vocab_size, 21, dtype=np.int32),
               rng.integers(1, tmodel.cfg.vocab_size, 9, dtype=np.int32)]
    arrivals = [0.0, 0.0035]
    kw = dict(slots=2, max_len=48, block_size=8, chunk=8)
    jeng = JaxEngine(jmodel, jparams, clock=_fake_clock(), **kw)
    teng = ServeEngine(tmodel, tparams, clock=_fake_clock(), device="cpu",
                       **kw)
    for rid, (p, t) in enumerate(zip(prompts, arrivals)):
        jeng.submit(JaxRequest(rid=rid, prompt=p, max_new_tokens=5,
                               arrival_s=t))
        teng.submit(Request(rid=rid, prompt=p, max_new_tokens=5,
                            arrival_s=t))
    jdone = {r.rid: r for r in jeng.run_until_done()}
    tdone = {r.rid: r for r in teng.run_until_done()}
    assert teng.step_log == jeng.step_log
    assert teng.step_durations == jeng.step_durations
    for rid in jdone:
        assert tdone[rid].output == jdone[rid].output
        assert tdone[rid].token_times_s == jdone[rid].token_times_s
        assert tdone[rid].ttft_s == jdone[rid].ttft_s


def _greedy(model, params, prompt, n_tokens, max_len):
    """The port's sequential whole-prompt prefill + one-token decode loop."""
    logits, cache = model.prefill(params, torch.from_numpy(prompt[None]),
                                  max_len)
    toks = [int(torch.argmax(logits[0, -1]))]
    clen = len(prompt)
    for _ in range(n_tokens - 1):
        logits, cache = model.decode(
            params, cache, torch.tensor([[toks[-1]]], dtype=torch.int32), clen)
        toks.append(int(torch.argmax(logits[0, -1])))
        clen += 1
    return toks


def test_engine_matches_sequential_greedy(pair, rng):
    _, _, tmodel, tparams = pair
    prompts = [rng.integers(1, tmodel.cfg.vocab_size, n, dtype=np.int32)
               for n in (21, 9, 14)]
    eng = ServeEngine(tmodel, tparams, slots=2, max_len=48, block_size=8,
                      chunk=8, device="cpu")
    eng.warmup()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
    done = {r.rid: r.output for r in eng.run_until_done()}
    for rid, p in enumerate(prompts):
        assert done[rid] == _greedy(tmodel, tparams, p, 5, 48)


def test_engine_eos_early_exit(pair, rng):
    """The engine, like the JAX one, checks EOS on decode tokens only: a
    request stops after the first decoded EOS, while a first (prefill)
    token equal to EOS does not stop it.  On this workload the free run
    repeats one token, so the prefill token is EOS too — which is why
    tests/test_serve_engine.py::test_engine_eos_early_exit, expecting the
    stop at the prefill token, fails on this tree (ROADMAP C1)."""
    _, _, tmodel, tparams = pair
    prompt = rng.integers(1, tmodel.cfg.vocab_size, 8, dtype=np.int32)
    free_run = _greedy(tmodel, tparams, prompt, 8, 32)
    eos = free_run[2]
    eng = ServeEngine(tmodel, tparams, slots=1, max_len=32, block_size=8,
                      eos_id=eos, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=8))
    got = eng.run_until_done()[0].output
    assert len(got) < len(free_run)
    assert got == free_run[: free_run.index(eos, 1) + 1]
    # every block came back to the allocator
    assert eng.sched.allocator.num_free == eng.sched.allocator.num_blocks - 1


def test_calibrate_serve_same_families_and_args(pair):
    jmodel, jparams, tmodel, tparams = pair
    kw = dict(slots=2, max_len=32, block_size=8, chunk=4)
    jdb, tdb = JaxDB(), ProfileDB()
    nj = jax_calibrate(jdb, jmodel, jparams, JaxServeConfig(**kw), repeats=1)
    nt = calibrate_serve(tdb, tmodel, tparams, ServeConfig(**kw), "cpu_host",
                         repeats=1, device="cpu")
    assert nt == nj
    assert tdb.op_families("cpu_host") == jdb.op_families("cpu_host")
    for fam in jdb.op_families("cpu_host"):
        assert [e.args for e in tdb.entries("cpu_host", fam)] == \
            [e.args for e in jdb.entries("cpu_host", fam)]
        for te, je in zip(tdb.entries("cpu_host", fam),
                          jdb.entries("cpu_host", fam)):
            assert (te.flops, te.bytes, te.n) == (je.flops, je.bytes, je.n)
            assert te.mean_s > 0
    tmeta = tdb.meta("cpu_host")["serve"]
    jmeta = jdb.meta("cpu_host")["serve"]
    assert tmeta["backend"] == "cpu"
    assert {k: v for k, v in tmeta.items() if k != "backend"} == \
        {k: v for k, v in jmeta.items() if k != "backend"}


@pytest.mark.parametrize("context", [20, 40])
def test_calibrate_serve_times_steps_at_the_context(pair, monkeypatch,
                                                    context):
    """``context`` moves where the timed chunks start and how long the
    decode lanes are (clamped into the view), and leaves the DB keys as
    they are at context 0."""
    _, _, tmodel, tparams = pair
    scfg = ServeConfig(slots=2, max_len=32, block_size=8, chunk=4)
    seen = {"starts": set(), "lengths": set()}
    prefill, decode = paged.prefill_chunk, paged.decode_batch

    def spy_prefill(params, pool, toks, start, *a):
        seen["starts"].add((toks.shape[1], start))
        return prefill(params, pool, toks, start, *a)

    def spy_decode(params, pool, toks, lengths, *a):
        seen["lengths"].update(lengths.tolist())
        return decode(params, pool, toks, lengths, *a)

    monkeypatch.setattr(paged, "prefill_chunk", spy_prefill)
    monkeypatch.setattr(paged, "decode_batch", spy_decode)
    db = ProfileDB()
    calibrate_serve(db, tmodel, tparams, scfg, "cpu_host", repeats=1,
                    device="cpu", context=context)
    assert seen["starts"] == {(b, min(context, scfg.view_len - b))
                              for b in (1, 2, 4)}
    assert seen["lengths"] == {min(context, scfg.view_len - 1)}
    monkeypatch.undo()
    db0 = ProfileDB()
    calibrate_serve(db0, tmodel, tparams, scfg, "cpu_host", repeats=1,
                    device="cpu")
    for fam in db0.op_families("cpu_host"):
        assert [e.args for e in db.entries("cpu_host", fam)] == \
            [e.args for e in db0.entries("cpu_host", fam)]
