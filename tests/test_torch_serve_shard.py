"""The slot-sharded decode (the engine's ``mesh``) against the JAX engine's.

The JAX engine shards its decode batch over a ``("serve",)`` mesh of real
devices: a subprocess with four forced CPU devices runs it on the smoke
llama (2 layers, fp32) over a trace whose requests all arrive at 0, with a
deterministic clock, and records its parameters, every decode call's logits,
the step log and each request's tokens.  The port's engine runs the same
trace from those parameters with its decode split over a ``("serve",)``
mesh of 4 logical CPU ranks.  Tokens and step compositions must be equal,
the logits of every decode within 1e-5.  On the CPU in fp32 the sharded
decode also equals the port's unsharded decode within 1e-5 with the same
tokens.

Also: the placement (one rank's lanes, views of the batch, the same params
and pool for ranks on one device), ``calibrate_serve(mesh=)``, and the
serve launcher's ``--shard --ranks`` with the rest of its new flags.
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core.database import ProfileDB  # noqa: E402
from repro_torch.dist.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.serve import Request, ServeEngine, paged  # noqa: E402
from repro_torch.serve.cost import calibrate_serve  # noqa: E402
from repro_torch.serve.policy import ServeConfig  # noqa: E402
from repro_torch.tree import leaves, unflatten_like  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LAYERS = 2
KW = dict(slots=8, max_len=64, block_size=8, chunk=8)
# (prompt length, new tokens): 10 requests over 8 slots, every arrival at 0
REQS = [(21, 6), (9, 5), (3, 7), (14, 4), (30, 3), (6, 6), (17, 5),
        (11, 4), (25, 5), (5, 3)]
TOL = dict(rtol=1e-5, atol=1e-5)

_SCRIPT = textwrap.dedent(
    """
    import dataclasses, itertools, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.configs import base as C
    from repro.models import build_model
    from repro.serve.engine import Request, ServeEngine

    out_path, layers, kw, reqs = sys.argv[1:5]
    kw, reqs = eval(kw), eval(reqs)
    cfg = dataclasses.replace(C.smoke_variant(C.get_config("llama3.2-1b")),
                              num_layers=int(layers))
    model = build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    # Auto axes: with jax's default Explicit axes the JAX engine's decode
    # fails to trace its block-table gather (ROADMAP.md, C12)
    mesh = make_mesh((4,), ("serve",),
                     axis_types=(jax.sharding.AxisType.Auto,))
    ticks = itertools.count()
    eng = ServeEngine(model, params, mesh=mesh,
                      clock=lambda: next(ticks) * 1e-3, **kw)
    logits = []
    dec = eng._decode

    def decode(*a):
        out = dec(*a)
        logits.append(np.asarray(out[0]))
        return out

    eng._decode = decode
    rng = np.random.default_rng(0)
    out = {}
    for rid, (n, new) in enumerate(reqs):
        p = rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
        out[f"prompt/{rid}"] = p
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=new))
    done = {r.rid: r for r in eng.run_until_done()}
    for rid, r in done.items():
        out[f"tokens/{rid}"] = np.asarray(r.output)
    for j, x in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"params/{j}"] = np.asarray(x)
    out["logits"] = np.stack(logits)
    out["step_log"] = np.array(repr(eng.step_log))
    np.savez(out_path, **out)
    print("jax_sharded_serve_ok")
    """
)


def _cfg():
    return dataclasses.replace(
        port_configs.smoke_variant(port_configs.get_config("llama3.2-1b")),
        num_layers=LAYERS)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_shard") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, path, str(LAYERS), repr(KW),
         repr(REQS)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "jax_sharded_serve_ok" in out.stdout
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def model_params(jax_run):
    model = build_model(_cfg())
    like, _ = model.abstract_params()
    flat = [jax_run[f"params/{j}"] for j in range(len(leaves(like)))]
    return model, load_jax_params(unflatten_like(like, flat), device="cpu")


def _run_port(model, params, ref, mesh):
    ticks = itertools.count()
    eng = ServeEngine(model, params, device="cpu", mesh=mesh,
                      clock=lambda: next(ticks) * 1e-3, **KW)
    logits = []
    dec = eng._decode

    def decode(*a):
        out = dec(*a)
        logits.append(out[0].numpy().copy())
        return out

    eng._decode = decode
    for rid, (_, new) in enumerate(REQS):
        eng.submit(Request(rid=rid, prompt=ref[f"prompt/{rid}"],
                           max_new_tokens=new))
    done = {r.rid: r for r in eng.run_until_done()}
    return eng, done, np.stack(logits)


def test_sharded_engine_matches_jax_sharded_engine(jax_run, model_params):
    model, params = model_params
    mesh = make_mesh((4,), ("serve",), "cpu")
    eng, done, logits = _run_port(model, params, jax_run, mesh)
    assert repr(eng.step_log) == str(jax_run["step_log"])
    for rid in range(len(REQS)):
        assert done[rid].output == jax_run[f"tokens/{rid}"].tolist()
    assert logits.shape == jax_run["logits"].shape
    np.testing.assert_allclose(logits, jax_run["logits"], **TOL)


def test_sharded_decode_matches_unsharded(jax_run, model_params):
    model, params = model_params
    sharded = _run_port(model, params, jax_run,
                        make_mesh((4,), ("serve",), "cpu"))
    plain = _run_port(model, params, jax_run, None)
    assert sharded[0].step_log == plain[0].step_log
    assert {r: d.output for r, d in sharded[1].items()} == \
        {r: d.output for r, d in plain[1].items()}
    np.testing.assert_allclose(sharded[2], plain[2], **TOL)


def test_ranks_on_one_device_share_params_and_pool(model_params):
    model, params = model_params
    mesh = make_mesh((4,), ("serve",), "cpu")
    eng = ServeEngine(model, params, device="cpu", mesh=mesh, **KW)
    assert list(eng._replicas) == [torch.device("cpu")]
    p, pool = eng._replicas[torch.device("cpu")]
    assert p is eng.params and pool is eng.pool
    eng.warmup()                      # runs the sharded decode too
    seen = []
    real = paged.decode_batch

    def spy(params, pool, tokens, lengths, tables, cfg, scfg):
        seen.append((params is eng.params, pool is eng.pool,
                     tokens.shape[0], tokens._base is not None))
        return real(params, pool, tokens, lengths, tables, cfg, scfg)

    paged.decode_batch = spy
    try:
        eng._decode(*(eng._tensor(a) for a in (
            np.zeros((8, 1), np.int32), np.zeros(8, np.int32),
            np.zeros_like(eng._tables))))
    finally:
        paged.decode_batch = real
    assert seen == [(True, True, 2, True)] * 4


@pytest.mark.parametrize("slots,ranks", [(6, 4), (3, 2)])
def test_slots_must_split_evenly(model_params, slots, ranks):
    model, params = model_params
    with pytest.raises(ValueError, match=r"--shard needs slots"):
        ServeEngine(model, params, device="cpu", slots=slots, max_len=64,
                    block_size=8, chunk=8,
                    mesh=make_mesh((ranks,), ("serve",), "cpu"))


def test_calibrate_serve_profiles_the_sharded_decode(model_params):
    model, params = model_params
    scfg = ServeConfig(**KW)
    calls = []
    real = paged.decode_slot_sharded

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    paged.decode_slot_sharded = spy
    try:
        db = ProfileDB()
        n = calibrate_serve(db, model, params, scfg, "cpu_host",
                            buckets=(8,), repeats=2, device="cpu",
                            mesh=make_mesh((4,), ("serve",), "cpu"))
    finally:
        paged.decode_slot_sharded = real
    assert n == 2 and calls
    (dec,) = db.entries("cpu_host", "serve_decode")
    assert dec.args["slots"] == 8 and dec.mean_s > 0


def test_serve_launcher_shard_and_new_flags(tmp_path, capsys, monkeypatch):
    import repro_torch.serve as serve_pkg
    from repro_torch.launch import serve as launcher

    shape = ["--smoke", "--device", "cpu", "--max-len", "64", "--chunk", "8",
             "--block-size", "8", "--slots", "4"]
    trace = str(tmp_path / "bursty.json")
    assert launcher.main(shape + ["--trace", "bursty", "--requests", "6",
                                  "--burst-size", "3", "--burst-gap",
                                  "0.002", "--trace-file", trace,
                                  "--save-trace"]) == 0
    assert len(json.load(open(trace))["requests"]) == 6
    report = str(tmp_path / "parity.json")
    assert launcher.main(shape + ["--trace-file", trace, "--parity",
                                  "--synthetic-db", "--tol-rel", "1e9",
                                  "--shard", "--ranks", "4", "--report",
                                  report]) == 0
    rep = json.load(open(report))
    assert rep["composition_ok"] and rep["run_spec"]["max_len"] == 64
    db = str(tmp_path / "db.json")
    assert launcher.main(shape + ["--calibrate", "--db", db, "--shard",
                                  "--ranks", "2"]) == 0
    assert "slot-sharded over 2 ranks" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="divisible"):
        launcher.main(shape + ["--trace-file", trace, "--shard", "--ranks",
                               "3"])
    # --eos-id reaches the engine
    eos = []

    class Engine(ServeEngine):
        def __init__(self, *a, **kw):
            eos.append(kw["eos_id"])
            super().__init__(*a, **kw)

    monkeypatch.setattr(serve_pkg, "ServeEngine", Engine)
    assert launcher.main(shape + ["--trace-file", trace, "--eos-id", "5",
                                  "--report", report]) == 0
    assert eos == [5]
    assert json.load(open(report))["engine_latency"]["requests"] == 6
