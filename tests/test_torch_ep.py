"""The port's expert parallelism against the JAX package's.

  (a) ``moe_ffn`` with ``impl="ep_a2a"`` under a sharding context, on
      (data 4 x model 2) and (data 2 x model 2) meshes of logical CPU ranks,
      against the JAX package's ``moe_ffn_ep_a2a`` under ``shard_map`` on
      the same meshes of forced CPU devices (a subprocess with 8 of them):
      the layer of tests/test_multidevice_subprocess.py (8 experts top-2 of
      width 64, groups of 32, d_model 32, x (8, 16, 32)) at capacity factor
      8 (nothing dropped) and 1.25 (choices dropped).  y, aux and the
      gradients of the parameters and x within rtol 1e-4, atol 1e-5.  The
      subprocess also places a weight under ``NamedSharding``, and each
      device's shard equals the port's ``sharding.shards`` at that rank.
  (b) ``ep_a2a_feasible`` and ``a2a_payload_bytes`` equal the JAX
      package's over a grid of shapes and meshes.
  (c) The bytes the all-to-alls moved (``mesh.TRAFFIC["all_to_all"]``)
      equal the twin: two exchanges a layer, each rank's payload.
  (d) Under "full" remat the recompute in the backward re-enters the
      forward's sharding context, also when the backward runs on a thread
      that never entered it (as autograd's device thread does on the card).
  (e) The launcher trains the smoke qwen3-moe through ``--moe-impl ep_a2a``
      on 4 ranks with the losses of ``--moe-impl einsum``.

Inputs and weights are made with numpy from a seed and handed to both
packages.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs.base import MoEConfig as JaxMoE  # noqa: E402
from repro.dist import ep_a2a as jax_ep  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.dist import ep_a2a as ep  # noqa: E402
from repro_torch.dist import mesh as M  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    P,
    make_ctx,
    shards,
    use_sharding,
)
from repro_torch.tree import leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
D_MODEL, X_SHAPE = 32, (8, 16, 32)
LAYER = dict(num_experts=8, top_k=2, d_ff_expert=64, group_size=32)
# case name -> (mesh shape (data, model), capacity factor)
CASES = {"4x2_cf8": ((4, 2), 8.0), "2x2_cf8": ((2, 2), 8.0),
         "4x2_cf1.25": ((4, 2), 1.25), "2x2_cf1.25": ((2, 2), 1.25)}
RTOL, ATOL = 1e-4, 1e-5

_SCRIPT = textwrap.dedent(
    """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import MoEConfig
    from repro.models.moe import moe_ffn
    from repro.models.sharding import make_ctx, use_sharding

    in_path, out_path, layer, cases = sys.argv[1:5]
    layer, cases = eval(layer), eval(cases)
    z = dict(np.load(in_path))
    p = {k: jnp.asarray(z[k]) for k in ("router", "wg", "wu", "wd")}
    x, r = jnp.asarray(z["x"]), jnp.asarray(z["r"])
    out = {}
    for name, ((dp, tp), cf) in cases.items():
        mesh = jax.make_mesh((dp, tp), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:dp * tp])
        m = MoEConfig(capacity_factor=cf, impl="ep_a2a", **layer)
        specs = {"router": P(), "wg": P("data", None, "model"),
                 "wu": P("data", None, "model"),
                 "wd": P("data", "model", None)}
        with use_sharding(make_ctx(mesh)), mesh:
            ps = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
                  for k, v in p.items()}
            xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))

            def loss(ps, xs):
                y, aux = moe_ffn(ps, xs, m, jnp.float32)
                return jnp.sum(y * r) + aux, (y, aux)

            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(ps, xs)
        out[f"{name}/y"] = np.asarray(y)
        out[f"{name}/aux"] = np.asarray(aux)
        out[f"{name}/g/x"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"{name}/g/{k}"] = np.asarray(v)
        # where NamedSharding puts each device's shard of wd
        for sh in ps["wd"].addressable_shards:
            d, t = np.argwhere(mesh.devices == sh.device)[0]
            out[f"{name}/wd_shard/{d}{t}"] = np.asarray(sh.data)
    np.savez(out_path, **out)
    print("jax_ep_ok")
    """
)


def _layer_inputs():
    rng = np.random.default_rng(0)
    E, F = LAYER["num_experts"], LAYER["d_ff_expert"]

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return {"router": dense((D_MODEL, E), D_MODEL),
            "wg": dense((E, D_MODEL, F), D_MODEL),
            "wu": dense((E, D_MODEL, F), D_MODEL),
            "wd": dense((E, F, D_MODEL), F),
            "x": rng.standard_normal(X_SHAPE).astype(np.float32),
            "r": rng.standard_normal(X_SHAPE).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ep")
    inputs = _layer_inputs()
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), repr(LAYER), repr(CASES)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "jax_ep_ok" in out.stdout
    with np.load(d / "out.npz") as z:
        return inputs, dict(z)


def _port_layer(inputs):
    return {k: torch.tensor(inputs[k]).requires_grad_()
            for k in ("router", "wg", "wu", "wd")}


def _run_port(inputs, mesh_shape, cf, ctx_on=True):
    """(y, aux, {name: grad}, EP_CALLS) of the port's moe_ffn."""
    m = MoEConfig(capacity_factor=cf, impl="ep_a2a", **LAYER)
    params = _port_layer(inputs)
    x = torch.tensor(inputs["x"]).requires_grad_()
    mesh = M.make_mesh(mesh_shape, ("data", "model"), "cpu")
    moe.reset_ep_calls()
    with use_sharding(make_ctx(mesh) if ctx_on else None):
        y, aux = moe.moe_ffn(params, x, m, torch.float32)
    loss = (y * torch.tensor(inputs["r"])).sum() + aux
    names = sorted(params) + ["x"]
    grads = torch.autograd.grad(loss, [params[k] for k in sorted(params)]
                                + [x])
    return y.detach(), aux.detach(), dict(zip(names, grads)), \
        dict(moe.EP_CALLS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ep_moe_matches_jax_ep(jax_run, name):
    inputs, ref = jax_run
    mesh_shape, cf = CASES[name]
    y, aux, grads, calls = _run_port(inputs, mesh_shape, cf)
    assert calls == {"ep_a2a": 1}
    np.testing.assert_allclose(y.numpy(), ref[f"{name}/y"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(ref[f"{name}/aux"]),
                               rtol=RTOL, atol=ATOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[f"{name}/g/{k}"],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ep_moe_matches_einsum_path(jax_run, name):
    """At capacity parity the port's two paths agree, and at capacity
    factor 1.25 both drop the same choices (nothing is dropped at 8)."""
    inputs, _ = jax_run
    mesh_shape, cf = CASES[name]
    y, aux, grads, _ = _run_port(inputs, mesh_shape, cf)
    ye, auxe, grads_e, calls = _run_port(inputs, mesh_shape, cf,
                                         ctx_on=False)
    assert calls == {"einsum": 1}
    np.testing.assert_allclose(y.numpy(), ye.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(auxe), rtol=RTOL)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), grads_e[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    y8, *_ = _run_port(inputs, mesh_shape, 8.0, ctx_on=False)
    dropped = not torch.allclose(ye, y8, rtol=RTOL, atol=ATOL)
    assert dropped == (cf < 8.0)


@pytest.mark.parametrize("name", ["4x2_cf8", "2x2_cf8"])
def test_shards_are_named_sharding_shards(jax_run, name):
    """Each rank's ``shards`` piece of wd under P(data, model, None) is
    what ``NamedSharding`` puts on the device at that mesh coordinate."""
    inputs, ref = jax_run
    (dp, tp), _ = CASES[name]
    mesh = M.make_mesh((dp, tp), ("data", "model"), "cpu")
    wd = torch.tensor(inputs["wd"])
    got = shards(wd, P("data", "model", None), mesh)
    for (d, t), piece in got.items():
        np.testing.assert_array_equal(piece.numpy(),
                                      ref[f"{name}/wd_shard/{d}{t}"])
        assert piece.data_ptr() >= wd.data_ptr()      # a view, no copy
        assert piece.untyped_storage().data_ptr() == \
            wd.untyped_storage().data_ptr()


# -- (b) feasibility and the byte twin ----------------------------------------

_FEAS_MOES = {"smoke": dict(num_experts=8, top_k=2, d_ff_expert=64,
                            group_size=32),
              "qwen3": dict(num_experts=128, top_k=8, d_ff_expert=1536,
                            group_size=512)}
_FEAS_SHAPES = [(8, 16, 32), (4, 2048, 4096), (2, 7, 32), (3, 16, 32),
                (16, 1, 32), (1, 512, 32)]
_FEAS_MESHES = [((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
                ((1, 1), ("data", "model")), ((8,), ("data",)),
                ((4,), ("stage",)), ((2, 2, 2), ("pod", "data", "model"))]


def _jax_mesh(shape, names):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


@pytest.mark.parametrize("moe_name", sorted(_FEAS_MOES))
@pytest.mark.parametrize("mesh_shape,names", _FEAS_MESHES)
def test_feasible_equals_jax(moe_name, mesh_shape, names):
    tm = MoEConfig(impl="ep_a2a", **_FEAS_MOES[moe_name])
    jm = JaxMoE(impl="ep_a2a", **_FEAS_MOES[moe_name])
    tmesh = M.Mesh(names, mesh_shape, ())
    for shape in _FEAS_SHAPES:
        assert ep.ep_a2a_feasible(shape, tm, tmesh) == \
            jax_ep.ep_a2a_feasible(shape, jm, _jax_mesh(mesh_shape, names)), \
            shape


@pytest.mark.parametrize("E,k,cf,group,tokens,d,item", [
    (8, 2, 8.0, 32, 32, 32, 4), (8, 2, 1.25, 32, 64, 32, 4),
    (128, 8, 1.25, 512, 2048, 4096, 2), (128, 8, 1.25, 512, 300, 4096, 2),
    (4, 2, 1.0, 32, 7, 128, 4), (16, 2, 1.5, 64, 4096, 1024, 2),
    (64, 6, 1.25, 512, 1024, 7168, 2), (3, 1, 0.1, 5, 5, 8, 4)])
def test_payload_bytes_equal_jax(E, k, cf, group, tokens, d, item):
    want = jax_ep.a2a_payload_bytes(E, k, cf, group, tokens, d, item)
    assert ep.a2a_payload_bytes(E, k, cf, group, tokens, d, item) == want
    jm = JaxMoE(num_experts=E, top_k=k, d_ff_expert=8, capacity_factor=cf,
                group_size=group)
    tm = MoEConfig(num_experts=E, top_k=k, d_ff_expert=8, capacity_factor=cf,
                   group_size=group)
    assert ep.moe_a2a_bytes(tm, tokens, d, item) == \
        jax_ep.moe_a2a_bytes(jm, tokens, d, item)


def test_qwen3_payload_at_the_chip_cell():
    """One rank's 2048 tokens at qwen3-moe's published widths in bf16: 4
    groups of 512, 40 slots an expert, 128 experts of d_model 4096."""
    cfg = port_configs.get_config("qwen3-moe-235b-a22b")
    assert ep.moe_a2a_bytes(cfg.moe, 2048, cfg.d_model, 2) == \
        128 * 4 * 40 * 4096 * 2 == 167_772_160


# -- (c) executed bytes ----------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 2), (4, 1)])
def test_executed_a2a_bytes_equal_twin(mesh_shape):
    inputs = _layer_inputs()
    dp, tp = mesh_shape
    M.reset_traffic()
    _run_port(inputs, mesh_shape, 1.25)
    per_rank = ep.a2a_payload_bytes(
        LAYER["num_experts"], LAYER["top_k"], 1.25, LAYER["group_size"],
        X_SHAPE[0] // dp * X_SHAPE[1], D_MODEL, 4)
    # dispatch and return, by every rank; the backward's transposed
    # exchanges are autograd's copies and are not counted
    assert M.TRAFFIC["all_to_all"] == 2 * dp * tp * per_rank


def _smoke_moe(**kw):
    cfg = port_configs.smoke_variant(port_configs.get_config(
        "qwen3-moe-235b-a22b"))
    return dataclasses.replace(cfg, num_layers=2, moe=dataclasses.replace(
        cfg.moe, impl="ep_a2a"), **kw)


def _model_batch(cfg, batch=8, seq=16):
    rng = np.random.default_rng(1)
    model = build_model(cfg)
    params = tree_map(lambda t: t.requires_grad_(),
                      model.init(torch.Generator().manual_seed(0)))
    b = {k: torch.tensor(rng.integers(1, cfg.vocab_size, (batch, seq)))
         for k in ("tokens", "labels")}
    return model, params, b


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_model_forward_bytes_and_remat_recompute(remat):
    """A forward pass of the model moves layers x 2 x dp payloads; a
    backward under "full" or "dots" remat recomputes the layer, its
    all-to-alls included, and moves as much again (none under "none")."""
    cfg = _smoke_moe(remat_policy=remat)
    model, params, batch = _model_batch(cfg)
    mesh = M.make_mesh((4, 1), ("data", "model"), "cpu")
    twin = ep.moe_a2a_bytes(cfg.moe, 8 // 4 * 16, cfg.d_model, 4)
    fwd = cfg.num_layers * 2 * 4 * twin
    M.reset_traffic()
    moe.reset_ep_calls()
    with use_sharding(make_ctx(mesh)):
        loss, _ = model.loss(params, batch)
        assert M.TRAFFIC["all_to_all"] == fwd
        loss.backward()
    again = 0 if remat == "none" else 1
    assert M.TRAFFIC["all_to_all"] == (1 + again) * fwd
    assert moe.EP_CALLS == {"ep_a2a": (1 + again) * cfg.num_layers}


# -- (d) the context survives the backward's thread ------------------------------


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recompute_reenters_context_on_another_thread(remat):
    cfg = _smoke_moe(remat_policy=remat)
    model, params, batch = _model_batch(cfg)
    mesh = M.make_mesh((4, 1), ("data", "model"), "cpu")
    moe.reset_ep_calls()
    with use_sharding(make_ctx(mesh)):
        loss, _ = model.loss(params, batch)
    assert moe.EP_CALLS == {"ep_a2a": cfg.num_layers}
    errors = []

    def backward():
        try:
            loss.backward()
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    # the recompute took the EP path, no einsum call
    assert moe.EP_CALLS == {"ep_a2a": 2 * cfg.num_layers}
    assert all(p.grad is not None for p in leaves(params))


def test_ep_gradients_equal_einsum_on_model():
    """The whole smoke model under "full" remat: loss and every gradient
    leaf through EP on 4 ranks equal the einsum path's (fp32)."""
    cfg = _smoke_moe()
    model, params, batch = _model_batch(cfg)
    mesh = M.make_mesh((4, 1), ("data", "model"), "cpu")
    with use_sharding(make_ctx(mesh)):
        loss, met = model.loss(params, batch)
        g_ep = torch.autograd.grad(loss, leaves(params))
    loss_e, met_e = model.loss(params, batch)
    g_e = torch.autograd.grad(loss_e, leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(loss_e.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"].detach()),
                               float(met_e["aux"].detach()),
                               rtol=1e-5)
    for a, b in zip(g_ep, g_e):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_ep_refuses_an_untiled_layout():
    m = MoEConfig(impl="ep_a2a", **LAYER)
    p = {k: torch.tensor(v) for k, v in _layer_inputs().items()
         if k in ("router", "wg", "wu", "wd")}
    mesh = M.make_mesh((4, 1), ("data", "model"), "cpu")
    x = torch.zeros(4, 4, D_MODEL)     # 4 local tokens, a global group of 16
    assert not ep.ep_a2a_feasible(x.shape, m, mesh)
    with pytest.raises(ValueError, match=r"local tokens 4 .*\(4, 4, 32\)"):
        ep.moe_ffn_ep_a2a(p, x, m, torch.float32, mesh)
    # the model's rule: an infeasible mesh takes the einsum path
    moe.reset_ep_calls()
    with use_sharding(make_ctx(mesh)):
        moe.moe_ffn(p, x, m, torch.float32)
    assert moe.EP_CALLS == {"einsum": 1}


# -- (e) the launcher --------------------------------------------------------------


def test_launcher_trains_ep_like_einsum(capsys):
    argv = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu",
            "--ranks", "4", "--steps", "2", "--seq", "64", "--batch", "8"]
    launch_train.main(argv + ["--moe-impl", "ep_a2a"])
    out = capsys.readouterr().out
    assert "[comm] moe ep_a2a dispatch/layer" in out
    assert "{'ep_a2a': 16}" in out           # 4 layers x 2 steps x 2 passes
    # the reference's depth and width overrides
    launch_train.main(argv + ["--moe-impl", "ep_a2a", "--layers", "2",
                              "--d-model", "64"])
    out = capsys.readouterr().out
    assert "of 2 layers" in out and "{'ep_a2a': 8}" in out
    # 2 x 64 tokens a rank, 4 experts x 4 groups x 20 slots x 64 x 4 bytes
    assert "dispatch/layer: 0.08 MiB" in out
    cfg = port_configs.smoke_variant(port_configs.get_config(
        "qwen3-moe-235b-a22b"))
    losses = {}
    for impl in ("ep_a2a", "einsum"):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             impl=impl))
        _, losses[impl] = launch_train.train(
            c, steps=2, seq=64, batch=8, ranks=4, device="cpu",
            log_fn=lambda _: None)
    np.testing.assert_allclose(losses["ep_a2a"], losses["einsum"], rtol=1e-5)


@pytest.mark.parametrize("extra", [
    ["--pp", "2", "--microbatches", "2"],
    ["--pp", "2", "--microbatches", "2", "--compression", "int8"],
    ["--compression", "int8"]])
def test_pipeline_and_compressed_steps_take_the_einsum_path(capsys, extra):
    """Under the launcher's context the pipelined and the compressed steps
    run their bodies without it, as the reference's ``shard_map`` bodies
    do: every MoE call takes the einsum path on the rank's rows (whose
    shapes would allow EP over the mesh: 4 rows a rank)."""
    launch_train.main(["--arch", "qwen3-moe-235b-a22b", "--smoke",
                       "--device", "cpu", "--ranks", "4", "--steps", "1",
                       "--seq", "64", "--batch", "16", "--moe-impl",
                       "ep_a2a"] + extra)
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[moe]"))
    assert "'einsum'" in line and "'ep_a2a'" not in line, line
