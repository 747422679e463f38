"""Real models through the port's pipeline executor, against the JAX package
(the counterparts of tests/test_model_pipeline.py).

  1. The gradients of the pipeline-partitioned transformer/MoE — embedding,
     blocks, final norm, head, router aux included — at pp in {2, 4}
     logical CPU ranks under gpipe, 1f1b and interleaved_1f1b match
     ``jax.grad`` of JAX's ``microbatched_reference`` (loss 1e-5 relative,
     gradients 2e-4, MoE 5e-4: the reference tests' tolerances).
  2. The pp x dp train step equals the plain ``make_train_step(grad_accum)``
     step, and the int8-compressed step trains and carries its residuals.
  3. ``model_pipeline_graph``'s comm annotations equal the executor's twins,
     the bytes the executor's hops really moved, and JAX's twins.

Weights cross from the JAX package's init through ``load_jax_params``.
"""
import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import estimator as jax_est  # noqa: E402
from repro.core import strategy as jax_strategy  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import pipeline as jax_pipe  # noqa: E402
from repro.models.build import make_concrete_batch  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core import estimator as port_est  # noqa: E402
from repro_torch.core import strategy as port_strategy  # noqa: E402
from repro_torch.dist import compress as tc  # noqa: E402
from repro_torch.dist import mesh as M  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.models import pipeline as port_pipe  # noqa: E402
from repro_torch.optim import adamw, cosine_with_warmup  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    init_state,
    make_pipeline_train_step,
    make_train_step,
)
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(2)

SHAPE = jax_configs.ShapeConfig("pipe_test", 16, 4, "train")


def _tiny(configs, name, **kw):
    cfg = configs.smoke_variant(configs.get_config(name))
    changes = {
        "num_layers": 4, "d_model": 64, "num_heads": 2, "num_kv_heads": 2,
        "head_dim": 32, "d_ff": 128 if cfg.d_ff else 0, "vocab_size": 256,
    }
    changes.update(kw)
    return dataclasses.replace(cfg, **changes)


def _pair(name, **kw):
    jcfg, tcfg = _tiny(jax_configs, name, **kw), _tiny(port_configs, name,
                                                       **kw)
    jmodel = jax_build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


def _torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _grad_parity(name, pp, M_, schedule, vstages, rtol=2e-4, **kw):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _pair(name, **kw)
    batch = make_concrete_batch(jcfg, SHAPE)
    ref = jax_pipe.microbatched_reference(jmodel, M_)
    ref_loss, ref_grads = jax.value_and_grad(ref)(jparams, batch)
    plan = port_pipe.make_plan(tcfg, pp, M_, schedule=schedule,
                               vstages=vstages)
    mesh = M.make_mesh((pp,), ("stage",), device="cpu")
    loss, metrics, grads = port_pipe.pipeline_loss_and_grads(
        plan, tparams, _torch_batch(batch), mesh)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_grads)]
    got = leaves(grads)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_allclose(
            g.detach().numpy(), r, rtol=rtol,
            atol=rtol * float(np.abs(r).max() + 1e-8))
    return metrics


@pytest.mark.parametrize("pp,M_,schedule,v", [
    (2, 2, "interleaved_1f1b", 2), (2, 4, "1f1b", 1), (4, 4, "gpipe", 1),
])
def test_dense_tied_grads_match_reference(pp, M_, schedule, v):
    """Tied-embeddings llama: the embed table carries BOTH the input and
    head paths, across pp ranks, under every schedule."""
    _grad_parity("llama3.2-1b", pp, M_, schedule, v)


@pytest.mark.parametrize("pp,schedule,v", [(2, "interleaved_1f1b", 2),
                                           (4, "1f1b", 1)])
def test_moe_grads_and_router_aux_match_reference(pp, schedule, v):
    """MoE blocks: the per-layer router-balance aux is seeded locally in the
    scheduled backward and its sum matches the reference's aux term."""
    metrics = _grad_parity("qwen3-moe-235b-a22b", pp, 4, schedule, v,
                           rtol=5e-4)
    assert float(metrics["aux"]) > 0.0


@pytest.mark.parametrize("pp,schedule", [(2, "gpipe"), (4, "1f1b")])
def test_untied_head_grads_flow_from_loss(pp, schedule):
    """A separate lm head lives on the last stage; its gradient comes out of
    the loss's backward on the last virtual stage."""
    _grad_parity("llama3.2-1b", pp, 4, schedule, 1, tie_embeddings=False)


def test_partition_roundtrip_and_guards():
    cfg = _tiny(port_configs, "llama3.2-1b")
    params, _ = build_model(cfg).abstract_params()
    first, blocks, last = port_pipe.partition_params(cfg, params)
    assert set(first) == {"embed"}
    assert set(last) == {"final_norm", "embed"}     # tied
    ones = build_model(cfg).init(torch.Generator().manual_seed(0))
    ones = {k: (torch.ones_like(v) if torch.is_tensor(v) else v)
            for k, v in ones.items()}
    f2, b2, l2 = port_pipe.partition_params(cfg, ones)
    m2 = port_pipe.merge_grads(cfg, f2, b2, l2)
    assert set(m2) == {"embed", "blocks", "final_norm"}
    assert float(m2["embed"][0, 0]) == 2.0
    with pytest.raises(ValueError, match="family"):
        port_pipe.check_pipelineable(port_configs.smoke_variant(
            port_configs.get_config("mamba2-2.7b")), 2)
    with pytest.raises(ValueError, match="divisible"):
        port_pipe.check_pipelineable(cfg, 3)
    with pytest.raises(ValueError, match="vlm|patch"):
        port_pipe.check_pipelineable(port_configs.smoke_variant(
            port_configs.get_config("pixtral-12b")), 2)
    # the reference's signature: no expert-parallel width in a pipeline plan
    assert list(inspect.signature(port_pipe.make_plan).parameters) == \
        list(inspect.signature(jax_pipe.make_plan).parameters)
    jplan = jax_pipe.make_plan(_tiny(jax_configs, "llama3.2-1b"), 2, 4,
                               schedule="interleaved_1f1b", vstages=2)
    tplan = port_pipe.make_plan(cfg, 2, 4, schedule="interleaved_1f1b",
                                vstages=2)
    assert tplan.describe() == jplan.describe()
    assert tplan.hop_bytes(2, 16) == jplan.hop_bytes(2, 16)
    assert tplan.boundary_bytes_per_step(2, 16) == \
        jplan.boundary_bytes_per_step(2, 16)
    assert port_pipe.moe_layers_per_vstage(tplan) == \
        jax_pipe.moe_layers_per_vstage(jplan)


def test_wavefront_forward_matches_plain_stack():
    """``pipeline_step_shard_map``: the forward wavefront over 2 ranks
    equals running every layer in order, and gradients flow through the
    hops."""
    from repro_torch.dist import pp as tpp

    gen = torch.Generator().manual_seed(0)
    w = torch.randn((4, 8, 8), generator=gen, requires_grad=True)
    xs = torch.randn((3, 2, 8), generator=gen)

    def layer(p, x):
        return torch.tanh(x @ p)

    mesh = M.make_mesh((2,), ("stage",), device="cpu")
    out = tpp.pipeline_step_shard_map(w, xs, layer, mesh)
    ref = xs
    for i in range(4):
        ref = layer(w[i], ref)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad(out.sum(), [w])
    (gr,) = torch.autograd.grad(ref.sum(), [w])
    torch.testing.assert_close(g, gr, rtol=1e-6, atol=1e-6)


def test_pp_dp_step_matches_grad_accum_step():
    """A pp=2 x dp=2 step (grad_accum 2, 2 microbatches a pass) gives the
    SAME new params as ``make_train_step(grad_accum=8)``: the same
    microbatch split and optimizer tail, only the execution differs."""
    cfg = _tiny(port_configs, "llama3.2-1b")
    model = build_model(cfg)
    opt, lr = adamw(), cosine_with_warmup(1e-3, 5, 100)
    jcfg = _tiny(jax_configs, "llama3.2-1b")
    batch = _torch_batch(make_concrete_batch(
        jcfg, jax_configs.ShapeConfig("pipe_step", 16, 8, "train")))
    mesh = M.make_mesh((2, 2), ("data", "stage"), device="cpu")
    plan = port_pipe.make_plan(cfg, 2, 2, schedule="1f1b")
    pstep = make_pipeline_train_step(model, opt, lr, mesh, plan,
                                     grad_accum=2)
    rstep = make_train_step(model, opt, lr, grad_accum=8)
    s1 = init_state(model, torch.Generator().manual_seed(0), opt)
    s2 = init_state(model, torch.Generator().manual_seed(0), opt)
    s1n, m1 = pstep(s1, batch)
    s2n, m2 = rstep(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-6)
    for p, r in zip(leaves(s1n.params), leaves(s2n.params)):
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_compressed_pp_dp_step_trains_and_carries_residuals():
    cfg = _tiny(port_configs, "llama3.2-1b")
    model = build_model(cfg)
    opt, lr = adamw(), cosine_with_warmup(1e-3, 2, 100)
    batch = _torch_batch(make_concrete_batch(
        _tiny(jax_configs, "llama3.2-1b"),
        jax_configs.ShapeConfig("pipe_comp", 16, 8, "train")))
    mesh = M.make_mesh((2, 2), ("data", "stage"), device="cpu")
    plan = port_pipe.make_plan(cfg, 2, 2, schedule="interleaved_1f1b",
                               vstages=2)
    step = make_pipeline_train_step(model, opt, lr, mesh, plan,
                                    compression="int8")
    state = init_state(model, torch.Generator().manual_seed(0), opt,
                       compression="int8", dp=2)
    losses = []
    M.reset_traffic()
    for _ in range(6):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    res_max = max(float(r.abs().max()) for r in leaves(state.comp_state))
    assert res_max > 0.0
    for p, r in zip(leaves(state.params), leaves(state.comp_state)):
        assert tuple(r.shape) == (2,) + tuple(p.shape)
    # what the executor shipped: per step and data rank, every stage's
    # block rows and the merged embedding/final-norm gradients once
    params, _ = model.abstract_params()
    trees = port_pipe.stage_param_trees(plan, params)
    per_rank = sum(tc.compressed_psum_bytes(t["blocks"], "int8")
                   for t in trees) + tc.compressed_psum_bytes(
        {"embed": params["embed"], "final_norm": params["final_norm"]},
        "int8")
    assert M.TRAFFIC["psum_int8"] == 6 * 2 * per_rank
    assert M.TRAFFIC["ppermute"] == 6 * 2 * plan.boundary_bytes_per_step(
        2, 16)


def test_model_graph_bytes_equal_executor_and_jax_twins():
    jcfg = _tiny(jax_configs, "llama3.2-1b", num_layers=8)
    tcfg = _tiny(port_configs, "llama3.2-1b", num_layers=8)
    for sched_name, S, M_, v in (("gpipe", 4, 4, 1), ("1f1b", 4, 8, 1),
                                 ("interleaved_1f1b", 4, 4, 2)):
        jplan = jax_pipe.make_plan(jcfg, S, M_, schedule=sched_name,
                                   vstages=v)
        tplan = port_pipe.make_plan(tcfg, S, M_, schedule=sched_name,
                                    vstages=v)
        for dp, scheme in ((1, "none"), (2, "none"), (2, "int8")):
            jg = jax_strategy.model_pipeline_graph(
                jcfg, jplan.strategy(dp=dp, compression=scheme), 2, 16)
            tg = port_strategy.model_pipeline_graph(
                tcfg, tplan.strategy(dp=dp, compression=scheme), 2, 16)
            assert [(n.name, n.kind, n.deps, n.device, n.flops,
                     n.in_bytes, n.comm_bytes, n.group_size)
                    for n in tg.nodes] == \
                [(n.name, n.kind, n.deps, n.device, n.flops, n.in_bytes,
                  n.comm_bytes, n.group_size) for n in jg.nodes]
            tcomm = {n.name: port_est.dist_comm_bytes(n) for n in tg.nodes
                     if n.is_collective}
            jcomm = {n.name: jax_est.dist_comm_bytes(n) for n in jg.nodes
                     if n.is_collective}
            assert tcomm == jcomm
            sends = sum(b for k, b in tcomm.items() if k.startswith("send"))
            assert sends == tplan.boundary_bytes_per_step(2, 16)
            if dp > 1:
                params, _ = build_model(tcfg).abstract_params()
                for s, tree in enumerate(
                        port_pipe.stage_param_trees(tplan, params)):
                    assert tcomm[f"gradAR{s}"] == tc.compressed_psum_bytes(
                        tree, scheme)


def test_estimator_resolves_annotations_and_refuses_moe_a2a():
    """Every ``moe_a2a`` node of a pp x dp ep_a2a plan is priced exactly as
    ``repro.core.estimator.dist_comm_bytes`` prices the JAX graph's node of
    the same name; the other annotations resolve and price."""
    from repro_torch.core.hardware import TPU_V5E

    cfg = _tiny(port_configs, "qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="ep_a2a"))
    jcfg = _tiny(jax_configs, "qwen3-moe-235b-a22b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             impl="ep_a2a"))
    plan = port_pipe.make_plan(cfg, 2, 2, schedule="1f1b")
    jplan = jax_pipe.make_plan(jcfg, 2, 2, schedule="1f1b")
    g = port_strategy.model_pipeline_graph(cfg, plan.strategy(dp=2), 2, 16)
    jg = jax_strategy.model_pipeline_graph(jcfg, jplan.strategy(dp=2), 2, 16)
    jnodes = {n.name: n for n in jg.nodes}
    a2a = [n for n in g.nodes if n.kind == "all-to-all"]
    assert a2a and len(a2a) == sum(n.kind == "all-to-all" for n in jg.nodes)
    for n in a2a:
        assert port_est.dist_comm_bytes(n) == \
            jax_est.dist_comm_bytes(jnodes[n.name]) > 0
    est = port_est.OpTimeEstimator(TPU_V5E)
    g1 = port_strategy.model_pipeline_graph(
        cfg, plan.strategy(dp=2, compression="int8"), 2, 16)
    cfg_d = _tiny(port_configs, "llama3.2-1b")
    plan_d = port_pipe.make_plan(cfg_d, 2, 2)
    gd = port_strategy.model_pipeline_graph(
        cfg_d, plan_d.strategy(dp=2, compression="int8"), 2, 16)
    for n in gd.nodes:
        assert est.duration(n) >= 0.0
    assert any(n.meta.get("compression") == "int8" for n in g1.nodes)


@pytest.mark.parametrize("S,v", [(2, 1), (2, 2), (4, 2)])
def test_param_arrangement_and_chunks_match_reference(S, v):
    """The device-major rows of the reference (``arrange_params_for_
    schedule``) are the port's, and stage s's rows are its chunks of
    ``stage_chunks`` in local order; both round-trip."""
    from repro.dist import pp as jpp
    from repro.dist.schedules import make_schedule as jmake
    from repro_torch.dist import pp as tpp
    from repro_torch.dist.schedules import make_schedule as tmake

    rng = np.random.default_rng(0)
    leaf = rng.standard_normal((8, 3, 2)).astype(np.float32)
    name = "interleaved_1f1b" if v > 1 else "1f1b"
    js, ts = jmake(name, S, 4, v), tmake(name, S, 4, v)
    want = np.asarray(jpp.arrange_params_for_schedule(
        {"w": jnp.asarray(leaf)}, js)["w"])
    got = tpp.arrange_params_for_schedule({"w": torch.tensor(leaf)}, ts)["w"]
    np.testing.assert_array_equal(got.numpy(), want)
    back = tpp.unarrange_params_for_schedule({"w": got}, ts)["w"]
    np.testing.assert_array_equal(back.numpy(), leaf)
    cpu = [torch.device("cpu")] * S
    chunks = tpp.stage_chunks({"w": torch.tensor(leaf)}, ts, cpu)
    per = 8 // (S * v)
    for s in range(S):
        rows = torch.cat([chunks[s][c]["w"] for c in range(v)])
        np.testing.assert_array_equal(
            rows.numpy(), want.reshape(S, v * per, 3, 2)[s])
    merged = tpp.merge_chunks(chunks, ts, torch.device("cpu"))["w"]
    np.testing.assert_array_equal(merged.numpy(), leaf)


@pytest.mark.parametrize("name,S,v", [("gpipe", 2, 1), ("1f1b", 4, 1),
                                      ("interleaved_1f1b", 2, 2)])
def test_homogeneous_stack_executor_matches_autodiff(name, S, v):
    """``pipeline_schedule_shard_map`` on a plain layer stack: the summed
    microbatch loss, the outputs and the layer gradients equal autodiff of
    the same stack run in order (loss ``0.5 * sum(y**2)``)."""
    from repro_torch.dist import pp as tpp
    from repro_torch.dist.schedules import make_schedule

    gen = torch.Generator().manual_seed(1)
    w = torch.randn((8, 6, 6), generator=gen) * 0.4
    xs = torch.randn((4, 3, 6), generator=gen)

    def layer(p, x):
        return torch.tanh(x @ p)

    mesh = M.make_mesh((S,), ("stage",), device="cpu")
    loss, outs, grads = tpp.pipeline_schedule_shard_map(
        w, xs, layer, mesh, make_schedule(name, S, 4, v))
    wr = w.clone().requires_grad_()
    ys = []
    for m in range(4):
        h = xs[m]
        for i in range(8):
            h = layer(wr[i], h)
        ys.append(h)
    ref = sum(0.5 * (y ** 2).sum() for y in ys)
    (gr,) = torch.autograd.grad(ref, [wr])
    torch.testing.assert_close(loss, ref.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(outs, torch.stack(ys).detach(), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(grads, gr, rtol=1e-5, atol=1e-6)
