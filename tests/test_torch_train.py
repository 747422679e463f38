"""The port's training path against the JAX package's: optimizers,
schedules and clipping over several updates, the synthetic token pipeline
(bit-equal batches), and the 10-step loss trajectory of the train step with
gradient accumulation on the smoke mamba2.

Parameters and gradients are made with numpy from a seed and handed to both
packages; the model's initial weights come from the JAX package's init and
cross through ``load_jax_params``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.configs import base as jax_configs  # noqa: E402
from repro.data import SyntheticTokens as JaxTokens  # noqa: E402
from repro.data import make_train_iterator as jax_iterator  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.step import init_state as jax_init_state  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.data import SyntheticTokens, make_train_iterator  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.obs.record import Recorder  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainState,
    init_state,
    make_eval_step,
    make_train_step,
    run_timed_step,
)

torch.set_num_threads(2)


def _tree(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "blocks": {"k": (scale * rng.standard_normal((2, 3, 4))).astype(
                np.float32),
                "b": (scale * rng.standard_normal((7,))).astype(np.float32)}}


def _to_jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _to_torch(t):
    return jax.tree_util.tree_map(torch.tensor, t)


def _close_trees(t, j, **tol):
    tl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x: x.detach().numpy(), t))
    for a, b in zip(tl, jax.tree_util.tree_leaves(j)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.0, "b2": 0.999}),
    ("adafactor", {}),
    ("adafactor", {"weight_decay": 0.01}),
])
def test_optimizer_updates_match_jax(name, kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt = jax_optim.make_optimizer(name, **kw)
    topt = optim.make_optimizer(name, **kw)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        grads = _tree(rng, scale=0.1 * (step + 1))
        lr = 1e-2 / (step + 1)
        ju, js = jopt.update(_to_jax(grads), js, jp, lr)
        tu, ts = topt.update(_to_torch(grads), ts, tp, torch.tensor(lr))
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = jax.tree_util.tree_map(lambda p, u: p + u, tp, tu)
        _close_trees(tu, ju, rtol=1e-5, atol=1e-8)
        _close_trees(tp, jp, rtol=1e-6, atol=1e-7)
    assert int(ts["count"]) == int(js["count"]) == 5


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    g = _tree(rng)
    jc, jn = jax_optim.clip_by_global_norm(_to_jax(g), max_norm)
    tc, tn = optim.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close_trees(tc, jc, rtol=1e-6, atol=1e-8)
    # in place: the same numbers, written into the tree's own tensors
    tree = _to_torch(g)
    before = tree["w"]
    ic, _ = optim.clip_by_global_norm(tree, max_norm, inplace=True)
    assert ic["w"] is before
    _close_trees(ic, jc, rtol=1e-6, atol=1e-8)


def test_clip_in_place_keeps_bf16_leaves_and_numbers():
    """In place, a bf16 leaf is written into itself (no second copy of a
    bf16 model's gradients) with the out-of-place numbers, bit for bit."""
    g = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    tree = {"w": g.to(torch.bfloat16), "b": g[0].clone()}
    want, wn = optim.clip_by_global_norm(
        {k: v.clone() for k, v in tree.items()}, 0.5)
    before = tree["w"]
    got, gn = optim.clip_by_global_norm(tree, 0.5, inplace=True)
    assert got["w"] is before and got["w"].dtype == torch.bfloat16
    assert float(gn) == float(wn) and float(gn) > 0.5
    for k in want:
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_schedules_match_jax(kind):
    args = (3e-4, 5, 40)
    if kind == "cosine":
        js, ts = jax_optim.cosine_with_warmup(*args), optim.cosine_with_warmup(
            *args)
    else:
        js, ts = jax_optim.linear_with_warmup(*args), optim.linear_with_warmup(
            *args)
    for step in range(0, 45, 3):
        np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                   rtol=1e-6, atol=1e-12)


def test_synthetic_tokens_bit_equal_to_jax():
    kw = dict(vocab_size=512, seq_len=33, global_batch=6, num_hosts=2,
              host_id=1, seed=7)
    jsrc, tsrc = JaxTokens(**kw), SyntheticTokens(**kw)
    for step in (0, 1, 5):
        jb, tb = jsrc.batch_at(step), tsrc.batch_at(step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


def test_train_iterator_bit_equal_to_jax():
    jcfg = jax_configs.smoke_variant(jax_configs.get_config("mamba2-2.7b"))
    tcfg = port_configs.smoke_variant(port_configs.get_config("mamba2-2.7b"))
    jit_ = jax_iterator(jcfg, jax_configs.ShapeConfig("t", 16, 4, "train"),
                        seed=3, start_step=2)
    tit = make_train_iterator(tcfg, port_configs.ShapeConfig("t", 16, 4,
                                                             "train"),
                              seed=3, start_step=2)
    try:
        for _ in range(3):
            jb, tb = next(jit_), next(tit)
            for k in jb:
                np.testing.assert_array_equal(jb[k], tb[k])
    finally:
        jit_.close()
        tit.close()


@pytest.fixture(scope="module")
def mamba_pair():
    def cfg(m):
        return m.smoke_variant(m.get_config("mamba2-2.7b"))

    jmodel = jax_build_model(cfg(jax_configs))
    return jmodel, build_model(cfg(port_configs))


def _port_state(jstate, topt):
    params = jax.tree_util.tree_map(
        lambda t: t.requires_grad_(),
        load_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params),
                        device="cpu"))
    return TrainState(torch.zeros((), dtype=torch.int32), params,
                      topt.init(params))


def test_ten_step_loss_trajectory_with_grad_accum_matches_jax(mamba_pair):
    jmodel, tmodel = mamba_pair
    jopt, topt = jax_optim.adamw(), optim.adamw()
    jsched = jax_optim.cosine_with_warmup(3e-3, 2, 10)
    tsched = optim.cosine_with_warmup(3e-3, 2, 10)
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, jsched, grad_accum=2))
    tstep = make_train_step(tmodel, topt, tsched, grad_accum=2)
    jstate, _ = jax_init_state(jmodel, jax.random.PRNGKey(0), jopt)
    tstate = _port_state(jstate, topt)
    src = SyntheticTokens(jmodel.cfg.vocab_size, 32, 4, seed=0)
    jl, tl = [], []
    for step in range(10):
        b = src.batch_at(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.tensor(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]),
                                   rtol=1e-4)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert int(tstate.step) == 10
    _close_trees(tstate.params, jstate.params, rtol=1e-4, atol=1e-5)


def test_eval_and_timed_step(mamba_pair):
    _, tmodel = mamba_pair
    topt = optim.adamw()
    state = init_state(tmodel, torch.Generator().manual_seed(0), topt)
    b = {k: torch.tensor(v) for k, v in
         SyntheticTokens(tmodel.cfg.vocab_size, 16, 2).batch_at(0).items()}
    ev = make_eval_step(tmodel)(state.params, b)
    loss, _ = tmodel.loss(state.params, b)
    assert float(ev["loss"]) == float(loss.detach())
    assert not ev["loss"].requires_grad
    step = make_train_step(tmodel, topt, optim.cosine_with_warmup(1e-3, 1, 5))
    state, metrics, loss, dt = run_timed_step(step, state, b, Recorder(),
                                              "train_step0")
    assert loss == float(metrics["loss"]) and dt > 0
    assert int(state.step) == 1


def test_distributed_and_compressed_steps_raise(mamba_pair):
    # compressed and data-parallel steps are ported
    # (tests/test_torch_train_dist.py); what stays refused: a scheme that
    # is byte-accounting-only, a mesh axis without its mesh, and the
    # pipeline for the ssm family (as in the JAX package)
    from repro_torch.models.pipeline import make_plan

    _, tmodel = mamba_pair
    topt = optim.adamw()
    with pytest.raises(ValueError, match="int8"):
        init_state(tmodel, torch.Generator(), topt, compression="topk:0.1")
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(tmodel, topt, optim.cosine_with_warmup(1, 1, 2),
                        axis_name="data")
    with pytest.raises(ValueError, match="family"):
        make_plan(tmodel.cfg, 2, 2)

