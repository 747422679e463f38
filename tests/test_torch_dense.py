"""Dense training in the port against the JAX package: the flash-attention
op's forward and gradient, its traced node, and the smoke llama3.2-1b and
pixtral-12b losses, gradients and train-step trajectory.

Inputs and output gradients are made with numpy from a seed and handed to
both packages; model weights come from the JAX package's init through
``load_jax_params``.  Tolerances: the kernels' (tests/test_kernels.py::tol,
2e-5 fp32 and 2e-2 bf16); model losses 1e-5 and gradients 1e-4 relative to
each leaf's largest entry, in fp32, as the mamba2 train tests use.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.configs import base as jax_configs  # noqa: E402
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash,
)
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.step import init_state as jax_init_state  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core.database import ProfileDB  # noqa: E402
from repro_torch.core.fx_graph import step_summary  # noqa: E402
from repro_torch.core.newop import NewOpProfiler  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import build_model, layers, load_jax_params  # noqa: E402
from repro_torch.train.step import TrainState, make_train_step  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _smoke(configs, arch, **kw):
    return dataclasses.replace(
        configs.smoke_variant(configs.get_config(arch)), num_layers=2, **kw)


def _model_pair(arch, **kw):
    jmodel = jax_build_model(_smoke(jax_configs, arch, **kw))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, build_model(_smoke(port_configs, arch, **kw)), \
        tparams


def _batch(cfg, rng, b=2, s=32):
    out = {k: rng.integers(1, cfg.vocab_size, (b, s), dtype=np.int32)
           for k in ("tokens", "labels")}
    if cfg.num_patches:
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return out


def assert_loss_and_grads_match(jmodel, jparams, tmodel, tparams, batch):
    """Loss, metrics (ce, aux) and every gradient leaf, fp32."""
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.detach().requires_grad_(), tparams)
    tl, tm = tmodel.loss(params, {k: torch.tensor(v) for k, v in
                                  batch.items()})
    tg = torch.autograd.grad(tl, leaves(params))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    assert sorted(tm) == sorted(jm) == ["aux", "ce"]
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jleaves)
    for t, j in zip(tg, jleaves):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=GRAD_RTOL * np.abs(j).max())


# -- the flash-attention op -------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_op_forward_and_gradient_match_jax(rng, causal, dtype):
    """At sq == skv, H 4 / K 2, D 32: the op's output and the gradient of a
    random projection of it against ``jax.grad`` of the JAX op (its Pallas
    kernel in interpret mode forward, ``attention_ref``'s VJP backward)."""
    b, s, h, kh, d = 2, 48, 4, 2, 32
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]
    gout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)

    def jloss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, block_q=16, block_k=16)
        return jnp.sum(out.astype(jnp.float32) * gout), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    ins = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
           for a in arrays]
    n0 = fa_ops.LAUNCHES.count
    out = fa_ops.flash_attention(*ins, causal=causal)
    tgrads = torch.autograd.grad((out.float() * torch.from_numpy(gout)).sum(),
                                 ins)
    assert fa_ops.LAUNCHES.count == n0     # the CPU runs the plain version
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(jout, np.float32), rtol=tol,
                               atol=tol)
    for t, j in zip(tgrads, jgrads):
        assert t.dtype == ins[0].dtype
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("masks", [False, True])
def test_flash_op_passes_opcheck(rng, masks):
    q, k, v = (torch.tensor(rng.standard_normal((2, 12, n, 32)),
                            dtype=torch.float32, requires_grad=True)
               for n in (4, 2, 2))
    qo = torch.tensor([0, 5], dtype=torch.int32) if masks else None
    kl = torch.tensor([12, 9], dtype=torch.int32) if masks else None
    torch.library.opcheck(fa_ops._flash_op, (q, k, v, True, qo, kl, 0.2))


def test_flash_op_refuses_devices_without_a_kernel_before_dispatch():
    q = torch.zeros((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa_ops.flash_attention(q, q, q)


def test_flash_cost_refuses_a_traced_mask():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.zeros((1, 8, 2, 32))
        qo = torch.zeros((1,), dtype=torch.int32)
        assert fa_ops.cost(q, q, q, True, None, None, 0.1)[0] > 0
        with pytest.raises(ValueError, match="q_offset is a traced tensor"):
            fa_ops.cost(q, q, q, True, qo, None, 0.1)


def test_attention_layer_refuses_what_waits_for_encdec(rng):
    """The encoder-decoder family no longer waits: bidirectional and cross
    attention run through the op with ``causal=False`` (its plain version
    on the CPU, every key visible); an explicit mask has no caller in the
    port and is still refused."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    cfg = _smoke(port_configs, "llama3.2-1b")
    p = layers.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(rng.standard_normal((1, 4, cfg.d_model)).astype(
        np.float32))
    mem = torch.from_numpy(rng.standard_normal((1, 7, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(4)[None]
    q, k, v = layers._project_qkv(p, x, cfg, pos)
    want = torch.einsum("bqhk,hkd->bqd",
                        attention_ref(q, k, v, causal=False), p["wo"])
    got = layers.attention(p, x, cfg, positions=pos, bidirectional=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL["float32"],
                               atol=TOL["float32"])
    ck, cv = layers.cross_kv_from_memory(p, mem, cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    want = torch.einsum("bqhk,hkd->bqd",
                        attention_ref(q, ck, cv, causal=False), p["wo"])
    got = layers.attention(p, x, cfg, positions=None, cross_kv=(ck, cv))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL["float32"],
                               atol=TOL["float32"])
    with pytest.raises(NotImplementedError, match="mask"):
        layers.attention(p, x, cfg, positions=pos,
                         mask=torch.ones((1, 1, 4, 4), dtype=torch.bool))


# -- the traced step ----------------------------------------------------------------


def test_traced_step_has_one_custom_call_per_flash_launch():
    """The smoke llama step (2 layers, remat): one ``custom-call`` node per
    flash launch of the real step on the card (forward and recompute; the
    VJP is traced as ATen ops), each with the op's own cost, and the
    new-op profiler replays one with its ``None`` masks."""
    cfg = _smoke(port_configs, "llama3.2-1b")
    b, s = 2, 32
    ts = step_summary(build_model(cfg), optim.adamw(),
                      optim.cosine_with_warmup(1e-3, 10, 1000), batch=b,
                      seq=s, device="cpu")
    calls = [n for n in ts["graph"].nodes
             if n.meta.get("kernel") == "flash_attention"]
    assert len(calls) == 2 * cfg.num_layers
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, kv = torch.zeros((b, s, h, d)), torch.zeros((b, s, kh, d))
    flops, nbytes = fa_ops.cost(q, kv, kv, True)
    for n in calls:
        assert n.kind == "custom-call"
        assert n.flops == flops and n.bytes_accessed == nbytes
        args = n.meta["call"]["args"]
        assert n.meta["call"]["op"] == "repro_torch::flash_attention"
        assert args[3] is True and args[4] is None and args[5] is None
        assert args[6] == pytest.approx(1.0 / np.sqrt(d))
    assert sum(1 for n in ts["graph"].nodes
               if n.meta.get("kernel") == "rmsnorm") == 4 * cfg.num_layers + 1
    db = ProfileDB()
    newop = NewOpProfiler(db, "cpu_host", repeats=1, device="cpu")
    assert newop.try_profile(calls[0]) > 0
    assert newop.profiled == ["custom-call"]


# -- models: loss, gradients, train step -----------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "pixtral-12b"])
def test_loss_and_grads_match_jax(rng, arch):
    """fp32 smoke models (2 layers): llama3.2-1b's tied head sums the
    lookup's and the head's gradients; pixtral-12b prepends projected
    patches (tanh GELU) and takes the loss on the text."""
    jmodel, jparams, tmodel, tparams = _model_pair(arch)
    assert_loss_and_grads_match(jmodel, jparams, tmodel, tparams,
                                _batch(tmodel.cfg, rng))


def test_vlm_prefill_and_decode_match_jax(rng):
    jmodel, jparams, tmodel, tparams = _model_pair("pixtral-12b")
    cfg = tmodel.cfg
    b = _batch(cfg, rng, b=1, s=9)
    max_len = cfg.num_patches + 9 + 3
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(b["tokens"]),
                                      "patches": jnp.asarray(b["patches"])},
                            max_len)
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(b["tokens"]), max_len,
                            patches=torch.from_numpy(b["patches"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    clen = cfg.num_patches + 9
    for tok in (3, 17, 5):
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray([[tok]], jnp.int32),
                               clen)
        tl, tc = tmodel.decode(tparams, tc,
                               torch.tensor([[tok]], dtype=torch.int32), clen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        clen += 1
    with pytest.raises(ValueError, match="patches"):
        tmodel.prefill(tparams, torch.from_numpy(b["tokens"]))


def test_ten_step_loss_trajectory_with_grad_accum_matches_jax():
    """The smoke llama3.2-1b (2 layers, per-layer remat) through both train
    steps with grad_accum 2, from the JAX init: losses, ce, aux and grad
    norms each step, and the parameters after 10 steps."""
    jmodel, jparams, tmodel, tparams = _model_pair("llama3.2-1b")
    jopt, topt = jax_optim.adamw(), optim.adamw()
    jstep = jax.jit(jax_make_train_step(
        jmodel, jopt, jax_optim.cosine_with_warmup(3e-3, 2, 10),
        grad_accum=2))
    tstep = make_train_step(tmodel, topt,
                            optim.cosine_with_warmup(3e-3, 2, 10),
                            grad_accum=2)
    jstate, _ = jax_init_state(jmodel, jax.random.PRNGKey(0), jopt)
    params = tree_map(lambda t: t.requires_grad_(), load_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), device="cpu"))
    tstate = TrainState(torch.zeros((), dtype=torch.int32), params,
                        topt.init(params))
    src = SyntheticTokens(tmodel.cfg.vocab_size, 32, 4, seed=0)
    jl, tl = [], []
    for step in range(10):
        b = src.batch_at(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.tensor(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        for k in ("grad_norm", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    for t, j in zip(leaves(tstate.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-5)
