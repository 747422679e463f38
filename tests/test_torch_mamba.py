"""The port's Mamba-2 mixer and SSM stack against the JAX package's.

The smoke mamba2 (4 layers, d_model 128, d_state 16, head_dim 16, chunk 16,
fp32) is initialised by the JAX package; its parameters cross to the port as
numpy arrays through ``load_jax_params``.  Inputs are made with numpy from a
seed.  Everything agrees within 1e-4 (fp32; sums run in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.models import mamba as port_mamba  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(configs):
    return configs.smoke_variant(configs.get_config("mamba2-2.7b"))


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(_cfg(jax_configs))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jmodel, jparams, build_model(_cfg(port_configs)), \
        load_jax_params(jparams, device="cpu")


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


def test_param_tree_crosses_with_fp32_ssm_leaves(pair):
    _, jparams, tmodel, tparams = pair
    mixer = tparams["blocks"]["mixer"]
    for key in ("A_log", "dt_bias", "D_skip"):
        assert mixer[key].dtype == torch.float32
    fresh = tmodel.init(torch.Generator().manual_seed(0))
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(fresh)[0]}
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jflat[key].dtype), key


@pytest.mark.parametrize("seq,with_state", [(32, False), (21, False),
                                            (32, True), (21, True)])
def test_mamba_forward_matches_jax(pair, seq, with_state):
    jmodel, jparams, tmodel, tparams = pair
    cfg_j, cfg_t = jmodel.cfg, tmodel.cfg
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, cfg_j.d_model)).astype(np.float32)
    state = None
    if with_state:
        _, _, nh = jax_mamba.mamba_dims(cfg_j)
        m = cfg_j.mamba
        state = rng.standard_normal((2, nh, m.d_state, m.head_dim)).astype(
            np.float32)
    jy, jc = jax_mamba.mamba_forward(
        _layer0(jparams["blocks"])["mixer"], jnp.asarray(x), cfg_j,
        init_state=None if state is None else jnp.asarray(state))
    ty, tc = port_mamba.mamba_forward(
        _layer0(tparams["blocks"])["mixer"], torch.tensor(x), cfg_t,
        init_state=None if state is None else torch.tensor(state))
    _close(ty, jy)
    for k in jc:
        _close(tc[k], jc[k])


def test_mamba_step_matches_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    rng = np.random.default_rng(3)
    jcache = jax_mamba.init_mamba_cache(2, jmodel.cfg, jnp.float32)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jcache.items()}
    x = rng.standard_normal((2, 1, jmodel.cfg.d_model)).astype(np.float32)
    jy, jc = jax_mamba.mamba_step(
        _layer0(jparams["blocks"])["mixer"], jnp.asarray(x), jmodel.cfg,
        {k: jnp.asarray(v) for k, v in cache.items()})
    ty, tc = port_mamba.mamba_step(
        _layer0(tparams["blocks"])["mixer"], torch.tensor(x), tmodel.cfg,
        {k: torch.tensor(v) for k, v in cache.items()})
    _close(ty, jy)
    for k in jc:
        _close(tc[k], jc[k])


def test_loss_and_gradients_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    rng = np.random.default_rng(4)
    v = jmodel.cfg.vocab_size
    batch = {"tokens": rng.integers(1, v, (2, 32), dtype=np.int32),
             "labels": rng.integers(1, v, (2, 32), dtype=np.int32)}
    (jloss, jmet), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        {k: jnp.asarray(a) for k, a in batch.items()})
    leaves, treedef = jax.tree_util.tree_flatten(tparams)
    leaves = [t.clone().requires_grad_() for t in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    loss, met = tmodel.loss(params, {k: torch.tensor(a) for k, a in
                                     batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss)
    _close(met["ce"], jmet["ce"])
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        _close(g, jg, rtol=1e-4, atol=2e-5 * max(1.0, float(np.abs(jg).max())))


def test_prefill_and_decode_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, jmodel.cfg.vocab_size, (2, 21), dtype=np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jlogits, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(prompt)})
    tlogits, tcache = tmodel.prefill(tparams, torch.tensor(prompt))
    _close(tlogits, jlogits)
    for k in jcache:
        _close(tcache[k], jcache[k])
    tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(
        np.int32)
    for i in range(3):
        jlogits, jcache = jmodel.decode(jp, jcache, jnp.asarray(tok),
                                        21 + i)
        tlogits, tcache = tmodel.decode(tparams, tcache, torch.tensor(tok),
                                        21 + i)
        _close(tlogits, jlogits)
        tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(
            np.int32)
    for k in jcache:
        _close(tcache[k], jcache[k])
