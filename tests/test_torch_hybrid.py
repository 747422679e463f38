"""The port's jamba superblock (hybrid family) against the JAX package's.

The smoke jamba (4 layers in two periods of [attention + MLP, mamba + MoE],
d_model 128, 4 experts top-2, fp32) is initialised by the JAX package; its
parameters cross to the port as numpy arrays through ``load_jax_params``.
Inputs are made with numpy from a seed.  The experts the port chooses are
held against ``lax.top_k`` on the same router inputs first, so a tie broken
differently fails as a routing mismatch.  Tolerances: logits, caches and
SSM states within 1e-4 (fp32; the SSD scan's sums run in another order),
the loss within 1e-5 and gradients within 1e-4 of each leaf's largest entry,
as the other model tests.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import hybrid as jax_hybrid  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.models import hybrid, moe  # noqa: E402
from test_torch_dense import assert_loss_and_grads_match  # noqa: E402

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _smoke(configs):
    return configs.smoke_variant(configs.get_config(ARCH))


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(_smoke(jax_configs))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, build_model(_smoke(port_configs)), tparams


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _routing_recorder(monkeypatch):
    """Record every (router, grouped input, chosen experts) of the port's
    MoE layers, where ``moe_ffn`` routes."""
    seen = []
    route = moe.route

    def recording(p, xg, m):
        out = route(p, xg, m)
        seen.append((p["router"].detach().numpy().copy(),
                     xg.detach().numpy().copy(), out[2].numpy().copy(), m))
        return out

    monkeypatch.setattr(moe, "route", recording)
    return seen


def _assert_routing_matches_jax(seen):
    assert seen
    for router, xg, idx, m in seen:
        probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", xg, router), -1)
        np.testing.assert_array_equal(
            idx, np.asarray(jax.lax.top_k(probs, m.top_k)[1]),
            err_msg="the port chose other experts than lax.top_k")


@pytest.mark.parametrize("cfg_of", [
    lambda c: c.get_config(ARCH), lambda c: _smoke(c),
    # the chip's variant: one whole period, d_model cut
    lambda c: dataclasses.replace(
        c.get_config(ARCH), num_layers=8, d_model=1024, d_ff=3072,
        moe=dataclasses.replace(c.get_config(ARCH).moe, d_ff_expert=3072)),
], ids=["published", "smoke", "chip-variant"])
def test_sublayer_kinds_and_superblocks_match_jax(cfg_of):
    jcfg, tcfg = cfg_of(jax_configs), cfg_of(port_configs)
    assert hybrid._sublayer_kinds(tcfg) == jax_hybrid._sublayer_kinds(jcfg)
    assert hybrid._n_superblocks(tcfg) == jax_hybrid._n_superblocks(jcfg)
    assert build_model(tcfg).cache_axes() == jax_build_model(jcfg).cache_axes()


def test_published_period_is_one_attention_seven_mamba_four_moe():
    kinds = hybrid._sublayer_kinds(port_configs.get_config(ARCH))
    assert [m for m, _ in kinds] == ["attn"] + ["mamba"] * 7
    assert [f for _, f in kinds] == ["mlp", "moe"] * 4


def test_init_params_keys_shapes_dtypes_match_jax(pair):
    _, jparams, tmodel, _ = pair
    jflat = _flat(jparams)
    tflat = _flat(tmodel.init(torch.Generator().manual_seed(0)))
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jflat[key].dtype), key


def test_loss_aux_and_gradients_match_jax(pair, rng, monkeypatch):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    batch = {k: rng.integers(1, cfg.vocab_size, (2, 32), dtype=np.int32)
             for k in ("tokens", "labels")}
    seen = _routing_recorder(monkeypatch)
    with torch.no_grad():
        _, met = tmodel.loss(tparams, {k: torch.tensor(v)
                                       for k, v in batch.items()})
    monkeypatch.undo()
    # one MoE layer a period, two periods
    assert len(seen) == 2
    _assert_routing_matches_jax(seen)
    assert float(met["aux"]) > 0
    assert_loss_and_grads_match(jmodel, jparams, tmodel, tparams, batch)


def test_prefill_caches_and_decode_match_jax(pair, rng, monkeypatch):
    jmodel, jparams, tmodel, tparams = pair
    prompt = rng.integers(1, tmodel.cfg.vocab_size, (2, 21), dtype=np.int32)
    max_len = 32
    seen = _routing_recorder(monkeypatch)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, max_len)
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(prompt), max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jflat, tflat = _flat(jc), _flat(tc)
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        np.testing.assert_allclose(t.numpy(), np.asarray(jflat[key]), **TOL,
                                   err_msg=key)
    clen = prompt.shape[1]
    for _ in range(4):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tok[:, 0], torch.argmax(tl[:, -1], -1).numpy())
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(tok), clen)
        tl, tc = tmodel.decode(tparams, tc, torch.from_numpy(tok), clen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        clen += 1
    monkeypatch.undo()
    _assert_routing_matches_jax(seen)
    for key, t in _flat(tc).items():
        np.testing.assert_allclose(t.numpy(), np.asarray(_flat(jc)[key]),
                                   **TOL, err_msg=key)


def test_init_cache_matches_jax(pair):
    jmodel, _, tmodel, _ = pair
    jflat = _flat(jmodel.init_cache(2, 16, dtype=jnp.float32))
    tflat = _flat(tmodel.init_cache(2, 16, torch.float32, "cpu"))
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jflat[key].dtype), key
        assert not t.any(), key
