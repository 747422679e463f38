"""The port's encoder-decoder (audio family, seamless-m4t) against the JAX
package's, and the jamba and seamless smoke models through ``launch.train``.

The smoke seamless (2 encoder and 4 decoder layers, d_model 128, 4 heads of
32, source_len 64, fp32) is initialised by the JAX package; its parameters
cross to the port as numpy arrays through ``load_jax_params``.  Inputs are
made with numpy from a seed.  Tolerances, as the other model tests: the
attention outputs within 2e-5 (tests/test_kernels.py::tol for fp32), logits
and caches within 1e-4, the loss within 1e-5 and gradients within 1e-4 of
each leaf's largest entry.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.data import make_train_iterator as jax_iterator  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.build import input_specs  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.data import make_train_iterator  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import build_model, layers, load_jax_params  # noqa: E402
from test_torch_dense import assert_loss_and_grads_match  # noqa: E402

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
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


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


# (batch, query length, memory length): Sq < Skv, Sq > Skv, and a query
# block long enough (256) for the JAX package's blockwise path
@pytest.mark.parametrize("b,sq,skv", [(2, 7, 13), (2, 20, 9), (1, 256, 512)])
def test_attention_cross_and_bidirectional_match_jax(pair, b, sq, skv):
    """``attention`` with ``cross_kv`` (q without RoPE against memory K/V)
    and with ``bidirectional=True`` (RoPE on q and k, every key visible)
    against the JAX package's, which run its ``_sdpa``.  Both are
    non-causal, so ROADMAP C2 (the TPU kernel masks causally top-left, its
    oracle bottom-right) does not arise: no row of a non-causal call is
    masked at all, whatever Sq and Skv."""
    jmodel, jparams, tmodel, tparams = pair
    jcfg, tcfg = jmodel.cfg, tmodel.cfg
    rng = np.random.default_rng(sq)
    x = rng.standard_normal((b, sq, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((b, skv, jcfg.d_model)).astype(np.float32)
    jp = _layer0(jparams["decoder"])["cross"]
    tp = _layer0(tparams["decoder"])["cross"]
    jkv = jax_layers.cross_kv_from_memory(jp, jnp.asarray(mem), jcfg)
    tkv = layers.cross_kv_from_memory(tp, torch.from_numpy(mem), tcfg)
    for t, j in zip(tkv, jkv):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5,
                                   atol=2e-5)
    jy = jax_layers.attention(jp, jnp.asarray(x), jcfg, positions=None,
                              cross_kv=jkv)
    ty = layers.attention(tp, torch.from_numpy(x), tcfg, positions=None,
                          cross_kv=tkv)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq))
    jp = _layer0(jparams["encoder"])["attn"]
    tp = _layer0(tparams["encoder"])["attn"]
    jy = jax_layers.attention(jp, jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos), bidirectional=True)
    ty = layers.attention(tp, torch.from_numpy(x), tcfg,
                          positions=torch.from_numpy(pos.copy()),
                          bidirectional=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)


def test_init_params_keys_shapes_dtypes_and_cache_match_jax(pair):
    jmodel, jparams, tmodel, _ = pair
    jflat = _flat(jparams)
    tflat = _flat(tmodel.init(torch.Generator().manual_seed(0)))
    assert sorted(tflat) == sorted(jflat)
    assert {k.split("'")[1] for k in tflat} == {
        "embed", "frontend", "encoder", "decoder", "enc_norm", "final_norm",
        "head"}
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jflat[key].dtype), key
    jc = _flat(jmodel.init_cache(2, 16, dtype=jnp.float32))
    tc = _flat(tmodel.init_cache(2, 16, torch.float32, "cpu"))
    assert sorted(tc) == sorted(jc)
    for key, t in tc.items():
        assert tuple(t.shape) == jc[key].shape, key
    assert tmodel.cache_axes() == jmodel.cache_axes()


def test_loss_and_gradients_match_jax(pair, rng):
    """Frames (48) and tokens (32) of different lengths: the cross-attention
    runs with Sq != Skv."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    batch = {k: rng.integers(1, cfg.vocab_size, (2, 32), dtype=np.int32)
             for k in ("tokens", "labels")}
    batch["frames"] = rng.standard_normal(
        (2, 48, cfg.frontend_dim)).astype(np.float32)
    assert_loss_and_grads_match(jmodel, jparams, tmodel, tparams, batch)


def test_prefill_caches_and_decode_match_jax(pair, rng):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    prompt = rng.integers(1, cfg.vocab_size, (2, 9), dtype=np.int32)
    frames = rng.standard_normal((2, cfg.source_len, cfg.frontend_dim)
                                 ).astype(np.float32)
    max_len = 16
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt),
                                      "frames": jnp.asarray(frames)}, max_len)
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(prompt), max_len,
                            frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jflat, tflat = _flat(jc), _flat(tc)
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
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
    for key, t in _flat(tc).items():
        np.testing.assert_allclose(t.numpy(), np.asarray(_flat(jc)[key]),
                                   **TOL, err_msg=key)


def test_prefill_refuses_frames_of_another_length(pair, rng):
    _, _, tmodel, tparams = pair
    cfg = tmodel.cfg
    tokens = torch.ones((1, 4), dtype=torch.int32)
    short = torch.zeros((1, cfg.source_len - 1, cfg.frontend_dim))
    with pytest.raises(ValueError, match=f"{cfg.source_len - 1}.*"
                                         f"{cfg.source_len}"):
        tmodel.prefill(tparams, tokens, frames=short)
    with pytest.raises(ValueError, match="frames"):
        tmodel.prefill(tparams, tokens)


def test_train_batches_carry_the_reference_frames():
    """The port's pipeline gives the audio batch the frames of the JAX
    package's pipeline, bit for bit, in ``input_specs``' shape (B, S,
    frontend_dim)."""
    jcfg, tcfg = _smoke(jax_configs), _smoke(port_configs)
    jshape = jax_configs.ShapeConfig("t", 16, 4, "train")
    specs = input_specs(jcfg, jshape)
    jit_ = jax_iterator(jcfg, jshape, seed=3)
    tit = make_train_iterator(tcfg, port_configs.ShapeConfig("t", 16, 4,
                                                             "train"), seed=3)
    try:
        jb, tb = next(jit_), next(tit)
    finally:
        jit_.close()
        tit.close()
    assert sorted(tb) == sorted(jb) == sorted(specs)
    for k in specs:
        assert tb[k].shape == specs[k].shape, k
        np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", ARCH])
def test_launch_train_trains_the_smoke_model(arch):
    cfg = port_configs.smoke_variant(port_configs.get_config(arch))
    records = []
    _, losses = train(cfg, steps=3, seq=32, batch=2, device="cpu",
                      on_step=lambda i, r: records.append(r),
                      log_fn=lambda _: None)
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert all(math.isfinite(r["grad_norm"]) for r in records)
    if arch == ARCH:
        assert all(r["aux"] == 0.0 for r in records)
    else:
        assert all(r["aux"] > 0.0 for r in records)
