"""The port's configs and dense model against the JAX package's.

The JAX model is initialised from its own PRNG key; its parameters cross to
the port as numpy arrays through ``load_jax_params``, so both packages
compute with the same weights.  2-layer smoke llama3.2-1b, fp32: logits
agree within 1e-4 and greedy tokens are identical.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.models import (  # noqa: E402
    build_model,
    compute_params,
    load_jax_params,
)

torch.set_num_threads(2)

MAX_LEN = 32


def _tiny(configs):
    return dataclasses.replace(
        configs.smoke_variant(configs.get_config("llama3.2-1b")), num_layers=2
    )


@pytest.fixture(scope="module")
def pair():
    jcfg = _tiny(jax_configs)
    jmodel = jax_build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, build_model(_tiny(port_configs)), tparams


# archs the port registers beside the JAX package's
PORT_ONLY_ARCHS = {"granite-4.0-h-small"}


def _as_jax(port: dict, jax_side: dict, defaults: dict) -> dict:
    """``port`` (``dataclasses.asdict`` of a port config) on the JAX
    config's fields; each field the JAX package lacks must hold its
    default, so it changes nothing there."""
    out = {}
    for k, v in port.items():
        if k not in jax_side:
            assert v == defaults[k], k
        elif isinstance(v, dict) and isinstance(jax_side[k], dict):
            out[k] = _as_jax(v, jax_side[k], defaults[k])
        else:
            out[k] = v
    return out


def _defaults(cls) -> dict:
    """Each field's default, nested configs' fields by name."""
    nested = {"moe": port_configs.MoEConfig, "mamba": port_configs.MambaConfig}
    out = {f.name: f.default for f in dataclasses.fields(cls)}
    for k, sub in nested.items():
        if k in out:
            out[k] = _defaults(sub)
    return out


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_configs_equal_field_for_field(arch):
    assert set(port_configs.list_archs()) == \
        set(jax_configs.list_archs()) | PORT_ONLY_ARCHS
    jcfg, tcfg = jax_configs.get_config(arch), port_configs.get_config(arch)
    defaults = _defaults(port_configs.ArchConfig)
    for t, j in ((tcfg, jcfg), (port_configs.smoke_variant(tcfg),
                                jax_configs.smoke_variant(jcfg))):
        jd = dataclasses.asdict(j)
        assert _as_jax(dataclasses.asdict(t), jd, defaults) == jd


def test_init_params_keys_shapes_dtypes_match(pair):
    jmodel, jparams, tmodel, _ = pair
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", v

    tflat = dict(flat(tparams))
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jflat[key].dtype), key


def test_prefill_and_decode_match_jax(pair, rng):
    jmodel, jparams, tmodel, tparams = pair
    prompt = rng.integers(1, tmodel.cfg.vocab_size, 11, dtype=np.int32)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt[None])},
                                     MAX_LEN)
    tlogits, tcache = tmodel.prefill(tparams, torch.from_numpy(prompt[None]),
                                     MAX_LEN)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    jtok = int(jnp.argmax(jlogits[0, -1]))
    ttok = int(torch.argmax(tlogits[0, -1]))
    assert ttok == jtok
    clen = len(prompt)
    for _ in range(6):
        jlogits, jcache = jmodel.decode(
            jparams, jcache, jnp.asarray([[jtok]], jnp.int32), clen)
        tlogits, tcache = tmodel.decode(
            tparams, tcache, torch.tensor([[ttok]], dtype=torch.int32), clen)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        jtok = int(jnp.argmax(jlogits[0, -1]))
        ttok = int(torch.argmax(tlogits[0, -1]))
        assert ttok == jtok
        clen += 1
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-4, atol=1e-4)


def test_compute_params_cast_once_gives_identical_numbers(pair, rng):
    """Casting the block weights to the compute dtype once equals the
    per-use cast the layers (and the JAX code) do."""
    _, _, tmodel, tparams = pair
    cfg = dataclasses.replace(tmodel.cfg, compute_dtype="bfloat16")
    model = build_model(cfg)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 9),
                                           dtype=np.int32))
    cast = compute_params(tparams, cfg)
    assert cast["blocks"]["mlp"]["wg"].dtype == torch.bfloat16
    assert cast["blocks"]["norm1"].dtype == torch.float32
    assert cast["embed"].dtype == torch.float32
    a, _ = model.prefill(tparams, tokens)
    b, _ = model.prefill(cast, tokens)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_every_config_builds_with_the_reference_cache_axes(arch):
    """Every family of the JAX package is ported: each published config
    builds, and its cache's logical axes are the JAX model's."""
    model = build_model(port_configs.get_config(arch))
    jmodel = jax_build_model(jax_configs.get_config(arch))
    assert model.cache_axes() == jmodel.cache_axes()
