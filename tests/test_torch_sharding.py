"""The port's logical-axis sharding resolver against the JAX package's.

For every parameter leaf of the dense, moe and vlm configs at their
published shapes (``Model.abstract_params``, no allocation), on the
production meshes (data 16 x model 16) and (pod 2 x data 16 x model 16):
the port's ``tree_specs`` (plain and ZeRO-1) and the recorded drops equal
the JAX package's ``ShardingCtx``, and ``Model.param_axes()`` equals the
axes tree the JAX ``init`` returns, for both MoE layouts.  JAX's resolver
reads only a mesh's ``axis_names`` and ``devices.shape``, so it gets an
object with those.  Then the port's own pieces: ``shards`` (a rank's piece
under a spec), ``shard_hint`` and the context.
"""
import dataclasses
import functools
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import sharding as jax_sharding  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.dist import mesh as M  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402

torch.set_num_threads(2)

# (arch, MoE impl or None)
ARCHS = [("llama3.2-1b", None), ("qwen3-moe-235b-a22b", "einsum"),
         ("qwen3-moe-235b-a22b", "ep_a2a"), ("phi4-mini-3.8b", None),
         ("granite-3-2b", None), ("qwen1.5-110b", None),
         ("pixtral-12b", None), ("kimi-k2-1t-a32b", "ep_a2a")]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _cfg(configs, arch, impl):
    cfg = configs.get_config(arch)
    if impl is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    return cfg


@functools.lru_cache(maxsize=None)
def _abstract(arch, impl):
    """(JAX shapes, JAX axes, port shapes, port axes) of one config."""
    jshapes, jaxes = jax_build_model(_cfg(jax_configs, arch, impl)) \
        .abstract_params()
    tshapes, taxes = build_model(_cfg(port_configs, arch, impl)) \
        .abstract_params()
    return jshapes, jaxes, tshapes, taxes


def _jax_mesh(shape, names):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _flat_specs(tree, prefix=()):
    """{path: spec as a plain tuple} of a nested dict of specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tuple(tree)}


def _drops(ctx):
    return [(d.tensor, d.dim, d.logical, tuple(d.wanted), d.size, d.reason)
            for d in ctx.drops]


@pytest.mark.parametrize("arch,impl", ARCHS)
def test_param_axes_equal_jax(arch, impl):
    _, jaxes, tshapes, taxes = _abstract(arch, impl)
    assert taxes == jaxes
    assert build_model(_cfg(port_configs, arch, impl)).param_axes() == jaxes
    # every leaf has one logical axis per dimension
    from repro_torch.tree import leaves

    flat_axes = [a for _, a in sorted(_flat_specs(taxes).items())]
    assert [len(a) for a in flat_axes] == \
        [len(t.shape) for t in leaves(tshapes)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("zero1", [False, True, "not_experts"])
@pytest.mark.parametrize("arch,impl", ARCHS)
def test_tree_specs_and_drops_equal_jax(arch, impl, zero1, mesh_name):
    jshapes, jaxes, tshapes, taxes = _abstract(arch, impl)
    shape, names = MESHES[mesh_name]
    cfg = port_configs.get_config(arch)
    jctx = jax_sharding.make_ctx(_jax_mesh(shape, names),
                                 overrides=cfg.sharding_overrides)
    tctx = S.make_ctx(M.Mesh(names, shape, ()),
                      overrides=cfg.sharding_overrides)
    if zero1 == "not_experts":   # selective ZeRO: a per-leaf predicate
        def zero1(axes):
            return not any(a and a.startswith("expert") for a in axes)
    want = _flat_specs(jax_sharding.tree_specs(jctx, jshapes, jaxes,
                                               zero1=zero1))
    got = _flat_specs(S.tree_specs(tctx, tshapes, taxes, zero1=zero1))
    assert got == want
    assert _drops(tctx) == _drops(jctx)


@pytest.mark.parametrize("arch,impl", ARCHS[:3])
def test_activation_specs_equal_jax(arch, impl):
    """``spec_for`` of the activations the JAX model hints (batch, groups,
    heads), at the published widths and a batch that does not split."""
    cfg = port_configs.get_config(arch)
    cases = [(("batch", "seq", "embed"), (256, 2048, cfg.d_model)),
             (("batch", "seq", "embed"), (3, 2048, cfg.d_model)),
             (("batch", "seq", "act_heads", None),
              (32, 2048, cfg.num_heads, 128)),
             (("group", None, "act_experts", None), (64, 512, 128, 40)),
             (("batch", "kv_seq", "kv_heads", "head_dim"),
              (8, 4096, cfg.num_kv_heads, 64))]
    for shape, names in MESHES.values():
        jctx = jax_sharding.make_ctx(_jax_mesh(shape, names))
        tctx = S.make_ctx(M.Mesh(names, shape, ()))
        for axes, dims in cases:
            assert tuple(tctx.spec_for(axes, dims, "act")) == \
                tuple(jctx.spec_for(axes, dims, "act")), (axes, dims)
        assert _drops(tctx) == _drops(jctx)
        assert S.data_axis_size(tctx.mesh) == \
            jax_sharding.data_axis_size(jctx.mesh)


def test_unknown_logical_axis_raises():
    ctx = S.make_ctx(M.Mesh(("data",), (2,), ()))
    with pytest.raises(KeyError, match="no sharding rule"):
        ctx.spec_for(("nonsense",), (4,), "t")


def test_shards_tile_the_tensor():
    """Each rank's piece is the block at its row-major index over the
    spec's axes (a tuple part splits over both, the first major); the
    pieces are views and their gradients assemble the whole."""
    mesh = M.make_mesh((2, 2, 3), ("pod", "data", "model"), "cpu")
    x = torch.arange(8 * 6 * 5, dtype=torch.float32).reshape(8, 6, 5)
    x.requires_grad_()
    spec = S.P(("pod", "data"), "model", None)
    got = S.shards(x, spec, mesh)
    assert set(got) == set(mesh.coords())
    total = 0
    for (p, d, m), piece in got.items():
        i = p * 2 + d
        np.testing.assert_array_equal(
            piece.detach().numpy(),
            x.detach().numpy()[2 * i:2 * i + 2, 2 * m:2 * m + 2])
        assert piece._base is x or piece._base is x._base
        total = total + piece.sum() * (1 + p + d + m)
    total.backward()
    want = np.zeros((8, 6, 5), np.float32)
    for p in range(2):
        for d in range(2):
            for m in range(3):
                i = p * 2 + d
                want[2 * i:2 * i + 2, 2 * m:2 * m + 2] = 1 + p + d + m
    np.testing.assert_array_equal(x.grad.numpy(), want)
    with pytest.raises(ValueError, match="does not split"):
        S.shards(torch.zeros(3, 6), S.P("data", None), mesh)


def test_shard_hint_records_drops_and_context_nests():
    x = torch.zeros(3, 24, 4)
    assert S.shard_hint(x, ("batch", "act_heads", None)) is x
    assert S.current_ctx() is None
    outer = S.make_ctx(M.Mesh(("data", "model"), (2, 16), ()))
    with S.use_sharding(outer):
        assert S.current_ctx() is outer
        assert S.shard_hint(x, ("batch", "act_heads", None), "h") is x
        with S.use_sharding(None):
            assert S.current_ctx() is None
        assert S.current_ctx() is outer
    assert S.current_ctx() is None
    jctx = jax_sharding.make_ctx(_jax_mesh((2, 16), ("data", "model")))
    jctx.spec_for(("batch", "act_heads", None), (3, 24, 4), "h")
    assert _drops(outer) == _drops(jctx) and len(outer.drops) == 2
    assert repr(S.P("data", None)) == "PartitionSpec('data', None)"
