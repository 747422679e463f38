"""The port's MoE FFN and MoE model against the JAX package's, and the
Table-2 rows of the dense and MoE models on the CPU.

Inputs are made with numpy from a seed and handed to both packages; weights
come from the JAX package's init through ``load_jax_params``.  The chosen
experts are compared first and must be identical, so a routing flip fails
as a routing mismatch, not as a tolerance miss.  fp32 throughout: outputs
and the aux loss within 1e-5, gradients within 1e-4 of each leaf's largest
entry, logits within 1e-4.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.launch import sim_accuracy  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from test_torch_dense import assert_loss_and_grads_match  # noqa: E402

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"


def _smoke(configs, **kw):
    return dataclasses.replace(
        configs.smoke_variant(configs.get_config(ARCH)), num_layers=2, **kw)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(_smoke(jax_configs))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, build_model(_smoke(port_configs)), tparams


def _jax_route(p, x, m):
    """The JAX FFN's routing of x (B, S, D) in its groups: the chosen
    experts (g, group, k)."""
    n_tok = x.shape[0] * x.shape[1]
    group = min(m.group_size, n_tok)
    group = group if n_tok % group == 0 else n_tok
    xg = x.reshape(n_tok // group, group, -1)
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", xg, p["router"]), -1)
    return np.asarray(jax.lax.top_k(probs, m.top_k)[1])


# (batch, seq, capacity factor): two groups with the config's capacity, a
# capacity that drops choices, one odd-sized group, single-token decode
@pytest.mark.parametrize("b,s,cf", [(2, 32, 1.25), (2, 32, 0.5), (3, 7, 1.25),
                                    (2, 1, 1.25)])
def test_moe_ffn_matches_jax(rng, b, s, cf):
    m = dataclasses.replace(_smoke(port_configs).moe, capacity_factor=cf)
    jm = dataclasses.replace(_smoke(jax_configs).moe, capacity_factor=cf)
    jp, _ = jax_moe.init_moe(jax.random.PRNGKey(1), 128, jm, jnp.float32)
    tp = load_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = rng.standard_normal((b, s, 128)).astype(np.float32)
    n_tok = b * s
    group = moe.group_size(m, n_tok)
    assert group == (min(32, n_tok) if n_tok % min(32, n_tok) == 0
                     else n_tok)
    assert moe.capacity(m, group) == jax_moe.capacity(jm, group)
    # routing first
    xt = torch.from_numpy(x).requires_grad_()
    _, _, idx = moe.route(tp, xt.reshape(n_tok // group, group, 128), m)
    np.testing.assert_array_equal(idx.numpy(), _jax_route(jp, x, jm))

    def jloss(p, xx):
        y, aux = jax_moe.moe_ffn(p, xx, jm, jnp.float32)
        return jnp.sum(y * y) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jp, jnp.asarray(x))
    params = tree_map(lambda t: t.requires_grad_(), tp)
    y, aux = moe.moe_ffn(params, xt, m, torch.float32)
    tg = torch.autograd.grad((y * y).sum() + aux, leaves(params) + [xt])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    for t, j in zip(tg, jax.tree_util.tree_leaves(jg[0]) + [jg[1]]):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-4 * np.abs(j).max())


def test_ep_a2a_takes_the_einsum_path(rng):
    """Without a mesh the JAX package runs ``impl="ep_a2a"`` through the
    einsum path; so does the port (it has no mesh)."""
    m = _smoke(port_configs).moe
    tp = moe.init_moe(torch.Generator().manual_seed(0), 128, m, "float32")
    x = torch.from_numpy(rng.standard_normal((2, 16, 128)).astype(np.float32))
    y, aux = moe.moe_ffn(tp, x, m, torch.float32)
    ye, auxe = moe.moe_ffn(tp, x, dataclasses.replace(m, impl="ep_a2a"),
                           torch.float32)
    assert torch.equal(y, ye) and torch.equal(aux, auxe)


def test_model_routing_loss_and_grads_match_jax(pair, rng, monkeypatch):
    """The smoke qwen3-moe (2 layers, 4 experts top-2, groups of 32): each
    layer's chosen experts in the loss's forward pass, then the loss, ce,
    aux and every gradient leaf."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    batch = {k: rng.integers(1, cfg.vocab_size, (2, 32), dtype=np.int32)
             for k in ("tokens", "labels")}
    # the port's routing, recorded where moe_ffn routes
    seen = []
    route = moe.route

    def recording(p, xg, m):
        out = route(p, xg, m)
        seen.append(out[2].numpy().copy())
        return out

    monkeypatch.setattr(moe, "route", recording)
    with torch.no_grad():
        tmodel.loss(tparams, {k: torch.tensor(v) for k, v in batch.items()})
    monkeypatch.undo()
    # the JAX routing: its blocks applied one by one, eagerly, on the same
    # inputs, each layer's normed hidden routed as its FFN routes it
    jcfg = jmodel.cfg
    h, positions, _ = jax_transformer._embed_inputs(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    for i in range(jcfg.num_layers):
        bp = jax.tree_util.tree_map(lambda a: a[i], jparams["blocks"])
        h1 = h + jax_transformer.L.attention(
            bp["attn"], jax_transformer.L.rmsnorm(
                h, bp["norm1"], jcfg.norm_eps, jcfg.compute_dtype),
            jcfg, positions=positions)
        n = jax_transformer.L.rmsnorm(h1, bp["norm2"], jcfg.norm_eps,
                                      jcfg.compute_dtype)
        np.testing.assert_array_equal(
            seen[i], _jax_route(bp["moe"], n, jcfg.moe),
            err_msg=f"layer {i}: routing differs")
        h, _ = jax_transformer.apply_block(bp, h, jcfg, positions=positions)
    assert len(seen) == cfg.num_layers
    assert_loss_and_grads_match(jmodel, jparams, tmodel, tparams, batch)


def test_prefill_and_decode_match_jax(pair, rng):
    jmodel, jparams, tmodel, tparams = pair
    prompt = rng.integers(1, tmodel.cfg.vocab_size, (2, 11), dtype=np.int32)
    max_len = 24
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, max_len)
    tl, tc = tmodel.prefill(tparams, torch.from_numpy(prompt), max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    clen = prompt.shape[1]
    for _ in range(6):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tok[:, 0],
                              torch.argmax(tl[:, -1], -1).numpy())
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(tok), clen)
        tl, tc = tmodel.decode(tparams, tc, torch.from_numpy(tok), clen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        clen += 1


@pytest.mark.parametrize("arch", [ARCH, "pixtral-12b"])
def test_init_params_keys_shapes_dtypes_match_jax(arch):
    """The MoE block (router fp32, experts stacked (L, E, ., .)) and the
    vlm projector: the port's random init has the JAX tree's keys, shapes
    and dtypes, and the published config builds."""
    jmodel = jax_build_model(jax_configs.smoke_variant(
        jax_configs.get_config(arch)))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(port_configs.smoke_variant(
        port_configs.get_config(arch)))
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jflat[key].dtype), key
    assert build_model(port_configs.get_config(arch)).cfg.family in (
        "moe", "vlm")


def _on_fields(port: dict, jax_side: dict) -> dict:
    """A port config's ``asdict`` on the JAX config's fields (the port's
    granite fields, at defaults that add no operation, left out)."""
    return {k: _on_fields(v, jax_side[k]) if isinstance(v, dict)
            and isinstance(jax_side[k], dict) else v
            for k, v in port.items() if k in jax_side}


@pytest.mark.parametrize("arch,row,nodes", [
    ("llama3.2-1b", "dense_llama", {"flash_attention": 4, "rmsnorm": 9}),
    (ARCH, "moe_qwen3", {"flash_attention": 4, "rmsnorm": 9}),
])
def test_sim_accuracy_rows_run_on_the_cpu(monkeypatch, capsys, arch, row,
                                          nodes):
    """``launch.sim_accuracy --smoke --device cpu`` for the dense and MoE
    rows: the JAX benchmark's variant (4 layers, no remat: one flash node a
    layer, two block norms a layer and the final norm), small starting
    grids and few refined signatures to keep the CPU run short."""
    from benchmarks.bench_sim_accuracy import _models

    cfg = sim_accuracy.smoke_config(arch)
    jcfg, shape = _models()[row]
    assert _on_fields(dataclasses.asdict(cfg), dataclasses.asdict(jcfg)) \
        == dataclasses.asdict(jcfg)
    assert (shape.seq_len, shape.global_batch) == (128, 8)
    monkeypatch.setattr(sim_accuracy, "MATMUL_SIZES", (32, 64))
    monkeypatch.setattr(sim_accuracy, "VECTOR_SIZES", (2**10, 2**12))
    monkeypatch.setattr(sim_accuracy, "REFINE_TOP", 4)
    sim_accuracy.main(["--arch", arch, "--smoke", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["name"] == f"table2_{row}"
    assert out["seq"] == 128 and out["batch"] == 8
    # on the CPU the flash op's gradient is the plain VJP: no backward node
    assert out["graph_kernel_nodes"] == {**nodes, "ssd_scan": 0,
                                         "flash_attention_bwd": 0}
    assert out["graph_kinds"]["custom-call"] == sum(nodes.values())
    assert out["kernel_launches_per_step"] == {
        "flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0,
        "flash_attention_bwd": 0}
    assert out["measured_s"] > 0
    assert np.isfinite([out["err_offline"], out["err_refined"]]).all()
    assert out["provenance_refined"]["db"] > out["provenance_offline"]["db"]


def test_moe_at_full_width_needs_expert_parallelism():
    with pytest.raises(SystemExit):
        sim_accuracy.main(["--arch", ARCH, "--device", "cpu"])
