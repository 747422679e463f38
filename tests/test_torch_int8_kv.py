"""The port's int8 KV cache, ``splice_cache`` and the proxy attention against
the JAX package's.

The quantiser is held bit for bit against JAX's ``_kv_quantize`` on seeded
numpy inputs (fp32 and bf16, an all-zero row, rows of large and tiny
magnitude, exact rounding ties), eagerly and under ``jax.jit`` (the models
run it inside a compiled scan, where XLA turns ``amax / 127.0`` into a
product with the reciprocal: ROADMAP C18).  Each family's smoke model (llama3.2-1b,
qwen3-moe, jamba, seamless-m4t) is initialised by the JAX package with
``kv_cache_dtype="int8"``; its parameters cross to the port through
``load_jax_params``.  Every int8 and scale leaf of the prefill cache equals
JAX's exactly, decode logits agree within 1e-4 (fp32, the model tests'
tolerance) and the JAX package's own check holds on the port: int8 decode
logits within 5 % of the compute-dtype cache's
(``tests/test_models_smoke.py::test_int8_kv_cache_decode_close_to_bf16``).
"""
import dataclasses
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.serve.engine import splice_cache as jax_splice_cache  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.models import build_model, layers, load_jax_params  # noqa: E402
from repro_torch.serve import splice_cache  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from test_torch_dense import GRAD_RTOL, LOSS_RTOL  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ("llama3.2-1b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
            "seamless-m4t-large-v2")
MAX_LEN = 24
PROMPT = 11


def _smoke(configs, arch, **kw):
    cfg = configs.smoke_variant(configs.get_config(arch))
    if cfg.family in ("dense", "moe"):
        kw.setdefault("num_layers", 2)
    return dataclasses.replace(cfg, **kw)


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """JAX and port models of one family's int8 smoke config, on the same
    parameters, with the compute-dtype-cache port model beside them."""
    arch = request.param
    jmodel = jax_build_model(_smoke(jax_configs, arch, kv_cache_dtype="int8"))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    tmodel = build_model(_smoke(port_configs, arch, kv_cache_dtype="int8"))
    plain = build_model(_smoke(port_configs, arch))
    return jmodel, jparams, tmodel, tparams, plain


def _inputs(cfg, rng, batch=2, prompt=PROMPT):
    tokens = rng.integers(1, cfg.vocab_size, (batch, prompt), dtype=np.int32)
    frames = None
    if cfg.family == "audio":
        frames = rng.standard_normal(
            (batch, cfg.source_len, cfg.frontend_dim)).astype(np.float32)
    return tokens, frames


def _jax_prefill(jmodel, jparams, tokens, frames, max_len):
    batch = {"tokens": jnp.asarray(tokens)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    return jmodel.prefill(jparams, batch, max_len)


def _port_prefill(tmodel, tparams, tokens, frames, max_len):
    kw = {} if frames is None else {"frames": torch.from_numpy(frames)}
    return tmodel.prefill(tparams, torch.from_numpy(tokens), max_len, **kw)


def _quantized_leaves(flat):
    """The int8 value and bf16 scale leaves of a flattened cache."""
    return sorted(k for k, v in flat.items()
                  if str(v.dtype).split(".")[-1] in ("int8", "bfloat16"))


def _assert_cache_equal(tc, jc):
    """Int8 and scale leaves bit for bit, every other leaf (SSM state, the
    cross K/V) within the model tolerance."""
    tflat, jflat = _flat(tc), _flat(jc)
    assert sorted(tflat) == sorted(jflat)
    quantized = _quantized_leaves(tflat)
    assert quantized == _quantized_leaves(jflat)
    assert any(k.endswith("['k_scale']") for k in quantized)
    for key, t in tflat.items():
        j = jflat[key]
        assert tuple(t.shape) == j.shape, key
        assert str(t.dtype).split(".")[-1] == str(j.dtype), key
        if key in quantized:
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32),
                                          err_msg=key)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL,
                                       err_msg=key)


# -- the quantiser ---------------------------------------------------------------


# a row whose amax / 127 differs by an ulp from amax * fl(1 / 127), with an
# element whose quotient is 1.4999999 by the one and 1.5 by the other: a
# quantiser that multiplies by the reciprocal rounds it to 2, not 1
RECIPROCAL_ROW = (1.8894879, 0.022316786)


def _quantizer_input(rng):
    """(4, 17, 2, 64) fp32: magnitudes spread over e^-12 .. e^12 a row, an
    all-zero row, rows of 1e30 and 1e-30 (under the 1e-8 scale floor), a
    row of exact ties (scale 1: x.5 values round half to even) and
    ``RECIPROCAL_ROW``."""
    x = rng.standard_normal((4, 17, 2, 64))
    x *= np.exp(rng.uniform(-12.0, 12.0, (4, 17, 2, 1)))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] *= 1e30 / np.abs(x[0, 1, 1]).max()
    x[1, 2, 0] = 1e-30
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                    np.float32)
    x[2, 3, 1] = np.resize(ties, 64)
    x[3, 4, 0] = 0.0
    x[3, 4, 0, :2] = RECIPROCAL_ROW
    return x


def _reciprocal_flips(x):
    """Where a quantiser whose scale is amax * fl(1/127) (what XLA makes of
    ``amax / 127.0`` under ``jit``: ROADMAP C18) rounds ``x`` (fp32 numpy)
    to another int8 value or bf16 scale than the true division does."""
    amax = np.abs(x).max(-1, keepdims=True)
    true = np.maximum(amax / np.float32(127.0), np.float32(1e-8))
    recip = np.maximum(amax * (np.float32(1.0) / np.float32(127.0)),
                       np.float32(1e-8))

    def q(scale):
        return np.clip(np.round(x / scale), -127, 127)

    def bf16(scale):
        return np.asarray(jnp.asarray(scale).astype(jnp.bfloat16), np.float32)

    return q(true) != q(recip), bf16(true) != bf16(recip)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_kv_quantize_equals_jax_bit_for_bit(rng, dtype, jit):
    """Int8 values and bf16 scales equal JAX's eager quantiser's; the count
    of elements that differ (a +-1 flip on a rounding tie) must be zero.
    Under ``jit`` XLA multiplies by fl(1/127) instead of dividing (C18), so
    there the elements that differ must be exactly those that such a
    product rounds elsewhere (``RECIPROCAL_ROW``'s in fp32)."""
    x = _quantizer_input(rng)
    jt = jnp.asarray(x).astype(dtype)
    tt = torch.from_numpy(x).to(getattr(torch, dtype))
    # both casts to bf16 round to nearest even: the same inputs
    np.testing.assert_array_equal(np.asarray(jt.astype(jnp.float32)),
                                  tt.float().numpy())
    fn = jax.jit(jax_layers._kv_quantize) if jit else jax_layers._kv_quantize
    jq, js = fn(jt)
    tq, ts = layers._kv_quantize(tt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == x.shape[:-1] + (1,)
    q_diff = tq.numpy().astype(np.int32) != np.asarray(jq).astype(np.int32)
    s_diff = ts.float().numpy() != np.asarray(js.astype(jnp.float32))
    want_q, want_s = _reciprocal_flips(tt.float().numpy())
    if not jit:
        want_q, want_s = np.zeros_like(want_q), np.zeros_like(want_s)
    assert int(q_diff.sum()) == int(want_q.sum()), \
        f"{int(q_diff.sum())} int8 values differ from JAX's"
    np.testing.assert_array_equal(q_diff, want_q)
    np.testing.assert_array_equal(s_diff, want_s)
    # true division: the reciprocal row's element rounds to 1
    assert int(tq[3, 4, 0, 1]) == 1 or dtype == "bfloat16"
    if jit and dtype == "float32":
        assert want_q[3, 4, 0, 1] and int(want_q.sum()) >= 1
    # the rows that pin the edges
    assert not tq[0, 0, 0].any()
    assert float(ts[0, 0, 0]) == float(torch.tensor(1e-8).bfloat16())
    assert not tq[1, 2, 0].any()
    if dtype == "float32":
        assert tq[2, 3, 1, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


# -- the int8 cache of every family ---------------------------------------------


def test_init_cache_int8_matches_jax(pair):
    jmodel, _, tmodel, _, _ = pair
    jflat = _flat(jmodel.init_cache(2, 16, dtype=jnp.float32))
    tflat = _flat(tmodel.init_cache(2, 16, torch.float32, "cpu"))
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jflat[key].dtype), key
        assert not t.any(), key


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _held_to_jax(run, jc, pos):
    """``run()``: a port prefill or decode step (logits, cache), whose
    quantised writes start at sequence position ``pos``; ``jc``: JAX's
    cache after the same call.  The int8 values the call writes must equal
    JAX's, except where the quotient t/scale of the port's own input lies
    on a rounding tie (x.5 within 1e-3): the two packages' k/v differ by the
    fp32 noise of their projections (~1e-6), so at a tie they may round to
    neighbours, and the value then differs by exactly 1.  The call is then
    run again with JAX's value at those elements alone, so that the rest of
    it is still held to the model tolerance.  Returns (logits, cache,
    number of tie flips)."""
    prefix = next(k for k in _flat(jc) if k.endswith("['k_scale']"))
    jflat = _flat(jc)
    prefix = prefix[:-len("['k_scale']")]
    calls, quantize = [], layers._kv_quantize

    def recording(t):
        out = quantize(t)
        calls.append((t, *out))
        return out

    with mock.patch.object(layers, "_kv_quantize", recording):
        tl, tc = run()
    fixed, flips = [], 0
    for n, (t, q, s) in enumerate(calls):
        layer, name = divmod(n, 2)
        want = torch.from_numpy(np.array(
            jflat[f"{prefix}['{'kv'[name]}']"][layer][:, pos:pos + q.shape[1]]))
        diff = q.int() - want.int()
        if diff.any():
            assert int(diff.abs().max()) == 1, (layer, name)
            tf = t.float()
            amax = tf.abs().amax(-1, keepdim=True)
            quot = tf / torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
            tie = (quot.abs() - quot.abs().floor() - 0.5).abs()
            assert float(tie[diff != 0].max()) <= 1e-3, (layer, name)
            flips += int((diff != 0).sum())
        fixed.append((want.to(torch.int8), s))
    if flips:
        it = iter(fixed)
        with mock.patch.object(layers, "_kv_quantize", lambda t: next(it)):
            tl, tc = run()
    return tl, tc, flips


def test_prefill_int8_cache_and_decode_match_jax(pair, rng):
    """Every int8 and scale leaf of the prefill cache equals JAX's, and
    greedy decode logits are within 1e-4 of JAX's int8 decode, with the
    leaves each step wrote equal to JAX's (a rounding tie of the quotient
    aside: ``_held_to_jax``)."""
    jmodel, jparams, tmodel, tparams, _ = pair
    tokens, frames = _inputs(tmodel.cfg, rng)
    jl, jc = _jax_prefill(jmodel, jparams, tokens, frames, MAX_LEN)
    tl, tc, _ = _held_to_jax(lambda: _port_prefill(
        tmodel, tparams, tokens, frames, MAX_LEN), jc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_equal(tc, jc)
    clen = tokens.shape[1]
    for _ in range(4):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tok[:, 0], torch.argmax(tl[:, -1], -1).numpy())
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(tok), clen)
        before = tc
        tl, tc, _ = _held_to_jax(lambda: tmodel.decode(
            tparams, _clone(before), torch.from_numpy(tok), clen), jc, clen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_equal(tc, jc)
        clen += 1


def test_int8_decode_close_to_compute_dtype_cache(pair, rng):
    """The JAX package's own check on the port: the int8 cache's decode
    logits within 5 % of the compute-dtype cache's, on the same weights,
    with int8 leaves and their scales in the cache."""
    _, _, tmodel, tparams, plain = pair
    tokens, frames = _inputs(tmodel.cfg, rng, prompt=33)
    prompt, last = tokens[:, :32], torch.from_numpy(tokens[:, 32:33])
    _, c1 = _port_prefill(plain, tparams, prompt, frames, 40)
    l1, _ = plain.decode(tparams, c1, last, 32)
    _, c2 = _port_prefill(tmodel, tparams, prompt, frames, 40)
    l2, _ = tmodel.decode(tparams, c2, last, 32)
    rel = float((l1 - l2).abs().max()) / float(l1.abs().max())
    assert rel < 0.05, rel
    flat = _flat(c2)
    assert any(v.dtype == torch.int8 for v in flat.values())
    assert any(k.endswith("['k_scale']") for k in flat)


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_int8_cache_axes_match_jax(arch):
    """The logical axes of an int8 config's cache, the scales' included,
    equal the JAX model's for every published config."""
    tcfg = dataclasses.replace(port_configs.get_config(arch),
                               kv_cache_dtype="int8")
    jcfg = dataclasses.replace(jax_configs.get_config(arch),
                               kv_cache_dtype="int8")
    axes = build_model(tcfg).cache_axes()
    assert axes == jax_build_model(jcfg).cache_axes()
    assert layers.kv_cache_axes(tcfg) == jax_layers.kv_cache_axes(jcfg)


# -- splice_cache ------------------------------------------------------------------


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 5), st.integers(0, 4), st.integers(0, 10_000))
def test_splice_cache_matches_jax(slots, slot, seed):
    """The cases of ``tests/test_serve_blocks.py``: leaves whose batch axis
    sits at different positions, in dicts and lists; the port's result
    equals JAX's and ``full`` is left unchanged."""
    slot = slot % slots
    rng = np.random.default_rng(seed)
    shapes = {"k": ((slots, 4, 3), (1, 4, 3)),
              "nested": [((3, slots, 2), (3, 1, 2)), ((slots,), (1,))]}

    def draw(i):
        return {"k": rng.standard_normal(shapes["k"][i]).astype(np.float32),
                "nested": [rng.standard_normal(s[i]).astype(np.float32)
                           for s in shapes["nested"]]}

    full, one = draw(0), draw(1)
    want = jax.tree_util.tree_map(np.asarray,
                                  jax_splice_cache(full, one, slot))

    def to_torch(tree):
        return jax.tree_util.tree_map(torch.from_numpy, tree)

    tfull, tone = to_torch(full), to_torch(one)
    got = splice_cache(tfull, tone, slot)
    assert isinstance(got["nested"], list)
    for g, w, f, tf in zip(jax.tree_util.tree_leaves(got),
                           jax.tree_util.tree_leaves(want),
                           jax.tree_util.tree_leaves(full),
                           jax.tree_util.tree_leaves(tfull)):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(tf.numpy(), f)
        assert g.data_ptr() != tf.data_ptr()


def test_splice_cache_casts_to_full_and_splices_a_model_cache(rng):
    """A one-sequence int8 smoke cache spliced into a batch cache, leaf by
    leaf on the layer-stacked tree, as JAX's splices it; an fp32 leaf into
    a bf16 one takes ``full``'s dtype."""
    cfg = _smoke(port_configs, "llama3.2-1b", kv_cache_dtype="int8")
    jcfg = _smoke(jax_configs, "llama3.2-1b", kv_cache_dtype="int8")
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    full = model.init_cache(3, 8, torch.float32, "cpu")
    one = model.init_cache(1, 8, torch.float32, "cpu")
    for tree, scale in ((full, 1.0), (one, 2.0)):
        for k, v in tree.items():
            src = rng.standard_normal(tuple(v.shape)) * 40 * scale
            v.copy_(torch.from_numpy(src).to(v.dtype))
    full_np = {k: v.float().numpy() for k, v in full.items()}
    got = splice_cache(full, one, 2)
    jfull = jmodel.init_cache(3, 8, dtype=jnp.float32)
    jfull = {k: jnp.asarray(full_np[k]).astype(jfull[k].dtype) for k in jfull}
    jone = {k: jnp.asarray(v.float().numpy()).astype(jfull[k].dtype)
            for k, v in one.items()}
    want = jax_splice_cache(jfull, jone, 2)
    for k, g in got.items():
        assert g.dtype == full[k].dtype, k
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(want[k], np.float32),
                                      err_msg=k)
        np.testing.assert_array_equal(full[k].float().numpy(), full_np[k])
    g = splice_cache({"x": torch.zeros(3, 2, dtype=torch.bfloat16)},
                     {"x": torch.full((1, 2), 1.0 / 3.0)}, 1)["x"]
    assert g.dtype == torch.bfloat16
    assert g[1].tolist() == [float(torch.tensor(1.0 / 3.0).bfloat16())] * 2


# -- the proxy attention ---------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-large-v2"])
def test_proxy_attention_loss_and_grads_match_jax(rng, arch):
    """``attn_impl="proxy"``, the dry run's zero-traffic attention stub: the
    loss, its metrics and every gradient leaf equal JAX's (self-attention,
    and seamless's encoder and cross-attention).  The stub reads no k or v,
    so their projections' gradients are zero in JAX and unused in the
    port."""
    jmodel = jax_build_model(_smoke(jax_configs, arch, attn_impl="proxy"))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    tmodel = build_model(_smoke(port_configs, arch, attn_impl="proxy"))
    cfg = tmodel.cfg
    batch = {k: rng.integers(1, cfg.vocab_size, (2, 16), dtype=np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, 16, cfg.frontend_dim)).astype(np.float32)
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tree_map(lambda t: t.detach().requires_grad_(), tparams)
    tl, tm = tmodel.loss(params, {k: torch.tensor(v)
                                  for k, v in batch.items()})
    tg = torch.autograd.grad(tl, leaves(params), allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jleaves)
    unused = 0
    for t, j in zip(tg, jleaves):
        j = np.asarray(j)
        if t is None:
            unused += 1
            assert not j.any()
            continue
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=GRAD_RTOL * np.abs(j).max())
    assert unused >= 2          # wk and wv at least


def test_proxy_attention_is_the_scaled_query():
    """The stub returns q / sqrt(head_dim) whatever k and v are, and runs
    no kernel."""
    cfg = _smoke(port_configs, "llama3.2-1b", attn_impl="proxy")
    q = torch.randn(2, 5, 4, 32, generator=torch.Generator().manual_seed(0))
    k = torch.full((2, 9, 2, 32), float("nan"))
    out = layers._sdpa(q, k, k, cfg)
    assert torch.equal(out, q * (1.0 / 32 ** 0.5))
