"""The port's kernel ops on the CPU (their plain versions) against the JAX
package's Pallas kernels in interpret mode and its model-level attention.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the JAX package's kernel tolerances (tests/test_kernels.py):
2e-5 for fp32, 2e-2 for bf16.  The CUDA kernels themselves run only on a
card: ``chip_smoke.py`` holds them against these plain versions there.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config, smoke_variant  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro.kernels.rmsnorm.ops import fused_rmsnorm as jax_fused_rmsnorm  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CFG = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                          num_layers=2)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounding of
    fp32 is round-to-nearest-even in both)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return jnp.asarray(a, dtype), t.to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        rtol=TOL[dtype], atol=TOL[dtype],
    )


# -- RMSNorm --------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 64), (37, 128), (3, 5, 256), (130, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_interpret(rng, shape, dtype):
    """Ragged row counts (37, 130 are not multiples of the TPU row block)."""
    xj, xt = _pair(rng.standard_normal(shape), dtype)
    wj, wt = _pair(rng.standard_normal(shape[-1]), dtype)
    want = jax_fused_rmsnorm(xj, wj, interpret=True)
    got = rms_ops.fused_rmsnorm(xt, wt)
    assert got.dtype == xt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_layer_matches_jax_layer(rng, dtype):
    """The layer's contract: fp32 weight, output in the compute dtype."""
    xj, xt = _pair(rng.standard_normal((2, 7, 128)), dtype)
    wj, wt = _pair(rng.standard_normal(128), "float32")
    want = JL.rmsnorm(xj, wj, 1e-5, jnp.dtype(dtype))
    got = TL.rmsnorm(xt, wt, 1e-5, dtype)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_rmsnorm_out_dtype_and_no_cpu_launches(rng):
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.ones(64)
    before = rms_ops.LAUNCHES.count
    y = rms_ops.fused_rmsnorm(x, w, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert rms_ops.LAUNCHES.count == before   # the plain version is no launch


# -- flash attention ------------------------------------------------------------


@pytest.mark.parametrize("b,sq,skv,h,kh,d,causal,kv_valid", [
    (1, 64, 64, 4, 4, 64, True, None),      # MHA, causal Sq == Skv
    (2, 50, 50, 8, 2, 32, True, None),      # GQA, ragged, causal
    (1, 40, 100, 4, 2, 64, False, None),    # non-causal Sq != Skv
    (2, 24, 70, 4, 1, 32, False, 45),       # MQA, kv_valid < Skv
    (1, 33, 33, 4, 2, 64, True, 20),        # causal and kv_valid together
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas_interpret(
    rng, b, sq, skv, h, kh, d, causal, kv_valid, dtype
):
    qj, qt = _pair(rng.standard_normal((b, sq, h, d)), dtype)
    kj, kt = _pair(rng.standard_normal((b, skv, kh, d)), dtype)
    vj, vt = _pair(rng.standard_normal((b, skv, kh, d)), dtype)
    want = flash_attention_fwd(qj, kj, vj, causal=causal, kv_valid=kv_valid,
                               block_q=32, block_k=32, interpret=True)
    kv_len = None if kv_valid is None else torch.full((b,), kv_valid)
    got = fa_ops.flash_attention(qt, kt, vt, causal=causal, kv_len=kv_len)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dtype)


def test_attention_fully_masked_rows_are_zero(rng):
    """kv_len 0 for one row: every query of that row sees nothing -> 0, as
    the TPU kernel writes a fully masked row."""
    q = torch.from_numpy(rng.standard_normal((2, 3, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 5, 2, 32)).astype(np.float32))
    out = attention_ref(q, k, k, causal=False, kv_len=torch.tensor([0, 5]))
    assert torch.count_nonzero(out[0]) == 0
    assert torch.isfinite(out).all() and torch.count_nonzero(out[1]) > 0


@pytest.mark.parametrize("sq,skv,offset", [(4, 4, 0), (3, 9, 6), (1, 16, 15)])
def test_causal_mask_matches_jax(sq, skv, offset):
    np.testing.assert_array_equal(
        TL.causal_mask(sq, skv, offset).numpy(),
        np.asarray(JL.causal_mask(sq, skv, offset)))


def _jax_sdpa(q, k, v, mask):
    return JL._sdpa(q, k, v, mask, CFG)


@pytest.mark.parametrize("start,width", [(0, 8), (8, 5), (16, 8)])
def test_attention_matches_sdpa_under_paged_prefill_mask(rng, start, width):
    """paged.py's prefill mask: kv_pos <= start + i over the whole view."""
    bucket, view = 8, 32
    qj, qt = _pair(rng.standard_normal((1, bucket, 4, 32)), "float32")
    kj, kt = _pair(rng.standard_normal((1, view, 2, 32)), "float32")
    vj, vt = _pair(rng.standard_normal((1, view, 2, 32)), "float32")
    pos = start + jnp.arange(bucket)
    mask = (jnp.arange(view)[None, :] <= pos[:, None])[None, None]
    want = _jax_sdpa(qj, kj, vj, mask)
    got = TL._sdpa(qt, kt, vt, CFG, q_offset=torch.tensor([start]),
                   kv_len=torch.tensor([view]))
    _close(got[:, :width], want[:, :width], "float32")


def test_attention_matches_sdpa_under_paged_decode_mask(rng):
    """paged.py's decode mask: kv_pos <= lengths[s], per slot."""
    slots, view = 4, 48
    lengths = np.asarray([0, 5, 17, 47], np.int32)
    qj, qt = _pair(rng.standard_normal((slots, 1, 4, 32)), "float32")
    kj, kt = _pair(rng.standard_normal((slots, view, 2, 32)), "float32")
    vj, vt = _pair(rng.standard_normal((slots, view, 2, 32)), "float32")
    ln = jnp.asarray(lengths)
    mask = (jnp.arange(view)[None, :] <= ln[:, None])[:, None, None]
    want = _jax_sdpa(qj, kj, vj, mask)
    got = TL._sdpa(qt, kt, vt, CFG, q_offset=torch.from_numpy(lengths),
                   kv_len=torch.full((slots,), view))
    _close(got, want, "float32")


# -- dispatch -------------------------------------------------------------------


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rms_ops.fused_rmsnorm(x, torch.empty(64, device="meta"))
    q = torch.empty((1, 2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa_ops.flash_attention(q, q, q)


def test_proxy_attention_is_not_ported():
    """The dry run's zero-traffic attention stub, ported with the int8 KV
    cache (the test keeps its name): JAX ``_sdpa``'s output, q / sqrt(hd),
    without a call of the flash op (which refuses the meta tensors)."""
    cfg = dataclasses.replace(CFG, attn_impl="proxy")
    q = np.random.default_rng(0).standard_normal((1, 2, 4, 32)
                                                 ).astype(np.float32)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), None, cfg)
    got = TL._sdpa(torch.from_numpy(q), torch.from_numpy(q),
                   torch.from_numpy(q), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    meta = torch.empty((1, 2, 4, 32), device="meta")
    assert TL._sdpa(meta, meta, meta, cfg).shape == meta.shape


def test_build_names_sources_and_needs_nvcc(monkeypatch, tmp_path):
    p1 = _build.library_path("rmsnorm")
    assert p1.name.startswith("librmsnorm-") and p1.suffix == ".so"
    assert p1 != _build.library_path("flash_attention")
    assert p1.parent == _build.BUILD_DIR
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
