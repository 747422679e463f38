"""The SSD-scan kernels' plan and their plain versions, on the CPU.

In bf16 the CUDA op runs three kernels (``csrc/ssd_scan.cu``): chunk states,
state passing, chunk outputs.  Their plain versions (``ref.chunk_state_ref``,
``state_pass_ref``, ``chunk_out_ref``) composed must give the scan: the
port's oracle ``ssd_scan_ref`` in fp64 and the JAX package's Pallas kernel
(interpret mode, as its own tests run it) in fp32, with B and C broadcast
over the heads and per head.  The ``bf16`` option rounds the operands the
kernels feed the tensor cores where they round them; at the train path's
per-head geometry that shows, before any card time, that the kernels' bf16
high and low parts hold the 5e-2 check and one rounding does not.  The
launch plan (grids, scratch, shared memory) is a pure function of shapes
and is pinned here; the kernels themselves run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ssd_scan as jax_ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    chunk_out_ref, chunk_state_ref, split_bf16, ssd_scan_ref, state_pass_ref,
)

torch.set_num_threads(2)

BF16_TOL = 5e-2      # tests/test_kernels.py: the SSD bf16 tolerance
FP32_TOL = 2e-4      # ... and fp32


def _inputs(seed, b, s, h, p, n, bcast=False, dtype=np.float32):
    """x, B, C normal, dt uniform in [0.01, 1), A = -exp(normal), as the JAX
    kernel tests draw them; B and C stride-0 over the heads where
    ``bcast``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    gh = 1 if bcast else h
    B = rng.standard_normal((b, s, gh, n))
    C = rng.standard_normal((b, s, gh, n))
    dt = rng.uniform(0.01, 1.0, (b, s, h))
    A = -np.exp(rng.standard_normal(h))
    t = [torch.tensor(a.astype(dtype)) for a in (x, B, C, dt, A)]
    if bcast:
        t[1], t[2] = (u.expand(b, s, h, n) for u in t[1:3])
    return t


def round_bf16(t):
    """One rounding to bf16, in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _composed(x, B, C, dt, A, chunk, bf16=False):
    cum, states, decay = chunk_state_ref(x, B, dt, A, chunk, bf16=bf16)
    st_in, final = state_pass_ref(states, decay)
    return chunk_out_ref(x, B, C, dt, cum, st_in, chunk, bf16=bf16), final


# tests/test_torch_ssd.py's sweep, and the train shape's geometry cut to a
# few heads, broadcast and per head
CASES = [
    (1, 128, 2, 32, 32, 32, False),
    (2, 256, 4, 32, 64, 64, False),
    (1, 192, 1, 64, 128, 64, False),
    (2, 64, 8, 16, 16, 16, False),
    (1, 512, 3, 64, 128, 256, True),
    (1, 512, 3, 64, 128, 128, False),
]


@pytest.mark.parametrize("case", CASES)
def test_kernels_composed_equal_the_scan_in_fp64(case):
    b, s, h, p, n, chunk, bcast = case
    ins = [t.double() for t in _inputs(1, b, s, h, p, n, bcast)]
    y, final = _composed(*ins, chunk)
    yr, fr = ssd_scan_ref(*ins, chunk)
    assert y.dtype == torch.float64
    torch.testing.assert_close(y, yr, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(final, fr, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_kernels_composed_match_the_jax_kernel_in_fp32(case):
    b, s, h, p, n, chunk, bcast = case
    ins = _inputs(2, b, s, h, p, n, bcast)
    y, final = _composed(*ins, chunk)
    jy, jst = jax_ssd_scan(*(jnp.asarray(t.contiguous().numpy())
                             for t in ins), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=FP32_TOL,
                               atol=FP32_TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jst), rtol=FP32_TOL,
                               atol=FP32_TOL)


@pytest.mark.parametrize("bcast", [True, False])
def test_kernels_composed_equal_the_scan_with_dt_of_either_sign(bcast):
    """The op takes any fp32 dt: kernel 3 multiplies the scores by dt and
    kernel 1 the tokens' weights, so a negative dt flows through as in the
    scan (the model's softplus keeps its dt >= 0)."""
    ins = [t.double() for t in _inputs(6, 2, 256, 3, 16, 32, bcast)]
    ins[3] = ins[3] - 0.3                       # dt in [-0.29, 0.7)
    assert float(ins[3].min()) < 0
    y, final = _composed(*ins, 64)
    yr, fr = ssd_scan_ref(*ins, 64)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    torch.testing.assert_close(y, yr, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(final, fr, rtol=1e-12, atol=1e-12)


def test_a_single_chunk_enters_with_a_zero_state():
    ins = _inputs(3, 2, 64, 3, 16, 16)
    cum, states, decay = chunk_state_ref(ins[0], ins[1], ins[3], ins[4], 64)
    st_in, final = state_pass_ref(states, decay)
    assert st_in.shape == (2, 1, 3, 16, 16)
    assert torch.count_nonzero(st_in) == 0
    torch.testing.assert_close(final, states[:, 0], rtol=0, atol=0)
    # and kernel 3 then adds nothing for the entering state
    y = chunk_out_ref(ins[0], ins[1], ins[2], ins[3], cum, st_in, 64)
    torch.testing.assert_close(y, ssd_scan_ref(*ins, 64)[0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("real", [513, 520])
def test_dt_zero_on_a_padded_tail_keeps_the_unpadded_state(real):
    """The SSM prefill pads a prompt to a chunk multiple with dt = 0 (here
    513 or 520 tokens to 768 at chunk 256): the final state and the real
    rows of y are those of the unpadded sequence."""
    b, h, p, n, chunk = 1, 2, 16, 32, 256
    ins = [t.double() for t in _inputs(4, b, real, h, p, n)]
    pad = 768 - real
    padded = [torch.cat([t, torch.zeros((b, pad) + t.shape[2:],
                                        dtype=t.dtype)], dim=1)
              if i < 4 else t for i, t in enumerate(ins)]
    y, final = _composed(*padded, chunk)
    # the unpadded sequence as one chunk of its own length
    yr, fr = ssd_scan_ref(*ins, real)
    torch.testing.assert_close(final, fr, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(y[:, :real], yr, rtol=1e-12, atol=1e-12)


def _train_geometry(seed, heads=4):
    """One sequence at the train path's per-head shape (seq 2048, chunk
    256, head_dim 64, d_state 128, B and C broadcast), a few heads, bf16
    inputs held in fp64; one head decays slowly (A = -0.02), where y sums
    the most terms."""
    b, s, p, n = 1, 2048, 64, 128
    ins = _inputs(seed, b, s, heads, p, n, bcast=True)
    ins[4][0] = -0.02
    return [t.to(torch.bfloat16).double() if i < 3 else t.double()
            for i, t in enumerate(ins)]


def _worst_over_tolerance(got, want, tol=BF16_TOL):
    """max |got - want| / (tol + tol |want|): at most 1 passes allclose."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def test_bf16_hi_lo_operands_hold_the_check_at_the_train_geometry():
    ins = _train_geometry(5)
    yr, fr = ssd_scan_ref(*ins, 256)
    y, final = _composed(*ins, 256, bf16=True)
    assert _worst_over_tolerance(y, yr) < 0.05
    assert _worst_over_tolerance(final, fr) < 0.05


def test_bf16_scores_rounded_once_would_break_the_check():
    """Why kernel 3 feeds the scaled scores as high and low parts: rounded
    once to bf16 they miss the 5e-2 check at the train geometry."""
    ins = _train_geometry(5)
    x, B, C, dt, A = ins
    yr, _ = ssd_scan_ref(*ins, 256)
    cum, states, decay = chunk_state_ref(x, B, dt, A, 256, bf16=True)
    st_in, _ = state_pass_ref(states, decay)
    # chunk_out_ref with the scores rounded once, st_in as hi + lo
    b, s, h, p = x.shape
    q = 256
    r = [t.reshape((b, s // q, q) + tuple(t.shape[2:])) for t in (x, B, C, dt)]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))[None, None, :, :,
                                                            None]
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.exp(torch.where(causal, rel, torch.tensor(-torch.inf,
                                                        dtype=cum.dtype)))
    P = torch.einsum("bcqhn,bcthn->bcqth", r[2], r[1]) * L * r[3][:, :, None]
    y = (torch.einsum("bcqth,bcthp->bcqhp", round_bf16(P), r[0])
         + torch.exp(cum)[..., None] * torch.einsum(
             "bcqhn,bchnp->bcqhp", r[2], split_bf16(st_in)))
    assert _worst_over_tolerance(y.reshape(b, s, h, p), yr) > 1.0


def test_split_bf16_keeps_about_16_bits():
    t = torch.randn(10000, dtype=torch.float64) * 100
    assert float(((split_bf16(t) - t).abs() / t.abs()).max()) < 2 ** -15
    assert float(((round_bf16(t) - t).abs() / t.abs()).max()) > 2 ** -10


# -- the launch plan ------------------------------------------------------------


def test_plan_of_the_train_shape():
    """mamba2-2.7b, one microbatch: 2 x 2048 tokens, 80 heads of 64, d_state
    128, chunk 256."""
    plan = ssd_ops.launch_plan(2, 2048, 80, 64, 128, 256)
    assert (plan.chunks, plan.row_blocks) == (8, 2)
    assert plan.state_grid == (640, 2)            # 1,280 blocks
    assert plan.pass_grid == (8, 160)
    assert plan.out_grid == (1280, 2)             # 2,560 blocks of 4 warps
    assert (plan.smem_state, plan.smem_out) == (56320, 92192)
    assert plan.states == (2, 8, 80, 128, 64)     # 42 MB of fp32
    assert plan.st_in == (2, 8, 80, 2, 128, 64)   # 42 MB of bf16 pairs
    assert plan.cum == (2, 8, 80, 256) and plan.decay == (2, 8, 80)


@pytest.mark.parametrize("s", [512, 768])
def test_plan_of_the_ssm_prefills(s):
    """The ssm phase's prefills: 512 tokens (two chunks) and 513-520 tokens
    padded to 768 (three chunks)."""
    plan = ssd_ops.launch_plan(2, s, 80, 64, 128, 256)
    assert plan.chunks == s // 256 and plan.row_blocks == 2
    assert plan.out_grid == (s // 256 * 80 * 2, 2)
    assert plan.states == (2, s // 256, 80, 128, 64)


@pytest.mark.parametrize("b,s,h,p,n,chunk,row_blocks,smem", [
    # chip_smoke.py's SSD_CASES and tests/test_torch_cuda.py's cases
    (1, 512, 4, 64, 128, 128, 1, (54784, 91152)),
    (2, 1024, 8, 64, 128, 64, 1, (54016, 90632)),
    (1, 256, 8, 64, 128, 256, 2, (56320, 92192)),
    (1, 128, 2, 32, 32, 32, 1, (54016, 90632)),
    (1, 192, 1, 64, 128, 64, 1, (54016, 90632)),
    (2, 64, 8, 16, 16, 16, 1, (54016, 90632)),
    (1, 384, 2, 64, 128, 96, 1, (54784, 91152)),
    (1, 320, 3, 36, 44, 64, 1, (54016, 90632)),
])
def test_plan_of_the_check_shapes(b, s, h, p, n, chunk, row_blocks, smem):
    """A row block is 128 query rows; the state scratch is padded to 128 x
    64 whatever n and p are."""
    plan = ssd_ops.launch_plan(b, s, h, p, n, chunk)
    assert plan.row_blocks == row_blocks
    assert (plan.smem_state, plan.smem_out) == smem
    assert plan.out_grid == (s // chunk * h * row_blocks, b)
    assert plan.pass_grid == (8, b * h)
    assert plan.states == (b, s // chunk, h, 128, 64)


@pytest.mark.parametrize("chunk,row_blocks", [(16, 1), (64, 1), (128, 1),
                                              (256, 2), (257, 3), (1024, 8),
                                              (8192, 64)])
def test_every_block_fits_the_sm(chunk, row_blocks):
    plan = ssd_ops.launch_plan(1, chunk, 1, 64, 128, chunk)
    assert plan.row_blocks == row_blocks
    assert max(plan.smem_state, plan.smem_out) <= 232448


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.launch_plan(1, 16384, 1, 64, 128, 16384)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.launch_plan(1, 100, 1, 64, 128, 64)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_ops.launch_plan(1, 128, 1, 72, 128, 64)
    with pytest.raises(ValueError, match="d_state"):
        ssd_ops.launch_plan(1, 128, 1, 64, 136, 64)


def test_plan_of_every_chip_smoke_case():
    """chip_smoke.py's SSD_CASES: every block fits, a row block a 128 query
    rows, the grids cover (chunk, head, batch)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for label, (b, s, h, p, n, chunk, _, _) in chip_smoke.SSD_CASES.items():
        plan = ssd_ops.launch_plan(b, s, h, p, n, chunk)
        assert max(plan.smem_state, plan.smem_out) <= 232448, label
        assert plan.row_blocks == -(-chunk // 128), label
        assert plan.state_grid == (s // chunk * h, b), label
        assert plan.out_grid == (s // chunk * h * plan.row_blocks, b), label
        assert plan.cum == (b, s // chunk, h, chunk), label


def test_stage_runner_refuses_cpu_tensors():
    ins = _inputs(0, 1, 64, 2, 16, 16)
    with pytest.raises(ValueError, match="bf16 CUDA"):
        ssd_ops.run_stages(*ins, chunk=16)
