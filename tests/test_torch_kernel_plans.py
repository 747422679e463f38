"""The flash-attention kernel's launch plan, its split-KV combine and its
cost, and the backward kernels' plan, on the CPU.

The plan (keys or rows mode, row tiles, splits, scratch) is a pure function
of shapes and the SM count, so it is pinned here.  The combine kernel's
plain version, ``combine_ref``, merges per-split partials computed by
``attention_partial_ref`` over the keys each split reads; the merge must give
``attention_ref``.  The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, attention_partial_ref, attention_ref, combine_ref,
)

torch.set_num_threads(2)

H100_SMS = 132


# -- launch plan ----------------------------------------------------------------


def test_plan_of_serve_decode():
    """llama3.2-1b decode, 8 slots over a 2048-key view: 4 packed rows per
    (batch, KV head), keys mode, 64 blocks split 8 ways (512 blocks, one
    wave of four resident blocks on each of 132 SMs)."""
    p = fa_ops.launch_plan(8, 1, 2048, 32, 8, 64, H100_SMS)
    assert (p.split_keys, p.row_tiles) == (True, 1)
    assert p.splits == 8
    assert p.scratch == (8, 8 * 1 * 32, 64 + 2)


def test_plan_of_serve_prefill_chunk():
    """A 256-token chunk: 1024 packed rows = 16 row tiles of 64 per KV head,
    128 blocks; a second copy of the grid does not fit in one wave of 132
    SMs, so one split and no combine."""
    p = fa_ops.launch_plan(1, 256, 2048, 32, 8, 64, H100_SMS)
    assert (p.split_keys, p.row_tiles) == (False, 16)
    assert p.splits == 1 and p.scratch is None


def test_plan_of_a_short_prefill_splits_rows_mode():
    """16 blocks of rows mode: eight copies fit in one wave of 132 SMs."""
    p = fa_ops.launch_plan(1, 32, 2048, 32, 8, 64, H100_SMS)
    assert (p.split_keys, p.row_tiles) == (False, 2)
    assert p.splits == 8 and p.scratch == (8, 32 * 32, 66)


def test_plan_keys_mode_splits_follow_shared_memory():
    """At D = 128 a keys-mode block takes 104 KB, so two share an SM."""
    assert fa_ops.smem_bytes(128) == 2 * 3 * 64 * 136 * 2
    p = fa_ops.launch_plan(4, 1, 4096, 16, 4, 128, H100_SMS)
    assert p.split_keys and p.splits == 2 * H100_SMS // 16


@pytest.mark.parametrize("b,sq,h,kh,per_sm", [
    (4, 256, 32, 8, 1), (1, 2048, 32, 8, 1),    # rows mode: a block an SM
    (264, 1, 32, 2, 4),                          # keys mode: four an SM
])
def test_plan_that_fills_the_sms_has_one_split_and_no_scratch(b, sq, h, kh,
                                                             per_sm):
    p = fa_ops.launch_plan(b, sq, 2048, h, kh, 64, H100_SMS)
    assert b * kh * p.row_tiles >= per_sm * H100_SMS
    assert p.splits == 1 and p.scratch is None


@pytest.mark.parametrize("sq,h,kh,keys_mode,row_tiles", [
    (4, 32, 8, True, 1),      # 16 packed rows: keys mode
    (5, 32, 8, False, 1),     # 20: rows mode, one tile of 64
    (16, 4, 4, True, 1),      # MHA: 16 query rows
    (17, 4, 4, False, 1),
    (1, 32, 1, False, 1),     # MQA decode: a group of 32 rows
    (65, 8, 8, False, 2),     # MHA prefill: 65 rows, two tiles
])
def test_plan_modes_and_row_tiles(sq, h, kh, keys_mode, row_tiles):
    p = fa_ops.launch_plan(1, sq, 512, h, kh, 64, H100_SMS)
    assert p.split_keys is keys_mode and p.row_tiles == row_tiles


def test_plan_splits_stop_at_one_per_key_tile_and_follow_the_sm_count():
    # 8 blocks of one row would take 66 splits; 100 keys are two tiles
    assert fa_ops.launch_plan(1, 1, 100, 8, 8, 64, H100_SMS).splits == 2
    assert fa_ops.launch_plan(1, 1, 64, 8, 8, 64, H100_SMS).splits == 1
    # the same shape on a card with fewer SMs needs fewer splits
    assert fa_ops.launch_plan(8, 1, 2048, 32, 8, 64, 16).splits == 1
    assert fa_ops.launch_plan(8, 1, 2048, 32, 8, 64, 66).splits == 4
    # the cap
    p = fa_ops.launch_plan(1, 1, 1 << 16, 8, 8, 64, H100_SMS)
    assert p.splits == fa_ops.MAX_SPLITS


def _key_splits(splits: int, skv: int) -> torch.Tensor:
    """(Skv,): the split that reads each key, as ``LaunchPlan`` states it
    (split s takes the key tiles s, s + splits, ...)."""
    return (torch.arange(skv) // fa_ops.BLOCK_N) % splits


def test_key_splits_deal_tiles_round_robin():
    ks = _key_splits(3, 400)
    assert ks[63] == 0 and ks[64] == 1 and ks[191] == 2 and ks[192] == 0
    assert ks[399] == (399 // 64) % 3
    assert torch.equal(_key_splits(1, 400), torch.zeros(400, dtype=ks.dtype))


@pytest.mark.parametrize("d", fa_ops.HEAD_DIMS)
def test_smem_of_a_block_fits_the_sm(d):
    """Three stages of K and V tiles, rows padded by 16 bytes."""
    assert fa_ops.smem_bytes(d) == 2 * 3 * 64 * (d + 8) * 2
    assert fa_ops.smem_bytes(d) <= fa_ops.SM_SMEM


# -- the backward kernels' plan ----------------------------------------------------

# registers a thread holds through the backward's loops (accumulators and
# the dq kernel's Q and dO fragments), well under the 255 a thread may use:
# the rest are addresses, masks and the products' operands in flight
BWD_HELD_REGS = 160


def test_backward_plan_of_the_seamless_train_call():
    """q (4, 2048, 16, 64), MHA: 2048 packed rows a (batch, head), 32 row
    blocks of dq and 32 key blocks of dK/dV over 64 (batch, head) pairs;
    LSE and D in 1 MB of fp32 scratch."""
    p = fa_ops.backward_plan(4, 2048, 2048, 16, 16, 64)
    assert p.rows_pad == 2048 and p.tile == 64
    assert p.dq_grid == (32, 64) and p.dkdv_grid == (32, 64)
    assert p.scratch == (2, 64 * 2048)
    assert 4 * p.scratch[0] * p.scratch[1] == 1 << 20


@pytest.mark.parametrize("sq,h,kh,rows_pad", [
    (2048, 32, 8, 8192),      # llama3.2-1b: a group of 4
    (2048, 64, 4, 32768),     # qwen3-moe EP: a group of 16
    (5, 32, 2, 128),          # 80 packed rows: two blocks, padded
    (1, 4, 4, 64),
])
def test_backward_plan_pads_the_packed_rows_to_the_dq_block(sq, h, kh,
                                                            rows_pad):
    p = fa_ops.backward_plan(2, sq, 300, h, kh, 64)
    assert p.rows_pad == rows_pad and rows_pad % fa_ops.BWD_BLOCK_M == 0
    assert rows_pad - fa_ops.BWD_BLOCK_M < sq * h // kh <= rows_pad
    assert p.dq_grid == (rows_pad // fa_ops.BWD_BLOCK_M, 2 * kh)
    assert p.dkdv_grid == (5, 2 * kh)          # 300 keys: 5 blocks of 64
    assert p.scratch == (2, 2 * kh * rows_pad)


@pytest.mark.parametrize("d,tile", [(32, 64), (64, 64), (128, 32)])
def test_backward_tiles_fit_shared_memory_and_registers(d, tile):
    """The dq kernel's key tiles and the dK/dV kernel's row tiles halve at
    D = 128, where dK and dV take 64 registers each: tile + D registers a
    thread stay within the budget; both kernels' rings fit the SM, and each
    tile is a whole number of 16-byte chunks for every thread."""
    p = fa_ops.backward_plan(4, 2048, 2048, 16, 16, d)
    assert p.tile == fa_ops.bwd_tile(d) == tile
    assert p.held_regs == tile + d <= BWD_HELD_REGS
    stride = (d + 8) * 2
    assert p.dq_smem == fa_ops.BWD_STAGES * 2 * tile * stride
    assert p.dkdv_smem == (2 * fa_ops.BWD_KEYS * stride + fa_ops.BWD_STAGES
                           * (2 * tile * stride + 2 * tile * 4))
    assert max(p.dq_smem, p.dkdv_smem) <= fa_ops.SM_SMEM
    for rows in (tile, fa_ops.BWD_KEYS):
        assert rows * d // 8 % fa_ops.BWD_THREADS == 0
    assert tile // 2 <= fa_ops.BWD_THREADS     # LSE and D: a chunk a thread
    assert fa_ops.BWD_BLOCK_M % tile == 0      # row tiles end in the padding


# -- split-KV partials and their combine ------------------------------------------


def _inputs(rng, b, sq, skv, h, kh, d):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return t(b, sq, h, d), t(b, skv, kh, d), t(b, skv, kh, d)


def _split_then_combine(q, k, v, splits, **kw):
    owner = _key_splits(splits, k.shape[1])
    parts = [attention_partial_ref(q, k, v, owner == s, **kw)
             for s in range(splits)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    return combine_ref(m, l, acc), (m, l)


@pytest.mark.parametrize("splits,causal,q_offset,kv_len", [
    # kv_len 128 ends exactly at the end of split 1's first tile; split 2's
    # tiles all lie past it (an empty split)
    (3, True, [200, 100], [128, 320]),
    # a row with kv_len 0 sees no key in any split; another ends on a tile
    (4, True, [0, 250], [0, 192]),
    # more splits than tiles: splits 5..7 read nothing
    (8, False, None, [320, 1]),
    # causal edges inside tiles, one split
    (1, True, [63, 64], None),
    # two splits
    (2, True, [100, 30], [300, 130]),
])
def test_partials_over_splits_combine_to_attention(rng, splits, causal,
                                                   q_offset, kv_len):
    q, k, v = _inputs(rng, 2, 5, 320, 8, 2, 16)
    kw = dict(causal=causal,
              q_offset=None if q_offset is None else torch.tensor(q_offset),
              kv_len=None if kv_len is None else torch.tensor(kv_len))
    got, (m, l) = _split_then_combine(q, k, v, splits, **kw)
    want = attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    # neutral partials: no visible key in the split -> m = NEG_INF, l = 0
    assert torch.equal(m[l == 0], torch.full_like(m[l == 0], NEG_INF))


def test_rows_with_no_visible_key_combine_to_zero(rng):
    q, k, v = _inputs(rng, 2, 3, 200, 4, 2, 16)
    kw = dict(causal=True, q_offset=torch.tensor([0, 5]),
              kv_len=torch.tensor([0, 200]))
    got, (_, l) = _split_then_combine(q, k, v, 4, **kw)
    assert torch.count_nonzero(got[0]) == 0 and bool((l[:, 0] == 0).all())
    assert torch.isfinite(got).all() and torch.count_nonzero(got[1]) > 0


def test_combine_ref_weighs_partials_by_log_sum_exp():
    """Two splits of one row by hand: scores (1, 3) and (2,), values 1, 2, 3."""
    s = torch.tensor([1.0, 3.0, 2.0])
    vals = torch.tensor([1.0, 2.0, 3.0])
    m = torch.tensor([3.0, 2.0]).view(2, 1, 1, 1)
    l = torch.tensor([np.exp(-2.0) + 1.0, 1.0]).view(2, 1, 1, 1).float()
    acc = torch.tensor([np.exp(-2.0) * 1 + 2.0, 3.0]).view(2, 1, 1, 1, 1)
    want = (torch.softmax(s, 0) * vals).sum()
    got = combine_ref(m, l, acc.float())
    assert abs(float(got) - float(want)) < 1e-6


# -- cost -----------------------------------------------------------------------


def test_cost_by_hand():
    """Row 0: queries at 2, 3, 4 under kv_len 10 see 3 + 4 + 5 keys and read
    keys 0..4; row 1: queries at 8, 9, 10 under kv_len 5 see 5 each and read
    keys 0..4.  bf16: K and V 10 keys x 2 heads x 8 x 2 bytes each, q and
    the output 24 rows x 8 x 2 bytes each, two int32 masks of 2 rows."""
    q = torch.zeros(2, 3, 4, 8, dtype=torch.bfloat16)
    k = torch.zeros(2, 10, 2, 8, dtype=torch.bfloat16)
    ops, nbytes = fa_ops.cost(q, k, k, True, torch.tensor([2, 8]),
                              torch.tensor([10, 5]))
    assert ops == 4 * 4 * 8 * (3 + 4 + 5 + 5 * 3)
    assert nbytes == 2 * 10 * 2 * 8 * 2 + 2 * (2 * 3 * 4 * 8) * 2 + 2 * 2 * 4


def test_cost_non_causal_and_without_masks():
    q = torch.zeros(1, 4, 2, 32)
    k = torch.zeros(1, 7, 1, 32)
    ops, nbytes = fa_ops.cost(q, k, k, False)
    assert ops == 4 * 2 * 32 * 4 * 7
    assert nbytes == 2 * 7 * 32 * 4 + 2 * 4 * 2 * 32 * 4


@pytest.mark.parametrize("b,sq,offs", [
    (8, 1, [144, 300, 520, 700, 1056, 90, 400, 611]),   # serve decode
    (1, 256, [768]),                                    # serve prefill chunk
])
def test_cost_matches_the_serve_bound_formula(b, sq, offs):
    """The formula chip_smoke.py used before the cost existed, at the serve
    path's shapes (view 2048, llama3.2-1b heads, bf16)."""
    view, h, kh, hd = 2048, 32, 8, 64
    q = torch.zeros(b, sq, h, hd, dtype=torch.bfloat16)
    k = torch.zeros(b, view, kh, hd, dtype=torch.bfloat16)
    qo = torch.tensor(offs, dtype=torch.int32)
    ops, nbytes = fa_ops.cost(q, k, k, True, qo, torch.full_like(qo, view))
    keys = sum(min(view, o + i + 1) for o in offs for i in range(sq))
    keys_read = sum(min(view, o + sq) for o in offs)
    assert ops == 4 * h * hd * keys
    assert nbytes == (2 * keys_read * kh * hd * 2 + 2 * b * sq * h * hd * 2
                      + 2 * b * 4)
