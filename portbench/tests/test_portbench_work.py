"""The benchmark's own FLOP and byte counts against counts by hand, the
traffic generator's fixed work, and the trace reduction's intervals."""
import pytest

from portbench.lib import devtrace, peaks, traffic, work

M = dict(d_model=8, heads=2, kv_heads=1, head_dim=4, d_ff=16, vocab=10,
         layers=1, encoder_layers=1, frontend_dim=6, experts=4, top_k=2,
         d_ff_expert=3)


def test_flash_least_by_hand():
    # 2 rows of 3 causal queries: keys seen 1 + 2 + 3 = 6 a row
    f, b = work.flash_least(M, 3, 6, 3, rows=2)
    assert f == 2 * 4 * 2 * 4 * 6          # rows * 4 * H * hd * keys
    # bf16: q and out (3 x 2 x 4 each), k and v (3 x 1 x 4 each), a row
    assert b == 2 * 2 * (2 * 3 * 8 + 2 * 3 * 4)


def test_decode_and_prefill_calls_by_hand():
    (f, b), = work.flash_decode_calls(M, [0, 2])
    assert f == 4 * 2 * 4 * (1 + 3)
    assert b == 2 * (2 * 8 + 2 * 4 * 1) + 2 * (2 * 8 + 2 * 4 * 3)
    (f, b), = work.flash_prefill_calls(M, start=5, width=2)
    assert f == 4 * 2 * 4 * (6 + 7)
    assert b == 2 * (2 * 2 * 8 + 2 * 4 * 7)


def test_moe_token_flops_by_hand():
    proj = 2 * 8 * (2 * 8 + 2 * 4)
    attn = 4 * 2 * 4 * 5
    router = 2 * 8 * 4
    experts = 2 * 2 * 3 * 8 * 3
    head = 2 * 8 * 10
    assert work.moe_token_flops(M, 5) == proj + attn + router + experts + head
    assert work.moe_decode_flops(M, [4, 4]) == 2 * work.moe_token_flops(M, 5)
    # a chunk: its tokens' bodies, attention over 3 + 4, one token's head
    body = 2 * (proj + router + experts)
    assert work.moe_prefill_flops(M, 2, 2) == body + 4 * 2 * 4 * 7 + head


def test_encdec_train_flops_by_hand():
    src = tgt = 2
    proj = 2 * 8 * (2 * 8 + 2 * 4)
    mlp = 2 * 3 * 8 * 16
    enc = src * (proj + mlp) + src * 4 * 2 * 4 * src
    dec = (tgt * (proj + 2 * 8 * 2 * 8 + mlp) + src * 2 * 8 * 2 * 4
           + 4 * 2 * 4 * 3 + tgt * 4 * 2 * 4 * src)
    fwd = src * 2 * 6 * 8 + enc + dec + tgt * 2 * 8 * 10
    assert work.encdec_train_flops(M, 3, src, tgt) == 3 * 3 * fwd


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_every_seed_serves_the_same_work():
    spec = {"arrivals": {"process": "poisson", "rate": 5.0},
            "prompt_len": {"dist": "loguniform", "low": 64, "high": 1024},
            "output_len": {"dist": "uniform", "low": 64, "high": 256},
            "sizes_seed": 3}
    a = traffic.make_requests(spec, 1, 20.0)
    b = traffic.make_requests(spec, 2**31 + 5, 20.0)
    assert len(a) == len(b) == 100
    assert sorted(r.prompt_len for r in a) == sorted(r.prompt_len for r in b)
    assert sorted(r.max_new_tokens for r in a) == \
        sorted(r.max_new_tokens for r in b)
    assert [r.prompt_len for r in a] != [r.prompt_len for r in b]
    gaps = lambda t: sorted(round(y.arrival_s - x.arrival_s, 9)  # noqa
                            for x, y in zip(t, t[1:]))
    assert gaps(a) == pytest.approx(gaps(b))
    assert max(r.arrival_s for r in a) < 20.0
    assert all(64 <= r.prompt_len <= 1024 for r in a)
    assert (traffic.prompt_tokens(a[0], 100) ==
            traffic.prompt_tokens(a[0], 100)).all()


def test_order_block_keeps_each_blocks_load():
    spec = {"arrivals": {"process": "poisson", "rate": 8.8},
            "prompt_len": {"dist": "loguniform", "low": 64, "high": 1024},
            "output_len": {"dist": "uniform", "low": 64, "high": 256},
            "sizes_seed": 3, "order_block": 8}
    a = traffic.make_requests(spec, 5, 51.0)
    b = traffic.make_requests(spec, 6, 51.0)
    assert len(a) == 449
    for lo in range(0, 449, 8):
        assert sorted(r.prompt_len for r in a[lo:lo + 8]) == \
            sorted(r.prompt_len for r in b[lo:lo + 8])
    # the due time of every eighth request is the same: a block's gaps
    # are the same, in another order
    assert a[8].arrival_s == pytest.approx(b[8].arrival_s)
    assert a[16].arrival_s == pytest.approx(b[16].arrival_s)
    assert [r.prompt_len for r in a] != [r.prompt_len for r in b]


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert devtrace.union_us(iv) == 4.0
    assert devtrace.gaps_us(iv, 0.0, 7.0) == [(3.0, 5.0), (6.0, 7.0)]
    t = devtrace.DeviceTrace(
        ops=[("k1", 0.0, 2.0), ("k2", 5.0, 6.0), ("Memcpy HtoD", 6.0, 6.5)],
        ranges=[("portbench.decode", 4.5, 6.2)],
        host=[("outer", 0.0, 7.0, 1), ("inner", 2.5, 4.0, 1)],
        start_us=0.0, end_us=7.0)
    assert [o[0] for o in t.within("portbench.decode")] == ["k2"]
    assert [k[0] for k in t.kernels()] == ["k1", "k2"]
    assert t.busy_s() == pytest.approx(3.5e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["host: inner"] == pytest.approx(3e-6)
    assert devtrace.kind_of("void flash_mma_kernel<64, true>") == \
        "flash_attention kernel"
    assert devtrace.kind_of("nvjet_hsh_128x256") == "gemm bf16"
