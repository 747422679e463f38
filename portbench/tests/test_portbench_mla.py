"""The latent-attention serve cell's pieces on the CPU: the configuration as
the program runs it, the kind on a toy Kimi-K2, the frozen work count
against the kernel's, and the four readers the cell adds (``mla_ms.*``,
``mla_roofline.*``) without a trace."""
import copy

from portbench.kinds import serve_mla
from portbench.kinds.common import Run, arch_config
from portbench.lib import discover, mla_work
from portbench.tests.tiny import CPU

CELL = "kimik2-serve-longctx"
READERS = ("mla_ms.decode", "mla_ms.prefill", "mla_roofline.decode",
           "mla_roofline.prefill")


def test_configuration_reads_back_at_published_widths():
    """Every mapped key reads back from the program's config; 16.10 B
    parameters; the cuts are the two ``reduced`` keys."""
    c = discover.config("kimi-k2-instruct-12l-ep16")
    cfg = arch_config(c)
    assert c["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert c["published"] == {"num_hidden_layers": 61,
                              "n_routed_experts": 384}
    assert cfg.is_mla and cfg.moe.num_experts == 384
    assert cfg.moe.held_experts == 24 and cfg.moe.top_k == 8
    assert round(cfg.num_params() / 1e7) == 1610
    assert cfg.moe.capacity_factor == cfg.moe.num_experts / cfg.moe.top_k


def toy(rate: float = 2.0):
    w = discover.workload(CELL)
    c = copy.deepcopy(discover.config(w["config"]))
    c.update(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             num_key_value_heads=4, intermediate_size=96, vocab_size=256,
             q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=24, n_routed_experts=4,
             num_experts_per_tok=4, moe_intermediate_size=32,
             torch_dtype="float32")
    c["program"]["set"].update({"compute_dtype": "float32",
                                "moe.num_experts": 16, "moe.d_ff_shared": 32,
                                "moe.capacity_factor": 4.0,
                                "yarn_original_max": 64})
    c["serve"] = {"slots": 4, "max_len": 160, "block_size": 8, "chunk": 32}
    w["traffic"].update(
        arrivals={"process": "poisson", "rate": rate},
        prompt_len={"dist": "loguniform", "low": 16, "high": 128},
        output_len={"dist": "uniform", "low": 4, "high": 16})
    w["check_tokens"] = 20
    return w, c


def test_kind_serves_the_toy_and_checks_it():
    """The open loop on the CPU: every request served, the check's gap 0
    in fp32 (program and reference differ by rounding alone), the held
    share of routed choices near 4/16."""
    from portbench.run import Context

    w, c = toy()
    run = serve_mla.run(Context(CELL, w, c, 2 ** 33 + 5, 3.0, False, CPU))
    assert run.failed == 0 and run.checks[0].ok
    assert run.checks[0].value < 1e-4
    assert 0.1 < run.log["held_share"] < 0.45
    assert run.log["mla_launches"] == 0       # the plain version on the CPU
    assert set(run.e2e) == {"tpot_p95_ms", "peak_mem_gb", "setup_s"}


def test_frozen_work_equals_the_kernels():
    from repro_torch.kernels.mla_attention import ops

    keys, lanes = [5, 900, 33000], [5, 900, 33000]
    assert mla_work.work(keys, lanes, 64) == ops.work(keys, lanes, 64)
    assert mla_work.KERNELS == ops.KERNELS
    d = {"heads": 64, "kv_rank": 512, "rope_dim": 64, "nope_dim": 128,
         "v_dim": 128}
    (ops_, nbytes), _ = mla_work.decode(d, [9, None, 0])
    assert ops_ == 2 * (10 + 1) * 64 * 1088
    assert nbytes == ((10 + 1) * 576 + 2 * 64 * 1088) * 2
    (ops_, nbytes), _ = mla_work.prefill(d, 100, 3)
    assert ops_ == 2 * (101 + 102 + 103) * 64 * 1088
    assert nbytes == (103 * 576 + 3 * 64 * 1088) * 2


def test_expanded_form_is_the_chunks_least_work_and_not_decodes():
    """The expanded form: kv_b over each lane's rows, then 192-wide scores
    and 128-wide outputs.  A 2,048-token chunk at positions 14,336-16,383
    does 2.8x fewer operations in it (1.56 against 4.38 TFLOP); a decode
    call's expansion of the whole prefix makes it the dearer form."""
    from portbench.lib import peaks

    d = {"heads": 64, "kv_rank": 512, "rope_dim": 64, "nope_dim": 128,
         "v_dim": 128}
    _, (ops_, nbytes) = mla_work.prefill(d, 100, 3)
    assert ops_ == (2 * (101 + 102 + 103) * 64 * 320
                    + 2 * 103 * 512 * 64 * 256)
    assert nbytes == (103 * 576 + 512 * 64 * 256 + 3 * 64 * 320) * 2
    absorbed, exp = mla_work.prefill(d, 14336, 2048)
    assert round(absorbed[0] / 1e10) == 438 and round(exp[0] / 1e10) == 156
    assert (peaks.least_seconds(*exp)
            < peaks.least_seconds(*absorbed) / 2.5)
    absorbed, exp = mla_work.decode(d, [16383] * 32)
    assert peaks.least_seconds(*absorbed) < peaks.least_seconds(*exp) / 10


def test_readers_read_nothing_without_a_trace():
    run = Run(kind="serve", dims={"heads": 64, "kv_rank": 512,
                                  "rope_dim": 64, "nope_dim": 128,
                                  "v_dim": 128, "mla_layers": 12},
              workload={}, extra={"steps": []})
    for name in READERS:
        assert discover.reader(name)(run) is None


def test_mla_ms_reads_device_ranges_within_each_call():
    """``mla_ms.*`` read on the device's clock alone: the kernels inside
    the ``mla.attn`` device ranges within each profiled call's harness
    range, whatever the host events' times (here the device ranges start
    before their host events, as a skewed profiler clock gives)."""
    from portbench.lib import devtrace

    ops = [("mla_attn_kernel", 115, 140), ("gemm", 150, 190),
           ("mla_attn_kernel", 265, 320), ("mla_attn_kernel", 415, 445),
           ("gemm", 460, 470)]
    ranges = [("portbench.decode", 100, 200), ("portbench.prefill", 250, 380),
              ("portbench.decode", 400, 500), ("mla.attn", 110, 150),
              ("mla.attn", 260, 330), ("mla.attn", 410, 450)]
    host = [("mla.attn", 120, 125, 1), ("mla.attn", 270, 275, 1),
            ("mla.attn", 420, 425, 1)]
    steps = [{"profiled": True, "prefill": None, "decode": [0]},
             {"profiled": True, "prefill": (0, 0, 0, 8, 0), "decode": []},
             {"profiled": True, "prefill": None, "decode": [0]}]
    run = Run(kind="serve", dims={}, workload={}, extra={"steps": steps})
    run.trace = devtrace.DeviceTrace(ops=ops, ranges=ranges, host=host)
    assert discover.reader("mla_ms.decode")(run) == 1e-3 * (25 + 30) / 2
    assert discover.reader("mla_ms.prefill")(run) == 1e-3 * 55
    run.trace = devtrace.DeviceTrace(
        ops=ops, ranges=[r for r in ranges if r[0] != "mla.attn"], host=host)
    assert discover.reader("mla_ms.decode")(run) is None
