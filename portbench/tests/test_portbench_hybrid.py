"""The hybrid serve cell's pieces on the CPU: the kind on a toy hybrid, the
weight maker, the plain reference against the engine, the SSD work count
and the three readers the cell adds (``mamba_ms.decode``,
``mamba_ms.prefill``, ``ssd_roofline.prefill``) on a hand-built trace."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from portbench.kinds import serve_hybrid
from portbench.kinds.common import Run, arch_config
from portbench.lib import devtrace, discover, hybrid_weights, peaks, ssd_work
from portbench.reference import granite_hybrid
from portbench.reference.common import Precision
from portbench.tests.tiny import CPU, fp32

CELL = "granite4h-serve-128slots"


def toy_config() -> dict:
    """The cell's configuration with every width cut, one period of the
    layer pattern (attention at 5) and everything else as the file states
    it."""
    c = copy.deepcopy(discover.config("granite-4.0-h-small-20l"))
    c.update(hidden_size=64, num_hidden_layers=10, num_attention_heads=4,
             num_key_value_heads=2, num_local_experts=8,
             num_experts_per_tok=2,
             intermediate_size=32, shared_intermediate_size=48,
             mamba_d_state=16, mamba_d_head=16, mamba_chunk_size=16,
             vocab_size=256, attention_multiplier=1 / 16)
    c["program"]["set"].update({"head_dim": 16, "moe.capacity_factor": 4.0})
    c["serve"] = {"slots": 4, "max_len": 128, "block_size": 16, "chunk": 32}
    return c


def toy_cell() -> dict:
    w = discover.workload(CELL)
    w["traffic"].update(arrivals={"process": "poisson", "rate": 4.0},
                        prompt_len={"dist": "loguniform", "low": 8,
                                    "high": 64},
                        output_len={"dist": "uniform", "low": 4, "high": 16})
    w.update(drain_seconds=60, profile_seconds=1.0, check_tokens=40)
    return w


def context(seed: int, trace=False):
    from portbench.run import Context

    return Context(CELL, toy_cell(), fp32(toy_config()), seed, 1.5, trace,
                   CPU)


def test_toy_run_is_correct_and_resets_each_slot_it_admits():
    run = serve_hybrid.run(context(2**31 + 5))
    assert run.kind == "serve" and run.attempted > 0 and run.failed == 0
    assert [c.ok for c in run.checks] == [True]
    assert run.log["state_resets"] >= run.log["sampled"] > 0
    assert {"ssm_heads", "d_state", "chunk"} <= set(run.dims)


def test_file_pattern_must_be_the_ports():
    config = toy_config()
    cfg = arch_config(config)
    serve_hybrid.check_pattern(config, cfg)
    config["layer_types"] = ["mamba"] + config["layer_types"][:-1]
    with pytest.raises(ValueError, match="layer_types"):
        serve_hybrid.check_pattern(config, cfg)


def _layout():
    from repro_torch.models import build_model

    return build_model(arch_config(toy_config())).abstract_params()[0]


def test_weight_maker_draws_the_mamba_vectors_in_their_ranges():
    w = hybrid_weights.make_weights(_layout(), 77, CPU)
    mamba = w["blocks"]["mamba"]
    a = torch.exp(mamba["A_log"])
    dt = torch.nn.functional.softplus(mamba["dt_bias"])
    assert a.min() >= 1.0 and a.max() <= 16.0 and a.std() > 1.0
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
    assert torch.equal(mamba["D_skip"], torch.ones_like(mamba["D_skip"]))
    assert all(t.dtype == torch.float32 for t in
               (mamba["A_log"], mamba["dt_bias"], mamba["D_skip"]))
    again = hybrid_weights.make_weights(_layout(), 77, CPU)
    other = hybrid_weights.make_weights(_layout(), 78, CPU)
    flat = dict(hybrid_weights.weights.flatten(w))
    for path, t in hybrid_weights.weights.flatten(again):
        assert torch.equal(flat[path], t), path
    assert not torch.equal(other["blocks"]["mamba"]["A_log"],
                           mamba["A_log"])
    assert not torch.equal(other["embed"], w["embed"])


def test_reference_against_the_engine_prefill():
    """The paged forward's whole-prompt prefill (one chunk, the scratch
    lane) against the reference's last logits, in float32."""
    from repro_torch.models import build_model
    from repro_torch.models.build import compute_params
    from repro_torch.serve import paged
    from repro_torch.serve.policy import ServeConfig

    cfg = arch_config(fp32(toy_config()))
    w = hybrid_weights.make_weights(
        build_model(cfg).abstract_params()[0], 3, CPU)
    scfg = ServeConfig(slots=2, max_len=64, block_size=16, chunk=32)
    toks = torch.as_tensor(np.random.default_rng(3).integers(1, 256, 27))
    pool = paged.init_pool(cfg, scfg, CPU)
    row = torch.arange(1, scfg.max_blocks_per_slot + 1, dtype=torch.int32)
    got, _ = paged.prefill_chunk(compute_params(w, cfg), pool, toks[None],
                                 0, 27, row, 0, cfg, scfg)
    want = granite_hybrid.logits(w, toks, granite_hybrid.dims(cfg),
                                 Precision("fp32"))[-1]
    torch.testing.assert_close(got[0, 0], want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_ssd_work_is_the_ops_cost():
    from repro_torch.kernels.ssd_scan import ops

    b, s, h, p, n, q = 1, 256, 128, 64, 128, 256
    x = torch.empty((b, s, h, p), dtype=torch.bfloat16)
    bc = torch.empty((b, s, 1, n), dtype=torch.bfloat16).expand(b, s, h, n)
    dt = torch.empty((b, s, h))
    a = torch.empty((h,))
    assert ssd_work.cost(b, s, h, p, n, 1, q) == \
        ops.cost(x, bc, bc, dt, a, q, torch.float32)
    assert set(ssd_work.KERNELS) >= set(ops.KERNELS)
    from repro_torch.serve.policy import ServeConfig

    scfg = ServeConfig(slots=2, max_len=4096, block_size=16, chunk=256)
    for width in (1, 3, 100, 129, 256):
        assert ssd_work.padded_len(width, 256, 256) == 256
        assert ssd_work.padded_len(width, 256, 64) == \
            -(-scfg.bucket(width) // 64) * 64


# -- the readers on a hand-built trace (times in microseconds) ---------------
#
# step 1, decode only: host serve.decode [10, 60] holding two host
# mamba.mixer events; their device ranges [20, 30] (op [20, 28]) and
# [32, 40] (ops [32, 35], [36, 40]).  Step 2, a chunk: host serve.prefill
# [100, 300] inside portbench.prefill [100, 300], two mamba.mixer events,
# device ranges [110, 150] and [160, 200], each holding the three SSD
# kernels (10 + 5 + 20 and 8 + 4 + 16 us) and one other op (3 us).

OPS = [("elementwise", 20, 28), ("gemv", 32, 35), ("copy", 36, 40),
       ("ssd_chunk_state_kernel", 110, 120), ("ssd_state_pass_kernel",
                                              121, 126),
       ("ssd_chunk_out_kernel", 127, 147), ("elementwise", 147, 150),
       ("ssd_chunk_state_kernel", 160, 168), ("ssd_state_pass_kernel",
                                              169, 173),
       ("ssd_chunk_out_kernel", 174, 190), ("elementwise", 195, 198)]
RANGES = [("mamba.mixer", 20, 30), ("mamba.mixer", 32, 40),
          ("portbench.prefill", 100, 300),
          ("mamba.mixer", 110, 150), ("mamba.mixer", 160, 200)]
HOST = [("serve.step", 0, 70, 1), ("serve.decode", 10, 60, 1),
        ("mamba.mixer", 12, 14, 1), ("mamba.mixer", 15, 17, 1),
        ("serve.step", 90, 320, 1), ("serve.prefill", 100, 300, 1),
        ("mamba.mixer", 102, 104, 1), ("mamba.mixer", 105, 107, 1)]
DIMS = {"ssm_heads": 128, "ssm_head_dim": 64, "d_state": 128, "ngroups": 1,
        "chunk": 256}


def _run(ranges=RANGES, host=HOST, ops=OPS, dims=DIMS):
    run = Run(kind="serve", dims=dict(dims), workload={})
    run.trace = devtrace.DeviceTrace(ops=list(ops), ranges=list(ranges),
                                     host=list(host), end_us=400.0)
    run.extra = {"serve": {"chunk": 256}, "steps": [
        {"prefill": None, "decode": [0], "profiled": True},
        {"prefill": (0, 0, 0, 200, True), "decode": [], "profiled": True}]}
    return run


def test_mamba_readers_read_the_hand_computed_values():
    assert discover.reader("mamba_ms.decode")(_run()) == \
        pytest.approx(1e-3 * (8 + 3 + 4), rel=1e-12)
    assert discover.reader("mamba_ms.prefill")(_run()) == \
        pytest.approx(1e-3 * (10 + 5 + 20 + 3 + 8 + 4 + 16 + 3), rel=1e-12)


def test_ssd_roofline_reads_the_hand_computed_value():
    least = peaks.least_seconds(*ssd_work.cost(1, 256, 128, 64, 128, 1,
                                               256))
    dev = (10 + 5 + 20 + 8 + 4 + 16) / 1e6
    got = discover.reader("ssd_roofline.prefill")(_run())
    assert got == pytest.approx(100.0 * 2 * least / dev, rel=1e-12)


@pytest.mark.parametrize("name", ["mamba_ms.decode", "mamba_ms.prefill",
                                  "ssd_roofline.prefill"])
def test_readers_find_nothing_in_a_program_without_the_ranges(name):
    """The parent program has no ``mamba.mixer`` ranges, and the longdoc
    and chat cells no Mamba dims: each reader returns None."""
    read = discover.reader(name)
    bare = [r for r in RANGES if r[0] != "mamba.mixer"]
    host = [h for h in HOST if h[0] != "mamba.mixer"]
    ops = [o for o in OPS if "ssd" not in o[0]]
    assert read(_run(ranges=bare, host=host, ops=ops)) is None
    assert read(_run(dims={})) is None or name != "ssd_roofline.prefill"
    assert read(Run(kind="serve", dims={}, workload={})) is None


def test_benchmark_lists_the_new_metrics_for_the_hybrid_cell_only():
    bench = discover.benchmark()
    names = discover.metric_names(CELL, True, bench)
    assert {"mamba_ms.decode", "mamba_ms.prefill",
            "ssd_roofline.prefill", "moe_ms.decode"} <= set(names)
    for cell in ("qwen3moe-serve-chat", "qwen3moe-serve-longdoc"):
        assert "mamba_ms.decode" not in discover.metric_names(cell, True,
                                                              bench)
    assert dataclasses.is_dataclass(Run)
