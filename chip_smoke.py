#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing one line of numbers:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build   — the three CUDA kernels from ``src/repro_torch/kernels/*/csrc``
             with nvcc for sm_90a, in parallel;
3. kernels — each kernel against its plain PyTorch version on the card, at
             the serve and the train paths' shapes, in bf16 (tolerance 2e-2
             for RMSNorm, 4e-3 for attention, 5e-2 for the SSD scan) and
             fp32 (2e-5; 2e-4 for the SSD scan, against its plain version
             evaluated in fp64), TF32 off;
4. serve   — llama3.2-1b at full width (16 layers, d_model 2048, 32/8 heads,
             vocab 128256; random weights from a seeded generator):
             ``calibrate_serve`` into a ProfileDB at the trace's mean decode
             context (two passes, the twin prices from the second), the
             continuous-batching
             engine over a 16-request Poisson trace, the priced DES twin from
             that DB and the replay twin; asserts identical step
             compositions, launch counts of 33 RMSNorms and 16 attentions per
             forward call, every priced node a DB hit, and the engine's
             chunked prefill logits against the whole-prompt ``Model.prefill``;
             prints the simulated-vs-measured latency error (not gated);
5. profile — one decode step at mid-run lengths: host wall time against the
             card's busy time over the same profiled steps
             (torch.profiler), and the kernels that take it; then the
             step's wall time at mid-run lengths against length 0, in the
             order A B B A;
6. train   — mamba2-2.7b at its published widths and depth (64 layers,
             d_model 2560, 80 SSD heads of 64, d_state 128; fp32 master
             weights, bf16 compute, per-layer remat, AdamW; random weights
             from a seeded generator) through ``launch.train.train``: seq
             2048, batch 4, grad_accum 2, 3 steps; per step the loss, grad
             norm, host and device ms and the launches of each kernel, which
             must be 256 SSD scans and 258 RMSNorms; the peak memory; then
             one more step under torch.profiler (busy and wall of that step);
7. ssm     — ``Model.prefill`` of a 512-token prompt (two chunks) and 8
             ``decode`` steps, each against the whole-sequence prefill at the
             same position, in bf16 (limit 0.09 of the logits' scale) and
             in fp32 compute (limit 1e-3); per compute type 576 SSD scans
             and 1105 RMSNorms (9 prefills, 8 decode steps, 64 layers);
8. simtrain — the paper's loop (``launch.sim_accuracy.run``) at full width:
             the traced step, offline op profiles on the card, simulated
             offline and refined against the measured step (not gated);
             the traced graph's kernel nodes and the real step's launches
             must both be 128 SSD scans and 129 RMSNorms a step;
9. a JSON line of every kernel at the serve and train shapes: launches on
   the serve or train run, error against the plain version, device times
   of the kernel, the plain version and one PyTorch library call where one
   computes the same function (``ms``, ``plain_ms``, ``library_ms``), the
   kernel's time per call as the host launches it under inference mode
   (``call_ms``, the median of five readings; for RMSNorm at the serve
   shapes also without the ``torch.library`` op's dispatch,
   ``call_ms_without_op``), and the bound from the card's data sheet.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 2e-2        # tests/test_kernels.py::tol for bfloat16
FP32_TOL = 2e-5        # ... and for float32
# bf16 attention: outputs over 1-2k keys are only ~0.03-0.05 here, so 2e-2
# would pass a dropped tile; 4x the worst error measured on the H100 (1e-3)
ATTN_BF16_TOL = 4e-3
# SSD scan: the JAX kernel tests' tolerances (tests/test_kernels.py:101-102)
SSD_BF16_TOL = 5e-2
SSD_FP32_TOL = 2e-4
# (batch, seq, heads, head_dim, d_state, chunk, B and C broadcast over heads):
# a small case, and the train path's shape (mamba2-2.7b, one microbatch)
SSD_CASES = {"small 1x512 H4 P64 N128 Q128": (1, 512, 4, 64, 128, 128, False),
             "train 2x2048 H80 P64 N128 Q256 bcast": (2, 2048, 80, 64, 128, 256,
                                                      True)}
# RMSNorm rows x width: the serve path's (llama3.2-1b, d_model 2048: a
# decode batch, prefill chunks) and the train path's (mamba2-2.7b, d_model
# 2560: one microbatch of 2 x 2048 tokens)
RMS_CASES = ((1, 2048), (8, 2048), (256, 2048), (1000, 2048), (4096, 2560))
ARCH = "llama3.2-1b"
SERVE = dict(slots=8, max_len=2048, block_size=16, chunk=256)
TRACE = dict(n=16, rate=8.0, prompt_lens=(128, 256, 512, 1024),
             max_new_tokens=(32, 64, 128), seed=0)
# fp32 rate outside the tensor cores (NVIDIA's H100 SXM data sheet), the
# operations bound of RMSNorm's arithmetic; the other peaks come from the
# card's PlatformSpec
FP32_FLOPS = 67e12
CAL_REPEATS = 10       # samples per ProfileDB entry
SPIN_CYCLES = 50_000_000   # ~25 ms at the H100's ~2 GHz boost clock
CAL_PASSES = 2         # calibration passes; the twin prices from the last
CALL_READINGS = 5      # host readings of a kernel's call time; the median
TRAIN_ARCH = "mamba2-2.7b"
# the config's grad_accum (2); seq and batch of the train cell at one card
TRAIN = dict(seq=2048, batch=4, grad_accum=2, steps=3, seed=0)
# prefill of 512 tokens (two 256-token chunks), then 8 decode steps, each
# against the whole-sequence prefill at the same position; limits relative
# to the logits' scale.  In bf16 the decode step (one token a product) and
# the prefill (products over the sequence) round each of the 64 layers'
# activations differently: the worst differences measured on the H100 were
# 4.8 % and 6.1 % of the scale (two token draws), hence 0.09 (1.5x).  In
# fp32 the two paths differ only in the order of fp32 sums, hence 1e-3: a
# wrong carried state or conv tail would miss it by orders of magnitude.
# The tokens come from their own seeded generator.
SSM = dict(batch=2, prompt=512, decode=8, seed=1,
           tol={"bfloat16": 0.09, "float32": 1e-3})
# profiler ranges: the train step's phases and the kernel ops
RANGES = ("train_step.", "repro_torch::")
# kernel names -> kinds, for the train step's device-time breakdown (first
# match wins)
KERNEL_KINDS = (
    ("ssd_scan kernel", ("ssd_scan_kernel",)),
    ("rmsnorm kernel", ("rmsnorm",)),
    ("gemm fp32", ("sgemm", "f32f32", "gemv")),
    ("gemm bf16", ("nvjet", "gemm", "cutlass", "xmma")),
    ("reduce", ("reduce",)),
    ("copy / cast", ("copy", "cat", "fill", "index")),
    ("elementwise", ("elementwise", "vectorized")),
)
# the simulator's loop at full width: one microbatch of the train cell
# (its profile grids grow from the JAX benchmark's to the traced step's
# sizes: launch.sim_accuracy.profile_grids)
SIMTRAIN = dict(seq=2048, batch=2, steps=3, repeats=5)


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + json.dumps(fields, sort_keys=True), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            queued: bool = True) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, between
    two CUDA events.

    ``queued``: the stream first spins for ~25 ms (``torch.cuda._sleep``),
    so every launch is queued before the first event fires and the events
    time the device's work alone.  Without it, small kernels are timed at
    the rate the host can launch them, wrapper overhead included.
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn) -> float:
    """The median of ``CALL_READINGS`` host-paced readings of ``cuda_ms``
    under inference mode, as the serve engine calls the kernels: a single
    reading of a small kernel's call time swings with the host."""
    def call():
        with torch.inference_mode():
            fn()

    readings = sorted(cuda_ms(call, queued=False)
                      for _ in range(CALL_READINGS))
    return readings[len(readings) // 2]


def device_kernels(prof) -> list:
    """The kernels of a torch.profiler run (``key_averages``), without the
    named ranges that the profiler also puts on the device timeline (the
    step's ``train_step.*``, the ops' ``repro_torch::*``): a range's device
    time is a span over kernels counted already."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(RANGES)]


def device_ranges(prof) -> dict:
    """Device milliseconds spanned by each named range (see
    ``device_kernels``)."""
    from torch.autograd import DeviceType

    return {e.key: float(getattr(e, "device_time_total", 0.0) or 0.0) / 1e3
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.key.startswith(RANGES)}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    """allclose with rtol = atol = tol (the repo's kernel tolerance)."""
    return bool(torch.allclose(a.double(), b.double(), rtol=tol, atol=tol))


def ssd_inputs(gen, dev, b, s, h, p, n, bcast, dtype):
    """SSD-scan inputs as the JAX kernel tests draw them: x, B, C normal,
    dt uniform in [0.01, 1), A = -exp(normal); B and C broadcast over the
    heads as a stride-0 view where ``bcast`` (the model's ngroups = 1)."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    x = rand(b, s, h, p)
    if bcast:
        B, C = (rand(b, s, 1, n).expand(b, s, h, n) for _ in range(2))
    else:
        B, C = rand(b, s, h, n), rand(b, s, h, n)
    dt = 0.01 + 0.99 * torch.rand((b, s, h), generator=gen, device=dev)
    A = -torch.exp(torch.randn(h, generator=gen, device=dev))
    return x, B, C, dt, A


# -- phase 3: kernels against their plain versions ------------------------------


def check_kernels(dev, gen, failures: list) -> None:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rows(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    results = []
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        dt_name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for n, d in RMS_CASES:
            x, w = rand(n, d, dtype=dtype), rand(d, dtype=torch.float32)
            y, ref = fused_rmsnorm(x, w), rmsnorm_ref(x, w)
            results.append((f"rmsnorm N={n} D={d} {dtype}", y, ref, tol,
                            f"rmsnorm {dt_name}"))
        cases = [
            # the TPU kernel's semantics: causal Sq == Skv, non-causal Sq != Skv
            ("causal 2x256x256 H8/K2 D64", (2, 256, 256, 8, 2, 64), True,
             None, None),
            ("non-causal 2x200x333 H8/K2 D64", (2, 200, 333, 8, 2, 64), False,
             None, None),
            # the serve path: a prefill chunk and a decode batch, paged masks
            ("prefill 1x256 vs view 2048 H32/K8 q_offset=768",
             (1, 256, 2048, 32, 8, 64), True, [768], [2048]),
            ("decode 8x1 vs view 2048 H32/K8 lengths",
             (8, 1, 2048, 32, 8, 64), True,
             [0, 127, 255, 511, 1023, 1100, 1500, 2047], [2048] * 8),
        ]
        attn_tol = ATTN_BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        for label, (b, sq, skv, h, kh, d), causal, qo, kl in cases:
            q, k, v = (rand(b, sq, h, d, dtype=dtype),
                       rand(b, skv, kh, d, dtype=dtype),
                       rand(b, skv, kh, d, dtype=dtype))
            kw = dict(causal=causal, q_offset=None if qo is None else rows(qo),
                      kv_len=None if kl is None else rows(kl))
            results.append((f"attention {label} {dtype}",
                            flash_attention(q, k, v, **kw),
                            attention_ref(q, k, v, **kw), attn_tol,
                            f"attention {dt_name}"))
    # the SSD scan against its plain version evaluated in fp64 on the same
    # values: at the train shape y sums 256 terms of order 5, so the plain
    # version in fp32, in another order, is itself ~2e-4 off where y is small
    for dtype, tol in ((torch.bfloat16, SSD_BF16_TOL),
                       (torch.float32, SSD_FP32_TOL)):
        dt_name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for label, (b, s, h, p, n, chunk, bcast) in SSD_CASES.items():
            ins = ssd_inputs(gen, dev, b, s, h, p, n, bcast, dtype)
            y, st = ssd_scan(*ins, chunk=chunk, out_dtype=torch.float32)
            yr, sr = ssd_scan_ref(*(t.double() for t in ins), chunk)
            results.append((f"ssd_scan {label} y {dtype}", y, yr, tol,
                            f"ssd_scan {dt_name}"))
            results.append((f"ssd_scan {label} state {dtype}", st, sr, tol,
                            f"ssd_scan {dt_name}"))
    torch.cuda.synchronize()
    worst = {}
    for label, out, ref, tol, key in results:
        err = max_err(out, ref)
        worst[key] = max(worst.get(key, 0.0), err)
        if not close(out, ref, tol):
            failures.append(f"kernel check {label}: max abs err {err:.3g} "
                            f"over tolerance {tol}")
    phase("kernels", cases=len(results), max_abs_err=worst,
          tolerance={"rmsnorm bf16": BF16_TOL, "attention bf16": ATTN_BF16_TOL,
                     "rmsnorm/attention fp32": FP32_TOL,
                     "ssd_scan bf16": SSD_BF16_TOL,
                     "ssd_scan fp32": SSD_FP32_TOL}, tf32=False)


# -- phase 4: serve at full width -----------------------------------------------


def serve(dev, failures: list) -> dict:
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.database import ProfileDB
    from repro_torch.core.estimator import OpTimeEstimator
    from repro_torch.core.hardware import platform_for_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models import build_model
    from repro_torch.netprof.pricing import graph_provenance
    from repro_torch.serve import paged
    from repro_torch.serve.cost import calibrate_serve
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.policy import ServeConfig
    from repro_torch.serve.report import (
        latency_report, records_from_requests, serve_parity_report,
    )
    from repro_torch.serve.sim import replay_schedule, simulate_serve
    from repro_torch.serve.trace import poisson_trace, prompt_tokens

    cfg = get_config(ARCH)
    platform = platform_for_device(torch.cuda.get_device_name(dev))
    scfg = ServeConfig(**SERVE)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    trace = poisson_trace(TRACE["n"], TRACE["rate"],
                          prompt_lens=TRACE["prompt_lens"],
                          max_new_tokens=TRACE["max_new_tokens"],
                          seed=TRACE["seed"])
    # the steps are timed at the mean context of the trace's decode tokens:
    # the attention kernel's work follows the context, and at 0 (the JAX
    # package's choice) a decode step does almost no attention
    context = round(float(np.mean([
        t.prompt_len + i for t in trace
        for i in range(scfg.effective_max_tokens(t.prompt_len,
                                                 t.max_new_tokens))])))

    # two calibration passes: the first also warms the host up (the steps
    # are host-bound and their times drift down over the first seconds);
    # the twin prices from the second, and both are printed
    dbs = []
    t0 = time.perf_counter()
    for _ in range(CAL_PASSES):
        dbs.append(ProfileDB())
        n_entries = calibrate_serve(dbs[-1], model, params, scfg,
                                    platform.name, repeats=CAL_REPEATS,
                                    device=dev, context=context)
    t_cal = time.perf_counter() - t0
    db = dbs[-1]

    engine = ServeEngine(model, params, device=dev, **SERVE)
    engine.warmup()
    for t in trace:
        engine.submit(Request(rid=t.rid, prompt=prompt_tokens(t, cfg.vocab_size),
                              max_new_tokens=t.max_new_tokens,
                              arrival_s=t.arrival_s))
    # the main path: counts from zero, read right after
    rms_ops.LAUNCHES.reset()
    fa_ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    finished = engine.run_until_done()
    t_run = time.perf_counter() - t0
    launches = {"rmsnorm": rms_ops.LAUNCHES.count,
                "flash_attention": fa_ops.LAUNCHES.count}
    n_prefill = sum(1 for s in engine.step_log if s[2] is not None)
    n_decode = sum(1 for s in engine.step_log if s[3])
    forwards = n_prefill + n_decode
    per_fwd = {"rmsnorm": 2 * cfg.num_layers + 1,
               "flash_attention": cfg.num_layers}
    for name, per in per_fwd.items():
        if launches[name] != per * forwards or launches[name] == 0:
            failures.append(f"{name}: {launches[name]} launches on the serve "
                            f"run, expected {per} x {forwards} forward calls")

    # outputs: every request done with its token budget, ids in the vocab
    for r in finished:
        want = scfg.effective_max_tokens(len(r.prompt), r.max_new_tokens)
        if len(r.output) != want or not all(0 <= t < cfg.vocab_size
                                            for t in r.output):
            failures.append(f"request {r.rid}: {len(r.output)} tokens "
                            f"(expected {want}) or ids outside the vocab")
    if len(finished) != len(trace):
        failures.append(f"{len(finished)}/{len(trace)} requests finished")

    records = records_from_requests(finished)
    makespan = max(t for r in finished for t in r.token_times_s)
    eng_lat = latency_report(records, makespan)
    est = OpTimeEstimator(platform, db=db, use_learned=False)
    sim = simulate_serve(trace, cfg, scfg, est, name=f"serve-{cfg.name}")
    twin = replay_schedule(trace, scfg, engine.step_durations)
    report = serve_parity_report(engine.step_log, twin.step_log,
                                 engine_latency=eng_lat,
                                 sim_latency=sim.latency)
    if not report["composition_ok"]:
        failures.append(f"step compositions differ: "
                        f"{report['composition_mismatches'][:2]}")
    if twin.latency != eng_lat:
        failures.append("replay twin's latency report differs from the "
                        "engine's")
    prov = graph_provenance(sim.graph)
    if any(p != "measured-db" for fam in prov.values() for p in fam):
        failures.append(f"priced nodes not all DB hits: {prov}")

    # the engine's chunked prefill (paged functions, fresh pool) against the
    # whole-prompt Model.prefill, for the first request of several chunks
    req = next(t for t in trace if t.prompt_len > scfg.chunk)
    prompt = prompt_tokens(req, cfg.vocab_size)
    pool = paged.init_pool(cfg, scfg, dev)
    row = torch.arange(1, scfg.max_blocks_per_slot + 1, dtype=torch.int32,
                       device=dev)
    with torch.inference_mode():
        start = 0
        while start < len(prompt):
            width = min(scfg.chunk, len(prompt) - start)
            bucket = scfg.bucket(width)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :width] = prompt[start:start + width]
            chunked, pool = paged.prefill_chunk(
                engine.params, pool, torch.as_tensor(toks, device=dev), start,
                width, row, 0, cfg, scfg)
            start += width
        whole, _ = model.prefill(
            engine.params, torch.as_tensor(prompt[None], device=dev))
    torch.cuda.synchronize()
    ref_scale = float(whole.abs().max())
    logit_err = max_err(chunked, whole)
    if not (torch.isfinite(chunked).all() and chunked.shape == whole.shape
            and logit_err <= BF16_TOL * max(1.0, ref_scale)):
        failures.append(f"chunked prefill logits of request {req.rid} "
                        f"differ from "
                        f"Model.prefill by {logit_err:.3g} "
                        f"(logit scale {ref_scale:.3g})")

    def lat(d):
        return {k: d[k] for k in ("goodput_tok_per_s", "ttft_p50_s",
                                  "per_token_p50_s", "per_token_p99_s")}

    # measured step costs beside the DB's, for the sim-vs-engine error
    decode_only = [d for s, d in zip(engine.step_log, engine.step_durations)
                   if s[2] is None and s[3]]
    with_prefill = [d for s, d in zip(engine.step_log, engine.step_durations)
                    if s[2] is not None]
    step_ms = {"decode_only_p50": 1e3 * float(np.median(decode_only)),
               "decode_only_n": len(decode_only),
               "with_prefill_p50": 1e3 * float(np.median(with_prefill)),
               "with_prefill_n": len(with_prefill)}
    db_ms = [{f"{fam}@{e.args.get('tokens', e.args.get('slots'))}":
              1e3 * e.mean_s
              for fam in ("serve_prefill", "serve_decode")
              for e in d.entries(platform.name, fam)} for d in dbs]

    phase("serve", arch=cfg.name, platform=platform.name, serve=SERVE,
          trace=TRACE, requests=len(finished),
          tokens=eng_lat["total_tokens"], steps=len(engine.step_log),
          forward_calls={"prefill": n_prefill, "decode": n_decode},
          launches=launches, db_entries=n_entries,
          calibration_context=context,
          seconds={"init": t_init, "calibrate": t_cal, "engine": t_run},
          engine_step_ms=step_ms, db_ms=db_ms,
          engine=lat(eng_lat), sim=lat(sim.latency),
          sim_vs_engine_rel_err=report["latency_rel_err"],
          composition_ok=report["composition_ok"], provenance=prov,
          prefill_logits={"rid": req.rid, "prompt_len": req.prompt_len,
                          "max_abs_err": logit_err, "logit_scale": ref_scale})
    return {"launches": launches, "forward_calls": forwards,
            "platform": platform, "trace": trace, "cfg": cfg, "scfg": scfg,
            "params": engine.params}


def mid_run_lengths(ctx: dict) -> list:
    """A decode batch in mid-run: each slot's context is its prompt plus half
    its token budget (the first ``slots`` requests of the trace)."""
    scfg = ctx["scfg"]
    return [min(t.prompt_len + t.max_new_tokens // 2, scfg.view_len - 1)
            for t in ctx["trace"][: scfg.slots]]


# -- phase 5: where a decode step's time goes -----------------------------------


def decode_step(dev, ctx: dict, lengths: list):
    """One full decode step (argmax readback included) with the lanes at
    ``lengths``, each lane on its own blocks."""
    from repro_torch.serve import paged

    cfg, scfg, params = ctx["cfg"], ctx["scfg"], ctx["params"]
    s, mb = scfg.slots, scfg.max_blocks_per_slot
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tables = (torch.arange(s * mb, dtype=torch.int32, device=dev).view(s, mb)
              + 1)
    toks = torch.ones((s, 1), dtype=torch.int32, device=dev)
    pool = paged.init_pool(cfg, scfg, dev)

    def step():
        with torch.inference_mode():
            logits, _ = paged.decode_batch(params, pool, toks, lens, tables,
                                           cfg, scfg)
            return torch.argmax(logits[:, -1], dim=-1).cpu()

    return step


def wall_ms(step, steps: int) -> float:
    """Mean host wall milliseconds of ``step`` over ``steps`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def context_effect(dev, ctx: dict, steps: int = 20) -> None:
    """The decode step's wall time at mid-run lengths against length 0 (where
    ``calibrate_serve`` times it by default), in the order A B B A so that a
    drift of the host's speed cancels."""
    mid = decode_step(dev, ctx, mid_run_lengths(ctx))
    zero = decode_step(dev, ctx, [0] * ctx["scfg"].slots)
    for _ in range(3):
        mid(), zero()
    runs = {"mid_run": [], "length_0": []}
    for name in ("mid_run", "length_0", "length_0", "mid_run"):
        runs[name].append(wall_ms(mid if name == "mid_run" else zero, steps))
    phase("context", step="decode", steps_per_run=steps, order="ABBA",
          wall_ms=runs, mean_ms={k: sum(v) / len(v) for k, v in runs.items()})


def profile_decode(dev, ctx: dict, steps: int = 5) -> None:
    """Host wall time of one full decode step against the card's busy time
    (torch.profiler's kernel durations), at the mid-run lengths.  The idle
    share is taken over the profiled steps themselves (busy and wall of the
    same steps; the profiler slows the host); the wall time of as many
    steps without the profiler is printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    s = ctx["scfg"].slots
    lengths = mid_run_lengths(ctx)
    step = decode_step(dev, ctx, lengths)
    for _ in range(3):
        step()
    wall = wall_ms(step, steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = wall_ms(step, steps)
    kernels = device_kernels(prof)

    def dev_us(e):
        return float(getattr(e, "device_time_total", 0.0) or 0.0)

    busy_ms = sum(dev_us(e) for e in kernels) / steps / 1e3
    if busy_ms <= 0.0:
        phase("profile", step="decode", lengths=lengths, wall_ms=wall,
              wall_ms_profiled=wall_prof, device_busy_ms="not measured")
        return
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    phase("profile", step="decode", slots=s, lengths=lengths,
          wall_ms=wall, wall_ms_profiled=wall_prof, device_busy_ms=busy_ms,
          idle_share=1.0 - busy_ms / wall_prof,
          kernel_launches_per_step=sum(e.count for e in kernels) / steps,
          top_kernels=[{"kernel": e.key[:80],
                        "ms_per_step": dev_us(e) / steps / 1e3,
                        "launches_per_step": e.count / steps} for e in top])


# -- phase 9: kernel times at the serve and train shapes ------------------------


def kernel_table(dev, gen, ctx: dict) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask, attention_ref,
    )
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ops import cost as rms_cost
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    cfg, scfg, chip = ctx["cfg"], ctx["scfg"], ctx["platform"].chip
    bf16 = torch.bfloat16
    d, h, kh, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    view = scfg.view_len
    lengths = mid_run_lengths(ctx)
    shapes = {"decode": (scfg.slots, 1, lengths),
              "prefill": (1, scfg.chunk, [3 * scfg.chunk])}

    def per_forward(name: str) -> float:
        """Launches per forward call, both counted on the serve run."""
        return ctx["launches"][name] / max(1, ctx["forward_calls"])

    out = []
    for phase_name, (b, sq, offs) in shapes.items():
        # RMSNorm: x (b, sq, d) bf16, fp32 weight, bf16 out (as in the model)
        x = torch.randn(b, sq, d, generator=gen, device=dev).to(bf16)
        w = torch.randn(d, generator=gen, device=dev)
        w_lib = w.to(bf16)
        n = b * sq
        err = max_err(fused_rmsnorm(x, w), rmsnorm_ref(x, w))
        ms = cuda_ms(lambda: fused_rmsnorm(x, w))
        call = call_ms(lambda: fused_rmsnorm(x, w))
        # the same launch without the torch.library op's dispatch: what the
        # op costs the host-bound serve step per call
        no_op = call_ms(lambda: rms_ops._impl(x, w, 1e-5, x.dtype))
        plain = cuda_ms(lambda: rmsnorm_ref(x, w))
        lib = cuda_ms(lambda: F.rms_norm(x, (d,), w_lib, 1e-5))
        ops_, nbytes = rms_cost(x, w, 1e-5, x.dtype)
        bms, by = bound_ms(chip, nbytes, ops_, FP32_FLOPS)
        out.append({
            "name": f"rmsnorm@{phase_name}", "route": "cuda",
            "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:37",
            "launches": ctx["launches"]["rmsnorm"],
            "launches_per_forward": per_forward("rmsnorm"),
            "shape": f"x ({b}, {sq}, {d}) bf16, w fp32",
            "max_abs_err": err, "ms": ms, "call_ms": call,
            "call_ms_without_op": no_op,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "library": "torch.nn.functional.rms_norm"})

        # attention over the gathered paged view, mask as on the serve path
        q = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(bf16)
        k = torch.randn(b, view, kh, hd, generator=gen, device=dev).to(bf16)
        v = torch.randn(b, view, kh, hd, generator=gen, device=dev).to(bf16)
        qo = torch.tensor(offs, dtype=torch.int32, device=dev)
        kl = torch.full_like(qo, view)
        kw = dict(causal=True, q_offset=qo, kv_len=kl)
        err = max_err(flash_attention(q, k, v, **kw), attention_ref(q, k, v, **kw))
        ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
        call = call_ms(lambda: flash_attention(q, k, v, **kw))
        plain = cuda_ms(lambda: attention_ref(q, k, v, **kw))
        mask = attention_mask(b, sq, view, causal=True, q_offset=qo,
                              kv_len=kl, device=dev)[:, None]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        # work this data needs: the keys each row sees, read once per KV head
        keys = sum(min(view, o + i + 1) for o in offs for i in range(sq))
        keys_read = sum(min(view, o + sq) for o in offs)
        nbytes = (2 * keys_read * kh * hd * 2            # K and V
                  + 2 * b * sq * h * hd * 2 + 2 * b * 4)  # q, out, masks
        bms, by = bound_ms(chip, nbytes, 4 * h * hd * keys, chip.peak_flops)
        out.append({
            "name": f"flash_attention@{phase_name}", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:127",
            "launches": ctx["launches"]["flash_attention"],
            "launches_per_forward": per_forward("flash_attention"),
            "shape": f"q ({b}, {sq}, {h}, {hd}) vs k/v ({b}, {view}, {kh}, "
                     f"{hd}) bf16, q_offset {offs}",
            "max_abs_err": err, "ms": ms, "call_ms": call,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "library": "torch.nn.functional.scaled_dot_product_attention"})
    return out


def bound_ms(chip, nbytes: float, ops: float, ops_rate: float):
    """(milliseconds, "bytes" or "operations"): the larger of the two times
    the card needs at its data-sheet rates."""
    t_b, t_o = nbytes / chip.hbm_bw, ops / ops_rate
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def train_kernel_table(dev, gen, ctx: dict, failures: list) -> list:
    """The kernels at the train path's shapes: the SSD scan and RMSNorm of
    one microbatch of mamba2-2.7b; launches from the train run.  Each
    output is held against its plain version with the kernel checks'
    bf16 tolerance."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import cost as rms_cost
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_scan.ops import cost as ssd_cost
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.mamba import mamba_dims

    cfg, chip = ctx["cfg"], ctx["platform"].chip
    m, _, nh = mamba_dims(cfg)
    b, s = TRAIN["batch"] // TRAIN["grad_accum"], TRAIN["seq"]
    out = []

    ins = ssd_inputs(gen, dev, b, s, nh, m.head_dim, m.d_state, True,
                     torch.bfloat16)
    f32 = torch.float32

    def kern():
        return ssd_scan(*ins, chunk=m.chunk_size, out_dtype=f32)

    y, st = kern()
    # the error against the plain version evaluated in fp64 (see
    # check_kernels); its time is the plain version's own, in fp32
    yr, sr = ssd_scan_ref(*(t.double() for t in ins), m.chunk_size)
    err = max(max_err(y, yr), max_err(st, sr))
    if not (close(y, yr, SSD_BF16_TOL) and close(st, sr, SSD_BF16_TOL)):
        failures.append(f"ssd_scan@train: max abs err {err:.3g} over "
                        f"tolerance {SSD_BF16_TOL}")
    del yr, sr
    ops_, nbytes = ssd_cost(*ins, m.chunk_size, f32)
    bms, by = bound_ms(chip, nbytes, ops_, chip.peak_flops)
    out.append({
        "name": "ssd_scan@train", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:96",
        "launches": ctx["launches"]["ssd_scan"],
        "launches_per_step": ctx["launches"]["ssd_scan"] / TRAIN["steps"],
        "shape": f"x ({b}, {s}, {nh}, {m.head_dim}) bf16, B/C ({b}, {s}, "
                 f"{nh} by stride 0, {m.d_state}) bf16, dt fp32, chunk "
                 f"{m.chunk_size}, y fp32",
        "max_abs_err": err, "ms": cuda_ms(kern, iters=5),
        "call_ms": call_ms(kern),
        "plain_ms": cuda_ms(lambda: ssd_scan_ref(*ins, m.chunk_size),
                            iters=5),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library": "none: no single PyTorch call computes the chunked scan "
                   "(the plain version is a sequence of einsums and a loop "
                   "over the chunks)"})

    x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.randn(cfg.d_model, generator=gen, device=dev)
    ops_, nbytes = rms_cost(x, w, cfg.norm_eps, x.dtype)
    bms, by = bound_ms(chip, nbytes, ops_, FP32_FLOPS)
    w_lib = w.to(torch.bfloat16)
    y, yr = fused_rmsnorm(x, w, eps=cfg.norm_eps), rmsnorm_ref(x, w,
                                                                cfg.norm_eps)
    err = max_err(y, yr)
    if not close(y, yr, BF16_TOL):
        failures.append(f"rmsnorm@train: max abs err {err:.3g} over "
                        f"tolerance {BF16_TOL}")
    out.append({
        "name": "rmsnorm@train", "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:37",
        "launches": ctx["launches"]["rmsnorm"],
        "launches_per_step": ctx["launches"]["rmsnorm"] / TRAIN["steps"],
        "shape": f"x ({b}, {s}, {cfg.d_model}) bf16, w fp32",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fused_rmsnorm(x, w, eps=cfg.norm_eps)),
        "call_ms": call_ms(lambda: fused_rmsnorm(x, w, eps=cfg.norm_eps)),
        "plain_ms": cuda_ms(lambda: rmsnorm_ref(x, w, cfg.norm_eps)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: F.rms_norm(x, (cfg.d_model,), w_lib,
                                                 cfg.norm_eps)),
        "library": "torch.nn.functional.rms_norm"})
    return out


# -- phase 6: train mamba2-2.7b at full width -----------------------------------


def train_launches(cfg, grad_accum: int) -> dict:
    """Kernel launches of one train step: per microbatch, every layer's SSD
    scan and block norm in the forward pass, again in the backward pass
    where the layer is recomputed (remat), and the final norm once.  The
    gradients of both ops are the plain versions' VJPs and launch no
    kernel."""
    passes = 1 if cfg.remat_policy == "none" else 2
    return {"ssd_scan": passes * cfg.num_layers * grad_accum,
            "rmsnorm": (passes * cfg.num_layers + 1) * grad_accum}


def train_phase(dev, failures: list) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.core.hardware import platform_for_device
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.train import train
    from repro_torch.tree import leaves

    cfg = get_config(TRAIN_ARCH)
    want = train_launches(cfg, TRAIN["grad_accum"])
    counters = {"ssd_scan": ssd_ops.LAUNCHES, "rmsnorm": rms_ops.LAUNCHES}
    steps = []
    seen = {k: 0 for k in counters}

    def on_step(i, rec):
        rec = dict(rec, step=i + 1, launches={
            k: c.count - seen[k] for k, c in counters.items()})
        seen.update({k: c.count for k, c in counters.items()})
        steps.append(rec)
        phase("train-step", **rec)
        for k, n in rec["launches"].items():
            if n != want[k]:
                failures.append(f"train step {i + 1}: {n} {k} launches, "
                                f"expected {want[k]}")

    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: counts from zero, read right after
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    state, losses = train(cfg, steps=TRAIN["steps"], seq=TRAIN["seq"],
                          batch=TRAIN["batch"],
                          grad_accum=TRAIN["grad_accum"], seed=TRAIN["seed"],
                          device=dev, on_step=on_step, log_fn=lambda _: None)
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"train: non-finite losses {losses}")
    n_params = sum(p.numel() for p in leaves(state.params))
    phase("train", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
          params=n_params, **TRAIN, remat=cfg.remat_policy,
          losses=losses, launches=launches, launches_per_step_expected=want,
          max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
          seconds=wall)
    return {"cfg": cfg, "state": state, "launches": launches,
            "last_step_ms": steps[-1]["host_ms"],
            "platform": platform_for_device(torch.cuda.get_device_name(dev))}


def profile_train_step(dev, ctx: dict) -> None:
    """One more step of the same run under torch.profiler: the card's busy
    time against the host wall time of that step, and the kernels that take
    it.  The wall time of the run's last step, without the profiler, is
    printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import cosine_with_warmup, make_optimizer
    from repro_torch.train.step import make_train_step

    cfg = ctx["cfg"]
    step = make_train_step(build_model(cfg), make_optimizer(cfg.optimizer),
                           cosine_with_warmup(3e-4, 20, 21),
                           grad_accum=TRAIN["grad_accum"])
    shape = ShapeConfig("train", TRAIN["seq"], TRAIN["batch"], "train")
    src = SyntheticTokens(cfg.vocab_size, shape.seq_len, shape.global_batch,
                          seed=TRAIN["seed"])
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in src.batch_at(TRAIN["steps"]).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ctx["state"], metrics = step(ctx["state"], batch)
        float(metrics["loss"])
    wall = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)

    def dev_us(e):
        return float(getattr(e, "device_time_total", 0.0) or 0.0)

    busy = sum(dev_us(e) for e in kernels) / 1e3
    if busy <= 0.0:
        phase("train-profile", wall_ms=wall, device_busy_ms="not measured")
        return
    # device time by kind of kernel, and under the step's named ranges
    kinds: dict = {}
    for e in kernels:
        name = e.key.lower()
        kind = next((k for k, subs in KERNEL_KINDS if any(
            x in name for x in subs)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + dev_us(e) / 1e3
    ranges = device_ranges(prof)
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    phase("train-profile", wall_ms_profiled=wall, device_busy_ms=busy,
          last_step_wall_ms=ctx["last_step_ms"], idle_share=1.0 - busy / wall,
          device_ms_by_kind=kinds, device_ms_by_range=ranges,
          kernel_launches=sum(e.count for e in kernels),
          top_kernels=[{"kernel": e.key[:90], "ms": dev_us(e) / 1e3,
                        "launches": e.count} for e in top])


# -- phase 7: SSM prefill and decode against the whole sequence -----------------


def ssm_phase(dev, ctx: dict, failures: list) -> None:
    import dataclasses

    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model

    cfg, params = ctx["cfg"], ctx["state"].params
    n_tok = SSM["prompt"] + SSM["decode"]
    gen = torch.Generator(device=dev).manual_seed(SSM["seed"])
    tokens = torch.randint(1, cfg.vocab_size, (SSM["batch"], n_tok),
                           generator=gen, device=dev)
    # per dtype: 1 + decode prefills, each one SSD scan a layer; every
    # prefill and decode step a block norm a layer and the final norm
    want = {"ssd_scan": (1 + SSM["decode"]) * cfg.num_layers,
            "rmsnorm": (1 + 2 * SSM["decode"]) * (cfg.num_layers + 1)}
    counters = {"ssd_scan": ssd_ops.LAUNCHES, "rmsnorm": rms_ops.LAUNCHES}
    out = {}
    for dtype, tol in SSM["tol"].items():
        model = build_model(dataclasses.replace(cfg, compute_dtype=dtype))
        errs, scales = [], []
        # this path's run: counts from zero, read right after
        for c in counters.values():
            c.reset()
        with torch.inference_mode():
            logits, cache = model.prefill(params, tokens[:, :SSM["prompt"]])
            for i in range(SSM["decode"]):
                pos = SSM["prompt"] + i
                logits, cache = model.decode(params, cache,
                                             tokens[:, pos:pos + 1], pos)
                whole, _ = model.prefill(params, tokens[:, :pos + 1])
                if not (torch.isfinite(logits).all()
                        and logits.shape == whole.shape):
                    failures.append(f"ssm {dtype} decode step {i + 1}: "
                                    f"logits {tuple(logits.shape)} not finite "
                                    f"or not the shape of "
                                    f"{tuple(whole.shape)}")
                errs.append(max_err(logits, whole))
                scales.append(float(whole.abs().max()))
        torch.cuda.synchronize()
        launches = {k: c.count for k, c in counters.items()}
        if launches != want:
            failures.append(f"ssm {dtype}: launches {launches}, expected "
                            f"{want}")
        for i, (e, sc) in enumerate(zip(errs, scales)):
            if e > tol * max(1.0, sc):
                failures.append(f"ssm {dtype} decode step {i + 1}: logits "
                                f"differ from the whole-sequence prefill by "
                                f"{e:.3g} (scale {sc:.3g}, limit {tol} x "
                                f"scale)")
        out[dtype] = {"max_abs_err": errs, "logit_scale": scales, "tol": tol,
                      "launches": launches}
    phase("ssm", arch=cfg.name, batch=SSM["batch"], prompt=SSM["prompt"],
          decode=SSM["decode"], **out)


# -- phase 8: the simulator's train-step loop at full width ---------------------


def simtrain_phase(dev, ctx: dict, failures: list) -> dict:
    from repro_torch.launch.sim_accuracy import run

    cfg = ctx["cfg"]
    row = run(cfg, seq=SIMTRAIN["seq"], batch=SIMTRAIN["batch"],
              steps=SIMTRAIN["steps"], profile_repeats=SIMTRAIN["repeats"],
              device=dev, log_fn=lambda _: None)
    if not (row["measured_s"] > 0 and math.isfinite(row["sim_offline_s"])
            and math.isfinite(row["sim_refined_s"])):
        failures.append(f"simtrain: measured {row['measured_s']}, simulated "
                        f"{row['sim_offline_s']} / {row['sim_refined_s']}")
    # one step without grad_accum: each kernel op is one node of the traced
    # graph and one launch of the real step, forward and remat recompute
    want = train_launches(cfg, grad_accum=1)
    if not (row["graph_kernel_nodes"] == want
            and row["kernel_launches_per_step"] == want):
        failures.append(f"simtrain: kernel nodes {row['graph_kernel_nodes']}"
                        f", launches per step "
                        f"{row['kernel_launches_per_step']}, expected {want}")
    phase("simtrain", **row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on "
              "an NVIDIA card", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(dev),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build_all(["rmsnorm", "flash_attention", "ssd_scan"])
    phase("build", seconds=time.perf_counter() - t0,
          flags=" ".join(_build.NVCC_FLAGS))

    failures: list[str] = []
    gen = torch.Generator(device=dev).manual_seed(0)
    check_kernels(dev, gen, failures)
    ctx = serve(dev, failures)
    profile_decode(dev, ctx)
    context_effect(dev, ctx)
    table = kernel_table(dev, gen, ctx)
    del ctx
    torch.cuda.empty_cache()

    tctx = train_phase(dev, failures)
    profile_train_step(dev, tctx)
    tctx["state"] = tctx["state"]._replace(opt_state=None)
    ssm_phase(dev, tctx, failures)
    table += train_kernel_table(dev, gen, tctx, failures)
    cfg = tctx["cfg"]
    del tctx
    torch.cuda.empty_cache()
    simtrain_phase(dev, {"cfg": cfg}, failures)
    print(json.dumps({"kernels": table}), flush=True)
    for f in failures:
        print(f"FAIL {f}", flush=True)
    if failures:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
