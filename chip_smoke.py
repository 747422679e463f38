#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing one line of numbers:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build   — both CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with
             nvcc for sm_90a, in parallel;
3. kernels — each kernel against its plain PyTorch version on the card, in
             bf16 (tolerance 2e-2 for RMSNorm, 4e-3 for attention) and fp32
             (2e-5), TF32 off;
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
             card's busy time (torch.profiler), and the kernels that take
             it; then the step's wall time at mid-run lengths against
             length 0, in the order A B B A;
6. a JSON line of every kernel at the serve shapes: launches on the serve
   run (in all and per forward call), error against the plain version,
   device times of the kernel, the
   plain version and one PyTorch library call (``ms``, ``plain_ms``,
   ``library_ms``), the kernel's time per call as the host launches it
   (``call_ms``), and the bound from the card's data sheet.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    """allclose with rtol = atol = tol (the repo's kernel tolerance)."""
    return bool(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol))


# -- phase 3: kernels against their plain versions ------------------------------


def check_kernels(dev, gen, failures: list) -> None:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rows(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    results = []
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        for n in (1, 8, 256, 1000):
            x, w = rand(n, 2048, dtype=dtype), rand(2048, dtype=torch.float32)
            y, ref = fused_rmsnorm(x, w), rmsnorm_ref(x, w)
            results.append((f"rmsnorm N={n} D=2048 {dtype}", y, ref, tol))
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
                            attention_ref(q, k, v, **kw), attn_tol))
    torch.cuda.synchronize()
    worst = {}
    for label, out, ref, tol in results:
        err = max_err(out, ref)
        key = label.split()[0] + (" fp32" if tol == FP32_TOL else " bf16")
        worst[key] = max(worst.get(key, 0.0), err)
        if not close(out, ref, tol):
            failures.append(f"kernel check {label}: max abs err {err:.3g} "
                            f"over tolerance {tol}")
    phase("kernels", cases=len(results), max_abs_err=worst,
          tolerance={"rmsnorm bf16": BF16_TOL, "attention bf16": ATTN_BF16_TOL,
                     "fp32": FP32_TOL}, tf32=False)


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
    (torch.profiler's kernel durations), at the mid-run lengths."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = ctx["scfg"].slots
    lengths = mid_run_lengths(ctx)
    step = decode_step(dev, ctx, lengths)
    for _ in range(3):
        step()
    wall = wall_ms(step, steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]

    def dev_us(e):
        return float(getattr(e, "device_time_total", 0.0) or 0.0)

    busy_ms = sum(dev_us(e) for e in kernels) / steps / 1e3
    if busy_ms <= 0.0:
        phase("profile", step="decode", lengths=lengths, wall_ms=wall,
              device_busy_ms="not measured")
        return
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    phase("profile", step="decode", slots=s, lengths=lengths,
          wall_ms=wall, device_busy_ms=busy_ms,
          idle_share=max(0.0, 1.0 - busy_ms / wall),
          kernel_launches_per_step=sum(e.count for e in kernels) / steps,
          top_kernels=[{"kernel": e.key[:80],
                        "ms_per_step": dev_us(e) / steps / 1e3,
                        "launches_per_step": e.count / steps} for e in top])


# -- phase 6: kernel times at the serve shapes ----------------------------------


def kernel_table(dev, gen, ctx: dict) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask, attention_ref,
    )
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

    def bound(nbytes: float, ops: float, ops_rate: float):
        t_b, t_o = nbytes / chip.hbm_bw, ops / ops_rate
        return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    out = []
    for phase_name, (b, sq, offs) in shapes.items():
        # RMSNorm: x (b, sq, d) bf16, fp32 weight, bf16 out (as in the model)
        x = torch.randn(b, sq, d, generator=gen, device=dev).to(bf16)
        w = torch.randn(d, generator=gen, device=dev)
        w_lib = w.to(bf16)
        n = b * sq
        err = max_err(fused_rmsnorm(x, w), rmsnorm_ref(x, w))
        ms = cuda_ms(lambda: fused_rmsnorm(x, w))
        call_ms = cuda_ms(lambda: fused_rmsnorm(x, w), queued=False)
        plain = cuda_ms(lambda: rmsnorm_ref(x, w))
        lib = cuda_ms(lambda: F.rms_norm(x, (d,), w_lib, 1e-5))
        bms, by = bound(2 * n * d * 2 + d * 4, 4 * n * d, FP32_FLOPS)
        out.append({
            "name": f"rmsnorm@{phase_name}", "route": "cuda",
            "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:37",
            "launches": ctx["launches"]["rmsnorm"],
            "launches_per_forward": per_forward("rmsnorm"),
            "shape": f"x ({b}, {sq}, {d}) bf16, w fp32",
            "max_abs_err": err, "ms": ms, "call_ms": call_ms,
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
        call_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw),
                          queued=False)
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
        bms, by = bound(nbytes, 4 * h * hd * keys, chip.peak_flops)
        out.append({
            "name": f"flash_attention@{phase_name}", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:127",
            "launches": ctx["launches"]["flash_attention"],
            "launches_per_forward": per_forward("flash_attention"),
            "shape": f"q ({b}, {sq}, {h}, {hd}) vs k/v ({b}, {view}, {kh}, "
                     f"{hd}) bf16, q_offset {offs}",
            "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "library": "torch.nn.functional.scaled_dot_product_attention"})
    return out


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
    _build.build_all(["rmsnorm", "flash_attention"])
    phase("build", seconds=time.perf_counter() - t0,
          flags=" ".join(_build.NVCC_FLAGS))

    failures: list[str] = []
    gen = torch.Generator(device=dev).manual_seed(0)
    check_kernels(dev, gen, failures)
    ctx = serve(dev, failures)
    profile_decode(dev, ctx)
    context_effect(dev, ctx)
    table = kernel_table(dev, gen, ctx)
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
