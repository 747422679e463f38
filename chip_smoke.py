#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels   # build, check and time the kernels

Phases, each printing one line of numbers:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build   — the three CUDA kernels from ``src/repro_torch/kernels/*/csrc``
             with nvcc for sm_90a, in parallel, and each kernel function's
             registers, spills and static shared memory (``-Xptxas -v``);
3. kernels — each kernel against its plain PyTorch version on the card, at
             the serve and the train paths' shapes and at the kernels'
             edges (attention: decode rows ending around a split boundary,
             kv_len short of the view with K/V past it set to 1e4, head dims
             32 and 128, non-causal Sq != Skv, keys and rows mode; RMSNorm: a
             width that is not a multiple of 8, and 8192; the SSD scan:
             chunks 64, 128 and 256, one chunk, B and C per head and
             broadcast, dt = 0 on a padded tail), in bf16 (tolerance 2e-2
             for RMSNorm, 4e-3 for attention, 5e-2 for the SSD scan) and
             fp32 (2e-5; 2e-4 for the SSD scan, against its plain version
             evaluated in fp64), TF32 off; and each of the SSD scan's three
             bf16 kernels against its plain version at the train shape;
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
             (torch.profiler), the kernels that take it and the port's own
             kernels' share and launches; then the
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
9. dense-train — llama3.2-1b at its published widths and depth (16 layers,
             d_model 2048, 32/8 heads of 64, d_ff 8192, vocab 128,256, tied
             embedding; fp32 master weights, bf16 compute, per-layer remat,
             AdamW, random seeded weights) through ``launch.train.train``:
             seq 2048, batch 8, grad_accum 4 (the config's), 3 steps; per
             step the loss, host and device ms, tokens/s, peak memory and
             launches, which must be 128 flash attentions (forward and
             recompute; the gradient is the plain version's VJP) and 260
             RMSNorms; then one more step under torch.profiler (device time
             by kind and under the named ranges, the attention VJP's
             ``repro_torch::flash_attention.backward`` among them);
10. dense-check — one microbatch of that run's model through the kernel
             against the same microbatch with attention swapped for
             ``attention_ref`` (inside this script only): loss and global
             grad norm within the repo's bf16 tolerance;
11. moe     — the JAX Table-2 benchmark's ``moe_qwen3`` variant
             (``launch.sim_accuracy.smoke_config``: 4 layers, d_model 256,
             4 experts top-2, fp32; seq 128, batch 8): 3 train steps with
             finite losses, aux > 0 and 4 flash / 9 RMSNorm launches a step;
             prefill of 64 tokens and 8 decode steps against the
             whole-sequence prefill (fp32 limit 1e-3 of the logits' scale),
             at a capacity no token overflows on either path;
12. simtrain rows for ``dense_llama`` at full width on one microbatch (32
             flash and 65 RMSNorm nodes and launches) and ``moe_qwen3`` at
             the benchmark's variant (4 and 9);
13. a JSON line of every kernel at the serve and train shapes: launches on
   the serve or train run, error against the plain version, device times
   of the kernel, the plain version and one PyTorch library call where one
   computes the same function (``ms``, ``plain_ms``, ``library_ms``; for
   attention the whole op, split and combine kernels), the
   kernel's time per call as the host launches it under inference mode
   (``call_ms``, the median of five readings; for RMSNorm at the serve
   shapes also without the ``torch.library`` op's dispatch,
   ``call_ms_without_op``), the bound from the card's data sheet (the
   kernels' ``cost``), attention's launch plan, and for the SSD scan each
   of its three kernels' time, share, grid, registers, shared memory and
   the resident blocks an SM that the CUDA runtime reports for it (the
   library's launch sizes held against ``launch_plan``'s).

Phase 3 also holds flash attention at the train shapes (llama3.2-1b's
microbatch in bf16, the moe_qwen3 variant's in fp32; causal, no masks)
against its plain version, prints the bf16 launch plan, and runs
``torch.library.opcheck`` on the op on the card.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
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
# K and V past kv_len in the attention checks
PAST_KV_LEN = 1e4
# (batch, seq, heads, head_dim, d_state, chunk, B and C broadcast over heads,
# trailing tokens with dt = 0): a small case, the train path's shape
# (mamba2-2.7b, one microbatch), chunks of 64 and 128, a single chunk, B and
# C per head at chunk 256, and the SSM prefill's padding (515 real tokens of
# 768, dt = 0 past them)
SSD_CASES = {"small 1x512 H4 P64 N128 Q128": (1, 512, 4, 64, 128, 128, False,
                                              0),
             "train 2x2048 H80 P64 N128 Q256 bcast": (2, 2048, 80, 64, 128, 256,
                                                      True, 0),
             "chunk 64 2x1024 H8 bcast": (2, 1024, 8, 64, 128, 64, True, 0),
             "chunk 128 2x1024 H8 bcast": (2, 1024, 8, 64, 128, 128, True, 0),
             "one chunk 1x256 H8 Q256 bcast": (1, 256, 8, 64, 128, 256, True,
                                               0),
             "per head 1x1024 H8 Q256": (1, 1024, 8, 64, 128, 256, False, 0),
             "dt=0 tail 2x768 H8 Q256 bcast, 515 real": (2, 768, 8, 64, 128,
                                                         256, True, 253)}
# RMSNorm rows x width, and the kernel's variant: the serve path's
# (llama3.2-1b, d_model 2048: a decode batch, prefill chunks) and the train
# path's (mamba2-2.7b, d_model 2560: one microbatch of 2 x 2048 tokens), a
# warp a row; a width that is not a multiple of 8 (the scalar path) and the
# widest d_model in configs/ (8192: eight warps share a row)
RMS_CASES = ((1, 2048, "warp"), (8, 2048, "warp"), (256, 2048, "warp"),
             (1000, 2048, "warp"), (4096, 2560, "warp"), (7, 2050, "scalar"),
             (16, 8192, "block"))
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
# the SSD scan's bf16 kernels, by the bit that runs each alone
SSD_STAGES = {"ssd_chunk_state_kernel": 1, "ssd_state_pass_kernel": 2,
              "ssd_chunk_out_kernel": 4}
# profiler ranges: the train step's phases and the kernel ops
RANGES = ("train_step.", "repro_torch::")
# kernel names -> kinds, for the train step's device-time breakdown (first
# match wins)
KERNEL_KINDS = (
    ("flash_attention kernel", ("flash_mma_kernel", "flash_combine_kernel",
                                "flash_f32_kernel")),
    ("ssd_scan kernel", ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                         "ssd_chunk_out_kernel", "ssd_scan_f32_kernel")),
    ("rmsnorm kernel", ("rmsnorm",)),
    ("gemm fp32", ("sgemm", "f32f32", "gemv")),
    ("gemm bf16", ("nvjet", "gemm", "cutlass", "xmma")),
    ("reduce", ("reduce",)),
    ("copy / cast", ("copy", "cat", "fill", "index")),
    ("elementwise", ("elementwise", "vectorized")),
)
# the port's kernel functions, by name, in the decode step's profile
PORT_KERNELS = ("flash_mma_kernel", "flash_combine_kernel",
                "rmsnorm_vec_kernel", "rmsnorm_scalar_kernel")
# the simulator's loop at full width: one microbatch of the train cell
# (its profile grids grow from the JAX benchmark's to the traced step's
# sizes: launch.sim_accuracy.profile_grids)
SIMTRAIN = dict(seq=2048, batch=2, steps=3, repeats=5)
DENSE_ARCH = "llama3.2-1b"
# the config's grad_accum (4): microbatches of 2 x 2048 tokens; nothing cut
DENSE = dict(seq=2048, batch=8, grad_accum=4, steps=3, seed=0)
# [dense-check]: the loss and the global grad norm of one microbatch through
# the kernel against attention_ref, relative: the repo's bf16 tolerance
DENSE_CHECK_TOL = BF16_TOL
MOE_ARCH = "qwen3-moe-235b-a22b"
# the JAX Table-2 benchmark's moe_qwen3 cell: its reduced variant
# (launch.sim_accuracy.smoke_config), seq 128, batch 8
MOE = dict(seq=128, batch=8, grad_accum=1, steps=3, seed=0)
# MoE prefill of 64 tokens, then 8 decode steps, each against the
# whole-sequence prefill; fp32 compute, so the SSM phase's fp32 limit
MOE_DECODE = dict(batch=2, prompt=64, decode=8, seed=1, tol=1e-3)
# flash attention at the train paths' shapes ((B, S, H, K, D), dtype,
# tolerance; causal, no masks): one microbatch of llama3.2-1b, and the
# moe_qwen3 variant's batch
FLASH_TRAIN = {"dense-train": ((2, 2048, 32, 8, 64), torch.bfloat16,
                               ATTN_BF16_TOL),
               "moe_qwen3": ((8, 128, 8, 4, 32), torch.float32, FP32_TOL)}


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


def ssd_inputs(gen, dev, b, s, h, p, n, bcast, dtype, tail: int = 0):
    """SSD-scan inputs as the JAX kernel tests draw them: x, B, C normal,
    dt uniform in [0.01, 1), A = -exp(normal); B and C broadcast over the
    heads as a stride-0 view where ``bcast`` (the model's ngroups = 1); dt
    = 0 on the last ``tail`` tokens (the SSM prefill's padding)."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    x = rand(b, s, h, p)
    if bcast:
        B, C = (rand(b, s, 1, n).expand(b, s, h, n) for _ in range(2))
    else:
        B, C = rand(b, s, h, n), rand(b, s, h, n)
    dt = 0.01 + 0.99 * torch.rand((b, s, h), generator=gen, device=dev)
    if tail:
        dt[:, s - tail:] = 0.0
    A = -torch.exp(torch.randn(h, generator=gen, device=dev))
    return x, B, C, dt, A


# -- phase 3: kernels against their plain versions ------------------------------


def attention_cases(dev) -> list:
    """(label, (B, Sq, Skv, H, K, D), causal, q_offset, kv_len) of the
    attention checks."""
    from repro_torch.kernels.flash_attention.ops import (
        BLOCK_N, launch_plan, sm_count,
    )

    # the serve decode shape's splits take 64-key tiles round-robin: rows
    # whose visible keys end just before, on and after the tile where every
    # split has work, and around the first tile edges
    splits = launch_plan(8, 1, 2048, 32, 8, 64, sm_count(dev.index)).splits
    edge = BLOCK_N * splits
    seen = [edge - 1, edge, edge + 1, BLOCK_N - 1, BLOCK_N, BLOCK_N + 1, 1,
            2048]
    return [
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
        (f"decode 8x1 vs view 2048 H32/K8 at split edges ({splits} splits)",
         (8, 1, 2048, 32, 8, 64), True, [n - 1 for n in seen], [2048] * 8),
        # kv_len short of the view, K/V past it large
        ("decode 4x1 vs 512 H32/K8 kv_len < view",
         (4, 1, 512, 32, 8, 64), True, [100, 300, 511, 40],
         [64, 200, 300, 41]),
        ("prefill 2x64 vs 512 H32/K8 kv_len < view",
         (2, 64, 512, 32, 8, 64), True, [100, 400], [130, 450]),
        ("non-causal 2x40x300 H8/K2 kv_len < view",
         (2, 40, 300, 8, 2, 64), False, None, [77, 300]),
        # head dims 32 and 128, a few queries in keys mode, MHA in rows mode
        ("prefill 2x100 vs 300 H8/K2 D32", (2, 100, 300, 8, 2, 32), True,
         [200, 0], [300, 100]),
        ("decode 4x1 vs 1024 H16/K4 D32", (4, 1, 1024, 16, 4, 32), True,
         [5, 300, 700, 1023], [1024] * 4),
        ("prefill 2x100 vs 300 H8/K2 D128", (2, 100, 300, 8, 2, 128), True,
         [200, 0], [300, 100]),
        ("decode 4x1 vs 1024 H16/K4 D128", (4, 1, 1024, 16, 4, 128), True,
         [5, 300, 700, 1023], [1024] * 4),
        ("3 queries 2x3 vs 700 H8/K2", (2, 3, 700, 8, 2, 64), True,
         [600, 10], [700, 700]),
        ("MHA causal 1x40x200 H4/K4", (1, 40, 200, 4, 4, 64), True, [160],
         None),
    ]



def flash_opcheck(dev, gen, failures: list) -> str:
    """``torch.library.opcheck`` of the flash-attention op on one small bf16
    case on the card (schema, fake implementation, autograd registration,
    AOT dispatch)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v = (torch.randn(2, 128, n, 64, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_() for n in (8, 2, 2))
    try:
        torch.library.opcheck(fa_ops._flash_op,
                              (q, k, v, True, None, None, 0.125))
    except Exception as e:  # opcheck's OpCheckError names the failed check
        failures.append(f"opcheck of repro_torch::flash_attention: {e}")
        return "failed"
    return "passed"


def check_kernels(dev, gen, failures: list) -> None:
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, launch_plan, sm_count,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, kernel_path
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rows(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    results, rms_paths = [], {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        dt_name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for n, d, want in RMS_CASES:
            x, w = rand(n, d, dtype=dtype), rand(d, dtype=torch.float32)
            label = f"rmsnorm N={n} D={d} {dt_name}"
            rms_paths[label] = kernel_path(x, w)
            if rms_paths[label] != want:
                failures.append(f"kernel check {label}: the "
                                f"{rms_paths[label]} variant, expected {want}")
            y, ref = fused_rmsnorm(x, w), rmsnorm_ref(x, w)
            results.append((label, y, ref, tol, f"rmsnorm {dt_name}"))
        attn_tol = ATTN_BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        for label, (b, sq, skv, h, kh, d), causal, qo, kl in attention_cases(
                dev):
            q, k, v = (rand(b, sq, h, d, dtype=dtype),
                       rand(b, skv, kh, d, dtype=dtype),
                       rand(b, skv, kh, d, dtype=dtype))
            if kl is not None:
                # K/V past kv_len hold large finite values: a read past the
                # edge shows in the output
                for i, n in enumerate(kl):
                    k[i, n:] = PAST_KV_LEN
                    v[i, n:] = PAST_KV_LEN
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
        for label, (b, s, h, p, n, chunk, bcast, tail) in SSD_CASES.items():
            ins = ssd_inputs(gen, dev, b, s, h, p, n, bcast, dtype, tail)
            y, st = ssd_scan(*ins, chunk=chunk, out_dtype=torch.float32)
            yr, sr = ssd_scan_ref(*(t.double() for t in ins), chunk)
            results.append((f"ssd_scan {label} y {dtype}", y, yr, tol,
                            f"ssd_scan {dt_name}"))
            results.append((f"ssd_scan {label} state {dtype}", st, sr, tol,
                            f"ssd_scan {dt_name}"))
    results += ssd_stage_checks(dev, gen)
    # flash attention at the train paths' shapes: causal, no masks
    for label, ((b, s, h, kh, d), dtype, tol) in FLASH_TRAIN.items():
        q, k, v = (rand(b, s, n, d, dtype=dtype) for n in (h, kh, kh))
        dt_name = "bf16" if dtype == torch.bfloat16 else "fp32"
        results.append((f"attention train {label} {dtype}",
                        flash_attention(q, k, v), attention_ref(q, k, v), tol,
                        f"attention {dt_name}"))
    b, s, h, kh, d = FLASH_TRAIN["dense-train"][0]
    plan = launch_plan(b, s, s, h, kh, d, sm_count(dev.index))
    opcheck = flash_opcheck(dev, gen, failures)
    torch.cuda.synchronize()
    worst = {}
    for label, out, ref, tol, key in results:
        err = max_err(out, ref)
        worst[key] = max(worst.get(key, 0.0), err)
        if not close(out, ref, tol):
            failures.append(f"kernel check {label}: max abs err {err:.3g} "
                            f"over tolerance {tol}")
    phase("kernels", cases=len(results), max_abs_err=worst,
          rmsnorm_paths=rms_paths,
          flash_train_plan={"shape": [b, s, h, kh, d],
                            "keys_mode": plan.split_keys,
                            "row_tiles": plan.row_tiles,
                            "splits": plan.splits},
          flash_opcheck=opcheck,
          tolerance={"rmsnorm bf16": BF16_TOL, "attention bf16": ATTN_BF16_TOL,
                     "rmsnorm/attention fp32": FP32_TOL,
                     "ssd_scan bf16": SSD_BF16_TOL,
                     "ssd_scan fp32": SSD_FP32_TOL,
                     "ssd_scan kernels 1 (states) and 3": SSD_BF16_TOL,
                     "ssd_scan kernel 1 (cum, decay) and 2": SSD_FP32_TOL},
          tf32=False)


def ssd_stage_checks(dev, gen) -> list:
    """Each of the SSD scan's three bf16 kernels against its plain version
    evaluated in fp64, at the train shape, fed what the kernel before it
    wrote (so each check sees one kernel alone): kernel 1's cumsum and
    decays (fp64 and fp32 arithmetic: the fp32 tolerance) and chunk states
    (bf16 products: the bf16 tolerance), kernel 2's entering and final
    states (fp32 arithmetic), kernel 3's y (bf16 products)."""
    from repro_torch.kernels.ssd_scan.ops import run_stages
    from repro_torch.kernels.ssd_scan.ref import (
        chunk_out_ref, chunk_state_ref, state_pass_ref,
    )

    b, s, h, p, n, chunk, bcast, tail = SSD_CASES[
        "train 2x2048 H80 P64 N128 Q256 bcast"]
    ins = ssd_inputs(gen, dev, b, s, h, p, n, bcast, torch.bfloat16, tail)
    got = run_stages(*ins, chunk)
    x, B, C, dt, A = (t.double() for t in ins)
    cum, states, decay = chunk_state_ref(x, B, dt, A, chunk)
    st_in, final = state_pass_ref(got["states"].double(),
                                  got["decay"].double())
    y = chunk_out_ref(x, B, C, dt, got["cum"].transpose(2, 3),
                      got["st_in"].double(), chunk)
    mma, f32 = ("ssd_scan kernels 1 (states) and 3",
                "ssd_scan kernel 1 (cum, decay) and 2")
    return [(f"ssd_scan kernel {k} train {name}", out, ref, tol, key)
            for k, name, out, ref, tol, key in (
                (1, "cum", got["cum"], cum.transpose(2, 3), SSD_FP32_TOL, f32),
                (1, "decay", got["decay"], decay, SSD_FP32_TOL, f32),
                (1, "states", got["states"], states, SSD_BF16_TOL, mma),
                (2, "st_in", got["st_in"], st_in, SSD_FP32_TOL, f32),
                (2, "final", got["final"], final, SSD_FP32_TOL, f32),
                (3, "y", got["y"], y, SSD_BF16_TOL, mma))]


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
                        "launches_per_step": e.count / steps} for e in top],
          # the port's own kernels, wherever they rank
          port_kernels=[{"kernel": e.key[:80],
                         "ms_per_step": dev_us(e) / steps / 1e3,
                         "launches_per_step": e.count / steps}
                        for e in kernels if any(
                            n in e.key for n in PORT_KERNELS)])


# -- phase 13: kernel times at the serve and train shapes -----------------------


def kernel_table(dev, gen, ctx: dict) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import cost as fa_cost
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, launch_plan, sm_count, smem_bytes,
    )
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

    def launches(name: str):
        """The serve run's launches; None where no path was driven."""
        return None if ctx["launches"] is None else ctx["launches"][name]

    def per_forward(name: str):
        """Launches per forward call, both counted on the serve run."""
        if ctx["launches"] is None:
            return None
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
            "launches": launches("rmsnorm"),
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
        ops_, nbytes = fa_cost(q, k, v, True, qo, kl)
        bms, by = bound_ms(chip, nbytes, ops_, chip.peak_flops)
        plan = launch_plan(b, sq, view, h, kh, hd, sm_count(dev.index))
        out.append({
            "name": f"flash_attention@{phase_name}", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:127",
            "launches": launches("flash_attention"),
            "launches_per_forward": per_forward("flash_attention"),
            "shape": f"q ({b}, {sq}, {h}, {hd}) vs k/v ({b}, {view}, {kh}, "
                     f"{hd}) bf16, q_offset {offs}",
            "max_abs_err": err, "ms": ms, "call_ms": call,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "plan": {"keys_mode": plan.split_keys,
                     "row_tiles": plan.row_tiles, "splits": plan.splits,
                     "grid": [plan.row_tiles, b * kh, plan.splits],
                     "combine": plan.splits > 1,
                     "smem_dynamic_bytes": smem_bytes(hd)}})
    return out


def ptxas_summary(logs: dict) -> dict:
    """Per kernel package, each kernel function's registers, spills and
    static shared memory, from nvcc's ``-Xptxas -v`` output (names
    demangled where ``c++filt`` exists)."""
    out = {}
    for pkg, log in logs.items():
        funcs, cur = [], None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)'?", line)
            if m:
                if cur is None or cur["function"] != m.group(1):
                    cur = {"function": m.group(1)}
                    funcs.append(cur)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and cur is not None:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["smem_static"] = int(sm.group(1)) if sm else 0
        names = [f["function"] for f in funcs]
        if names and shutil.which("c++filt"):
            dem = subprocess.run(["c++filt"], input="\n".join(names),
                                 capture_output=True, text=True,
                                 timeout=60).stdout.splitlines()
            if len(dem) == len(names):
                for f, n in zip(funcs, dem):
                    f["function"] = n
        out[pkg] = [f for f in funcs if "registers" in f]
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
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ops import cost as ssd_cost
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.mamba import mamba_dims

    cfg, chip = ctx["cfg"], ctx["platform"].chip
    counts = ctx["launches"]

    def launches(name: str):
        """The train run's launches; None where no path was driven."""
        return None if counts is None else counts[name]

    def per_step(name: str):
        return None if counts is None else counts[name] / TRAIN["steps"]

    m, _, nh = mamba_dims(cfg)
    b, s, q = TRAIN["batch"] // TRAIN["grad_accum"], TRAIN["seq"], m.chunk_size
    out = []

    ins = ssd_inputs(gen, dev, b, s, nh, m.head_dim, m.d_state, True,
                     torch.bfloat16)
    f32 = torch.float32

    def kern():
        return ssd_scan(*ins, chunk=q, out_dtype=f32)

    y, st = kern()
    # the error against the plain version evaluated in fp64 (see
    # check_kernels); its time is the plain version's own, in fp32
    yr, sr = ssd_scan_ref(*(t.double() for t in ins), q)
    err = max(max_err(y, yr), max_err(st, sr))
    if not (close(y, yr, SSD_BF16_TOL) and close(st, sr, SSD_BF16_TOL)):
        failures.append(f"ssd_scan@train: max abs err {err:.3g} over "
                        f"tolerance {SSD_BF16_TOL}")
    del yr, sr
    ops_, nbytes = ssd_cost(*ins, q, f32)
    bms, by = bound_ms(chip, nbytes, ops_, chip.peak_flops)
    ms = cuda_ms(kern, iters=5)
    # each kernel alone (no programmatic overlap with its neighbours), on
    # the scratch of one full call
    _, _, scratch = ssd_ops.launch_uncounted(*ins, q, f32, ssd_ops.ALL_STAGES)
    stage_ms = {name: cuda_ms(lambda bit=bit: ssd_ops.launch_uncounted(
                    *ins, q, f32, bit, scratch), iters=5)
                for name, bit in SSD_STAGES.items()}
    # what the built library launches, and the runtime's resident blocks an
    # SM for each kernel; its sizes must be the plan's
    plan = ssd_ops.launch_plan(b, s, nh, m.head_dim, m.d_state, q)
    lib = ssd_ops.library_plan(b, s, nh, q, f32)
    want = {"ssd_chunk_state_kernel": (plan.state_grid, plan.smem_state),
            "ssd_state_pass_kernel": (plan.pass_grid, 0),
            "ssd_chunk_out_kernel": (plan.out_grid, plan.smem_out)}
    for name, (grid, smem) in want.items():
        got = (lib[name]["grid"], lib[name]["smem_dynamic"])
        if got != (grid, smem):
            failures.append(f"ssd_scan@train {name}: the library launches "
                            f"{got}, launch_plan says {(grid, smem)}")
    build = {f["function"]: f for f in ctx.get("ptxas", {}).get("ssd_scan", [])}
    kernels = {}
    for name, t in stage_ms.items():
        # the fp32-output instance of a kernel templated on it (demangled or
        # not), as the train path runs it
        reg = next((f for fn, f in build.items() if name in fn and (
            name + "<" not in fn or "<float>" in fn)
            and (name + "I" not in fn or name + "IfE" in fn)), {})
        kernels[name] = {"ms": t, "share": t / sum(stage_ms.values()),
                         "grid": list(lib[name]["grid"]),
                         "registers": reg.get("registers"),
                         "spill_stores": reg.get("spill_stores"),
                         "smem_static": reg.get("smem_static"),
                         "smem_dynamic": lib[name]["smem_dynamic"],
                         "blocks_per_sm": lib[name]["blocks_per_sm"]}
    out.append({
        "name": "ssd_scan@train", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:96",
        "launches": launches("ssd_scan"),
        "launches_per_step": per_step("ssd_scan"),
        "shape": f"x ({b}, {s}, {nh}, {m.head_dim}) bf16, B/C ({b}, {s}, "
                 f"{nh} by stride 0, {m.d_state}) bf16, dt fp32, chunk "
                 f"{q}, y fp32",
        "max_abs_err": err, "ms": ms, "call_ms": call_ms(kern),
        "plain_ms": cuda_ms(lambda: ssd_scan_ref(*ins, q), iters=5),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library": "none: no single PyTorch call computes the chunked scan "
                   "(the plain version is a sequence of einsums and a loop "
                   "over the chunks)",
        "kernels": kernels,
        "scratch_bytes": sum(t.numel() * t.element_size() for t in scratch)})
    del scratch

    out.append(rmsnorm_row(dev, gen, chip, "rmsnorm@train", (b, s, cfg.d_model),
                           cfg.norm_eps, launches("rmsnorm"),
                           per_step("rmsnorm"), failures))
    return out


def rmsnorm_row(dev, gen, chip, name: str, shape: tuple, eps: float,
                launches, per_step, failures: list) -> dict:
    """RMSNorm at a train path's shape, x bf16 and w fp32 as in the model,
    held against its plain version with the bf16 tolerance."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import cost as rms_cost
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    d = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(d, generator=gen, device=dev)
    ops_, nbytes = rms_cost(x, w, eps, x.dtype)
    bms, by = bound_ms(chip, nbytes, ops_, FP32_FLOPS)
    w_lib = w.to(torch.bfloat16)
    y, yr = fused_rmsnorm(x, w, eps=eps), rmsnorm_ref(x, w, eps)
    err = max_err(y, yr)
    if not close(y, yr, BF16_TOL):
        failures.append(f"{name}: max abs err {err:.3g} over tolerance "
                        f"{BF16_TOL}")
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:37",
        "launches": launches, "launches_per_step": per_step,
        "shape": f"x {tuple(shape)} bf16, w fp32",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fused_rmsnorm(x, w, eps=eps)),
        "call_ms": call_ms(lambda: fused_rmsnorm(x, w, eps=eps)),
        "plain_ms": cuda_ms(lambda: rmsnorm_ref(x, w, eps)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: F.rms_norm(x, (d,), w_lib, eps)),
        "library": "torch.nn.functional.rms_norm"}


def flash_train_row(dev, gen, chip, name: str, launches, per_step,
                    failures: list) -> dict:
    """Flash attention at a train path's shape (``FLASH_TRAIN``): causal,
    no masks, as ``layers.attention`` calls it; held against its plain
    version, timed beside SDPA (causal, GQA)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import cost as fa_cost
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, launch_plan, sm_count,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref

    (b, s, h, kh, d), dtype, tol = FLASH_TRAIN[name]
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device=dev).to(dtype)
               for n in (h, kh, kh))
    o, ref = flash_attention(q, k, v), attention_ref(q, k, v)
    err = max_err(o, ref)
    if not close(o, ref, tol):
        failures.append(f"flash_attention@{name}: max abs err {err:.3g} "
                        f"over tolerance {tol}")
    del o, ref
    ops_, nbytes = fa_cost(q, k, v, True)
    bf16 = dtype == torch.bfloat16
    bms, by = bound_ms(chip, nbytes, ops_,
                       chip.peak_flops if bf16 else FP32_FLOPS)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row = {
        "name": f"flash_attention@{name}", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:127",
        "launches": launches, "launches_per_step": per_step,
        "shape": f"q ({b}, {s}, {h}, {d}) vs k/v ({b}, {s}, {kh}, {d}) "
                 f"{'bf16' if bf16 else 'fp32'}, causal, no masks",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: flash_attention(q, k, v)),
        "call_ms": call_ms(lambda: flash_attention(q, k, v)),
        "plain_ms": cuda_ms(lambda: attention_ref(q, k, v), iters=5),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   "(is_causal, enable_gqa)"}
    if bf16:
        plan = launch_plan(b, s, s, h, kh, d, sm_count(dev.index))
        row["plan"] = {"keys_mode": plan.split_keys,
                       "row_tiles": plan.row_tiles, "splits": plan.splits,
                       "grid": [plan.row_tiles, b * kh, plan.splits],
                       "combine": plan.splits > 1}
    else:
        row["body"] = "fp32 CUDA-core kernel (flash_f32_kernel)"
    return row


# -- phases 6 and 9: train at full width ----------------------------------------


def train_launches(cfg, grad_accum: int) -> dict:
    """Kernel launches of one train step: per microbatch, every layer's
    mixer (SSD scan or flash attention) and block norms in the forward
    pass, again in the backward pass where the layer is recomputed (remat),
    and the final norm once.  The gradients of all three ops are the plain
    versions' VJPs and launch no kernel."""
    passes = 1 if cfg.remat_policy == "none" else 2
    mixers = passes * cfg.num_layers * grad_accum
    ssm = cfg.family == "ssm"
    norms = 1 if ssm else 2     # block norms a layer
    return {"ssd_scan": mixers if ssm else 0,
            "flash_attention": 0 if ssm else mixers,
            "rmsnorm": (passes * norms * cfg.num_layers + 1) * grad_accum}


def kernel_counters() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return {"ssd_scan": ssd_ops.LAUNCHES, "rmsnorm": rms_ops.LAUNCHES,
            "flash_attention": fa_ops.LAUNCHES}


def train_phase(dev, failures: list, cfg, run: dict, tag: str) -> dict:
    """``run["steps"]`` steps of ``launch.train.train`` on ``cfg``; per step
    the loss, ce and aux, host and device ms, tokens/s, the peak memory of
    that step and each kernel's launches, which must be
    ``train_launches``'s."""
    from repro_torch.core.hardware import platform_for_device
    from repro_torch.launch.train import train
    from repro_torch.tree import leaves

    want = train_launches(cfg, run["grad_accum"])
    counters = kernel_counters()
    steps = []
    seen = {k: 0 for k in counters}

    def on_step(i, rec):
        rec = dict(rec, step=i + 1, launches={
            k: c.count - seen[k] for k, c in counters.items()},
            tokens_per_s=run["batch"] * run["seq"] / (rec["host_ms"] / 1e3),
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        torch.cuda.reset_peak_memory_stats(dev)
        seen.update({k: c.count for k, c in counters.items()})
        steps.append(rec)
        phase(f"{tag}-step", **rec)
        for k, n in rec["launches"].items():
            if n != want[k]:
                failures.append(f"{tag} step {i + 1}: {n} {k} launches, "
                                f"expected {want[k]}")

    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: counts from zero, read right after
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    state, losses = train(cfg, steps=run["steps"], seq=run["seq"],
                          batch=run["batch"], grad_accum=run["grad_accum"],
                          seed=run["seed"], device=dev, on_step=on_step,
                          log_fn=lambda _: None)
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"{tag}: non-finite losses {losses}")
    n_params = sum(p.numel() for p in leaves(state.params))
    phase(tag, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
          vocab=cfg.vocab_size, params=n_params, **run,
          remat=cfg.remat_policy, losses=losses, launches=launches,
          launches_per_step_expected=want,
          max_memory_allocated_gb=max(r["peak_gb"] for r in steps),
          seconds=wall)
    return {"cfg": cfg, "run": run, "state": state, "launches": launches,
            "steps": steps, "last_step_ms": steps[-1]["host_ms"],
            "platform": platform_for_device(torch.cuda.get_device_name(dev))}


def profile_train_step(dev, ctx: dict, tag: str) -> None:
    """One more step of the same run under torch.profiler: the card's busy
    time against the host wall time of that step, and the kernels that take
    it.  The wall time of the run's last step, without the profiler, is
    printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import cosine_with_warmup, make_optimizer
    from repro_torch.train.step import make_train_step

    cfg, run = ctx["cfg"], ctx["run"]
    step = make_train_step(build_model(cfg), make_optimizer(cfg.optimizer),
                           cosine_with_warmup(3e-4, 20, 21),
                           grad_accum=run["grad_accum"])
    src = SyntheticTokens(cfg.vocab_size, run["seq"], run["batch"],
                          seed=run["seed"])
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in src.batch_at(run["steps"]).items()}
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
        phase(tag, wall_ms=wall, device_busy_ms="not measured")
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
    phase(tag, wall_ms_profiled=wall, device_busy_ms=busy,
          last_step_wall_ms=ctx["last_step_ms"], idle_share=1.0 - busy / wall,
          device_ms_by_kind=kinds, device_ms_by_range=ranges,
          range_share_of_busy={k: v / busy for k, v in ranges.items()},
          kernel_launches=sum(e.count for e in kernels),
          top_kernels=[{"kernel": e.key[:90], "ms": dev_us(e) / 1e3,
                        "launches": e.count} for e in top])


# -- phase 7: SSM prefill and decode against the whole sequence -----------------


def decode_against_prefill(model, params, tokens, prompt: int, decode: int,
                           label: str, failures: list) -> tuple:
    """``Model.prefill`` of ``prompt`` tokens, then ``decode`` steps, each
    against the whole-sequence prefill at the same position: the max abs
    errors and the logits' scales."""
    errs, scales = [], []
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens[:, :prompt],
                                      prompt + decode)
        for i in range(decode):
            pos = prompt + i
            logits, cache = model.decode(params, cache,
                                         tokens[:, pos:pos + 1], pos)
            whole, _ = model.prefill(params, tokens[:, :pos + 1])
            if not (torch.isfinite(logits).all()
                    and logits.shape == whole.shape):
                failures.append(f"{label} decode step {i + 1}: logits "
                                f"{tuple(logits.shape)} not finite or not "
                                f"the shape of {tuple(whole.shape)}")
            errs.append(max_err(logits, whole))
            scales.append(float(whole.abs().max()))
    torch.cuda.synchronize()
    return errs, scales


def check_decode_errors(errs, scales, tol: float, label: str,
                        failures: list) -> None:
    for i, (e, sc) in enumerate(zip(errs, scales)):
        if e > tol * max(1.0, sc):
            failures.append(f"{label} decode step {i + 1}: logits differ "
                            f"from the whole-sequence prefill by {e:.3g} "
                            f"(scale {sc:.3g}, limit {tol} x scale)")


def ssm_phase(dev, ctx: dict, failures: list) -> None:
    import dataclasses

    from repro_torch.models import build_model

    cfg, params = ctx["cfg"], ctx["state"].params
    n_tok = SSM["prompt"] + SSM["decode"]
    gen = torch.Generator(device=dev).manual_seed(SSM["seed"])
    tokens = torch.randint(1, cfg.vocab_size, (SSM["batch"], n_tok),
                           generator=gen, device=dev)
    # per dtype: 1 + decode prefills, each one SSD scan a layer; every
    # prefill and decode step a block norm a layer and the final norm
    want = {"ssd_scan": (1 + SSM["decode"]) * cfg.num_layers,
            "rmsnorm": (1 + 2 * SSM["decode"]) * (cfg.num_layers + 1),
            "flash_attention": 0}
    counters = kernel_counters()
    out = {}
    for dtype, tol in SSM["tol"].items():
        model = build_model(dataclasses.replace(cfg, compute_dtype=dtype))
        # this path's run: counts from zero, read right after
        for c in counters.values():
            c.reset()
        errs, scales = decode_against_prefill(
            model, params, tokens, SSM["prompt"], SSM["decode"],
            f"ssm {dtype}", failures)
        launches = {k: c.count for k, c in counters.items()}
        if launches != want:
            failures.append(f"ssm {dtype}: launches {launches}, expected "
                            f"{want}")
        check_decode_errors(errs, scales, tol, f"ssm {dtype}", failures)
        out[dtype] = {"max_abs_err": errs, "logit_scale": scales, "tol": tol,
                      "launches": launches}
    phase("ssm", arch=cfg.name, batch=SSM["batch"], prompt=SSM["prompt"],
          decode=SSM["decode"], **out)


# -- phases 10-11: dense check, MoE -----------------------------------------


def dense_check(dev, ctx: dict, failures: list) -> None:
    """One microbatch of the dense run's model (its trained parameters)
    through the kernel, as the run takes it, against the same microbatch
    with attention swapped for ``attention_ref`` where ``models/layers.py``
    calls the op: the loss and the global grad norm."""
    from unittest import mock

    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import build_model
    from repro_torch.models import layers
    from repro_torch.tree import leaves

    cfg, run, params = ctx["cfg"], ctx["run"], ctx["state"].params
    model = build_model(cfg)
    mb = run["batch"] // run["grad_accum"]
    src = SyntheticTokens(cfg.vocab_size, run["seq"], run["batch"],
                          seed=run["seed"])
    batch = {k: torch.as_tensor(v[:mb], device=dev)
             for k, v in src.batch_at(0).items()}

    def loss_and_grad_norm():
        flat = leaves(params)
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, flat)
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        return float(loss.detach()), float(norm)

    def plain(q, k, v, *, causal=True, q_offset=None, kv_len=None,
              sm_scale=None):
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, sm_scale=sm_scale)

    fa_ops.LAUNCHES.reset()
    kern = loss_and_grad_norm()
    n_kernel = fa_ops.LAUNCHES.count
    with mock.patch.object(layers, "flash_attention", plain):
        ref = loss_and_grad_norm()
    n_plain = fa_ops.LAUNCHES.count - n_kernel
    want = train_launches(cfg, 1)["flash_attention"]
    if n_kernel != want or n_plain != 0:
        failures.append(f"dense-check: {n_kernel} kernel launches through "
                        f"the kernel (expected {want}), {n_plain} with "
                        "attention_ref (expected 0)")
    rel = [abs(a - b) / abs(b) for a, b in zip(kern, ref)]
    if not all(math.isfinite(x) for x in kern + ref) or max(rel) > \
            DENSE_CHECK_TOL:
        failures.append(f"dense-check: loss and grad norm {kern} through "
                        f"the kernel, {ref} through attention_ref (relative "
                        f"{rel}, tolerance {DENSE_CHECK_TOL})")
    phase("dense-check", arch=cfg.name, microbatch=[mb, run["seq"]],
          kernel={"loss": kern[0], "grad_norm": kern[1]},
          attention_ref={"loss": ref[0], "grad_norm": ref[1]},
          rel_err={"loss": rel[0], "grad_norm": rel[1]},
          tol=DENSE_CHECK_TOL, flash_launches=n_kernel)


def moe_phase(dev, failures: list) -> dict:
    """The moe_qwen3 variant: 3 train steps (finite losses, aux > 0,
    launches asserted), then prefill and decode against the whole-sequence
    prefill on the trained parameters.  Capacity dispatch keeps a token or
    drops it by how many tokens share its group, so a decode step (one token
    a row) and a whole-sequence prefill (groups of 32) may keep different
    tokens where the capacity binds: the check runs at a capacity factor of
    E / k, where no group can overflow an expert (C >= group)."""
    import dataclasses

    from repro_torch.launch.sim_accuracy import smoke_config
    from repro_torch.models import build_model

    cfg = smoke_config(MOE_ARCH)
    ctx = train_phase(dev, failures, cfg, MOE, "moe-train")
    auxes = [r["aux"] for r in ctx["steps"]]
    if not all(math.isfinite(a) and a > 0 for a in auxes):
        failures.append(f"moe: aux losses {auxes}, expected finite and > 0")
    moe = cfg.moe
    roomy = dataclasses.replace(
        cfg, moe=dataclasses.replace(
            moe, capacity_factor=moe.num_experts / moe.top_k))
    d = MOE_DECODE
    gen = torch.Generator(device=dev).manual_seed(d["seed"])
    tokens = torch.randint(1, cfg.vocab_size,
                           (d["batch"], d["prompt"] + d["decode"]),
                           generator=gen, device=dev)
    calls = 1 + 2 * d["decode"]     # prefills and decode steps
    want = {"ssd_scan": 0, "flash_attention": calls * cfg.num_layers,
            "rmsnorm": calls * (2 * cfg.num_layers + 1)}
    counters = kernel_counters()
    # this path's run: counts from zero, read right after
    for c in counters.values():
        c.reset()
    errs, scales = decode_against_prefill(
        build_model(roomy), ctx["state"].params, tokens, d["prompt"],
        d["decode"], "moe", failures)
    launches = {k: c.count for k, c in counters.items()}
    if launches != want:
        failures.append(f"moe decode: launches {launches}, expected {want}")
    check_decode_errors(errs, scales, d["tol"], "moe", failures)
    phase("moe", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
          experts=moe.num_experts, top_k=moe.top_k, aux=auxes,
          decode={**d, "capacity_factor": roomy.moe.capacity_factor,
                  "max_abs_err": errs, "logit_scale": scales,
                  "launches": launches})
    return ctx


# -- phases 8 and 12: the simulator's train-step loop ---------------------------


def simtrain_phase(dev, cfg, seq: int, batch: int, failures: list) -> dict:
    from repro_torch.launch.sim_accuracy import run

    row = run(cfg, seq=seq, batch=batch, steps=SIMTRAIN["steps"],
              profile_repeats=SIMTRAIN["repeats"], device=dev,
              log_fn=lambda _: None)
    if not (row["measured_s"] > 0 and math.isfinite(row["sim_offline_s"])
            and math.isfinite(row["sim_refined_s"])):
        failures.append(f"simtrain {row['name']}: measured "
                        f"{row['measured_s']}, simulated "
                        f"{row['sim_offline_s']} / {row['sim_refined_s']}")
    # one step without grad_accum: each kernel op is one node of the traced
    # graph and one launch of the real step, forward and remat recompute
    want = train_launches(cfg, grad_accum=1)
    if not (row["graph_kernel_nodes"] == want
            and row["kernel_launches_per_step"] == want):
        failures.append(f"simtrain {row['name']}: kernel nodes "
                        f"{row['graph_kernel_nodes']}, launches per step "
                        f"{row['kernel_launches_per_step']}, expected {want}")
    phase("simtrain", **row)
    return row


def dense_kernel_table(dev, gen, ctx: dict, failures: list) -> list:
    """The kernels at the dense and MoE train paths' shapes: RMSNorm and
    flash attention of one llama3.2-1b microbatch, flash attention of the
    moe_qwen3 variant's batch; launches from the dense-train and moe-train
    runs (None where no path was driven)."""
    from repro_torch.configs.base import get_config

    cfg, chip = get_config(DENSE_ARCH), ctx["platform"].chip

    def counts(run: str, kernel: str, steps: int):
        c = ctx[run]
        return (None, None) if c is None else (c[kernel], c[kernel] / steps)

    b, s = DENSE["batch"] // DENSE["grad_accum"], DENSE["seq"]
    return [
        rmsnorm_row(dev, gen, chip, "rmsnorm@dense-train", (b, s, cfg.d_model),
                    cfg.norm_eps, *counts("dense", "rmsnorm", DENSE["steps"]),
                    failures),
        flash_train_row(dev, gen, chip, "dense-train",
                        *counts("dense", "flash_attention", DENSE["steps"]),
                        failures),
        flash_train_row(dev, gen, chip, "moe_qwen3",
                        *counts("moe", "flash_attention", MOE["steps"]),
                        failures)]


def kernels_only(dev, gen, failures: list, ptxas: dict) -> list:
    """``--only kernels``: the kernel rows at the serve and train shapes
    without driving the paths, so every launch field is null."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.hardware import platform_for_device
    from repro_torch.serve.policy import ServeConfig
    from repro_torch.serve.trace import poisson_trace

    platform = platform_for_device(torch.cuda.get_device_name(dev))
    trace = poisson_trace(TRACE["n"], TRACE["rate"],
                          prompt_lens=TRACE["prompt_lens"],
                          max_new_tokens=TRACE["max_new_tokens"],
                          seed=TRACE["seed"])
    table = kernel_table(dev, gen, {
        "cfg": get_config(ARCH), "scfg": ServeConfig(**SERVE),
        "platform": platform, "trace": trace, "launches": None,
        "forward_calls": None})
    table += train_kernel_table(dev, gen, {
        "cfg": get_config(TRAIN_ARCH), "platform": platform,
        "launches": None, "ptxas": ptxas}, failures)
    return table + dense_kernel_table(dev, gen, {
        "platform": platform, "dense": None, "moe": None}, failures)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("kernels",),
                    help="build, check and time the kernels alone (no "
                         "serve or train run, no launch counts, no ok line)")
    args = ap.parse_args()
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
    logs = _build.build_all(["rmsnorm", "flash_attention", "ssd_scan"])
    ptxas = ptxas_summary(logs)
    phase("build", seconds=time.perf_counter() - t0,
          flags=" ".join(_build.NVCC_FLAGS), ptxas=ptxas)

    failures: list[str] = []
    gen = torch.Generator(device=dev).manual_seed(0)
    check_kernels(dev, gen, failures)
    if args.only == "kernels":
        print(json.dumps({"kernels": kernels_only(dev, gen, failures,
                                                  ptxas)}), flush=True)
        for f in failures:
            print(f"FAIL {f}", flush=True)
        return 1 if failures else 0
    ctx = serve(dev, failures)
    profile_decode(dev, ctx)
    context_effect(dev, ctx)
    table = kernel_table(dev, gen, ctx)
    del ctx
    torch.cuda.empty_cache()

    from repro_torch.configs.base import get_config
    from repro_torch.launch.sim_accuracy import smoke_config

    tctx = train_phase(dev, failures, get_config(TRAIN_ARCH), TRAIN, "train")
    profile_train_step(dev, tctx, "train-profile")
    tctx["state"] = tctx["state"]._replace(opt_state=None)
    ssm_phase(dev, tctx, failures)
    tctx["ptxas"] = ptxas
    table += train_kernel_table(dev, gen, tctx, failures)
    cfg, platform = tctx["cfg"], tctx["platform"]
    del tctx
    torch.cuda.empty_cache()
    simtrain_phase(dev, cfg, SIMTRAIN["seq"], SIMTRAIN["batch"], failures)

    dctx = train_phase(dev, failures, get_config(DENSE_ARCH), DENSE,
                       "dense-train")
    profile_train_step(dev, dctx, "dense-train-profile")
    dense_check(dev, dctx, failures)
    dense_cfg, dense_launches = dctx["cfg"], dctx["launches"]
    del dctx
    torch.cuda.empty_cache()
    moe_launches = moe_phase(dev, failures)["launches"]
    table += dense_kernel_table(dev, gen, {
        "platform": platform, "dense": dense_launches,
        "moe": moe_launches}, failures)
    torch.cuda.empty_cache()
    simtrain_phase(dev, dense_cfg, DENSE["seq"],
                   DENSE["batch"] // DENSE["grad_accum"], failures)
    simtrain_phase(dev, smoke_config(MOE_ARCH), MOE["seq"], MOE["batch"],
                   failures)
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
