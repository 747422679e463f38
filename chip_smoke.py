#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels   # build, check and time the kernels
    python3 chip_smoke.py --only pp        # kernels' checks, then the
                                           # remat and pp phases
    python3 chip_smoke.py --only ep        # kernels' checks, then the
                                           # expert-parallel phases
    python3 chip_smoke.py --only obs       # kernels' checks, then the
                                           # sharded decode, the launchers'
                                           # --obs / --analyze, pp-train
    python3 chip_smoke.py --only ckpt      # kernels' checks, then
                                           # checkpoint and resume
    python3 chip_smoke.py --only netprof   # kernels' checks, then the
                                           # collective sweep
    python3 chip_smoke.py --only int8kv    # kernels' checks, then the
                                           # int8 KV cache
    python3 chip_smoke.py --only roofline  # kernels' checks, then the two
                                           # simtrain rows and their roofline
    python3 chip_smoke.py --only dryrun    # kernels' checks, then the dry
                                           # run's cells and its check
    python3 chip_smoke.py --only bench     # kernels' checks, then the
                                           # port's bench gate's rows

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
             the benchmark's variant (4 and 9); each row's measured step is
             the median of 5 steps timed one by one, with their minimum,
             maximum and the card's busy time of one more step;
13. moe-serve — qwen3-moe-235b-a22b at its published widths (d_model 4096,
             64/4 heads of 128, 128 experts top-8 of 1536, capacity 1.25,
             groups of 512, vocab 151,936; 4 of its 94 layers, random
             weights) through phase 4's serve path (calibrate, engine,
             twins; launches asserted), a profiled decode step, and two of
             the trace's requests prefilled chunk by chunk and decoded
             together against the sequential ``Model.prefill``/``decode``
             at a capacity no dispatch group can overflow (``moe-serve-
             check``);
14. jamba   — one whole period of jamba-1.5-large-398b (1 attention : 7
             mamba, MoE 16 experts top-2 on every other layer, 64/8 heads of
             128, d_state 128, vocab 65,536) with d_model cut to 1024 and
             the FFNs to 3072: 3 train steps at seq 2048, batch 4 (2 flash,
             14 SSD and 33 RMSNorm launches a step asserted, aux > 0), then
             a 512-token prefill and 8 decode steps against the whole-
             sequence prefill in fp32 at a capacity no group overflows;
15. encdec-train — seamless-m4t-large-v2 at its published widths and depth
             (24 + 24 layers, d_model 1024, 16 heads of 64, d_ff 8192, vocab
             256,206, untied head; fp32 master weights, bf16 compute,
             AdamW): seq 2048 with frames of 2048, batch 8, grad_accum 2, 3
             steps (288 flash and 484 RMSNorm launches a step asserted), and
             one more step under torch.profiler;
16. encdec-check — one microbatch through the kernel against
             ``attention_ref``, as phase 10;
17. encdec-decode — a prefill of ``source_len`` (4096) frames and a 64-token
             prefix, then 8 decode steps, each against the whole-sequence
             prefill in fp32 (launches asserted);
18. remat-dots — llama3.2-1b at full width and depth: one microbatch's
             loss and gradient under the "none", "full" and "dots" remat
             with the aten ops counted (the backward's ``aten.mm`` under
             "dots" equals "none"'s: no projection recomputed; fewer than
             "full"'s), then one step under "full" and one under "dots" from
             the same weights (loss and grad norm within 2e-2; step time and
             peak memory of each).  Phases 6, 9 and 15 run the "dots" remat
             of their configs;
19. pp-train — llama3.2-1b at full width and depth through
             ``launch.train.train`` on 4 logical ranks of the one card: pp=2
             x dp=2, 1F1B, int8 gradient compression with error feedback, the
             [dense-train] tokens (8 x 2048, 4 microbatches of 1 x 2048 a data
             rank), a warm-up step and 3 timed ones: per step the loss, times,
             tokens/s, peak memory and launches (256 flash attentions and 520
             RMSNorms asserted), the launcher's plan and parity lines, the
             bytes the executor moved; then one more step under
             torch.profiler (``pp-train-profile``).  The ranks share the card
             and run one after another: the step time is not a multi-card
             time;
20. pp-check — the same step without compression against the unpipelined
             step (grad_accum 4) on the same weights and tokens, under 1F1B,
             GPipe and interleaved 1F1B (2 virtual stages a rank), each from
             a fresh optimizer state: loss and grad norm within 1e-4, every
             gradient leaf and every layer's row within 1e-3 (``PP_CHECK_TOL``);
21. pp-plan, pp-parity — one layer profiled on the card into the dense
             simtrain row's ProfileDB; the [pp-train] strategy's
             ``model_pipeline_graph`` priced from it (a chunk of n layers as
             n times the layer) on 4 H100 SXM and simulated; its boundary and
             all-reduce bytes held exactly against the executor's twins and
             the bytes [pp-train] moved;
22. autotune — the (dp x pp x microbatch x schedule) candidates for
             llama3.2-1b on 8 H100 SXM from the card-profiled layer cost,
             every chunk priced from the measured layer: the top 5
             (simulated);
23. ep-train — qwen3-moe-235b-a22b at its published widths, 2 of its 94
             layers (bf16 parameters, Adafactor, "full" remat, 128 experts
             top-8, capacity factor 1.25, groups of 512; grad_accum cut 8 ->
             1) through ``launch.train.train`` with ``impl="ep_a2a"`` on a
             (data 4 x model 1) mesh of 4 logical ranks of the card: tokens
             (4, 2048), 3 steps (4 flash and 9 RMSNorm launches a step, aux
             > 0, every MoE call through EP asserted), the peak memory and
             the bytes the all-to-alls moved; then one more step under
             torch.profiler (``ep-train-profile``: the exchanges' device
             time under the ``dist.all_to_all`` range);
24. ep-check — the run's weights and first batch through EP and through
             the einsum path (no update): EP in the forward and the
             recompute, loss and aux within 1e-3, every gradient leaf
             within 2e-2 (relative L2); the FFN alone at full width on
             (4, 1) and (2, 2) meshes against the einsum path;
25. ep-parity — the all-to-all bytes of a forward pass, executed = twin =
             simulated (2,684,354,560), and a train step's (twice: the
             recompute);
26. ep-plan — the EP layer profiled on the card, the cell's strategy
             simulated on 4 H100 SXM with its all-to-all share;
27. serve-shard — phase 4's model, trace and engine shape with the decode
             slot-sharded over 4 logical ranks of the card (2 of the 8
             slots a rank, each rank's decode a forward, in turn):
             ``calibrate_serve(mesh=)`` (two passes), the engine (launches
             asserted), the replay twin (compositions equal) and the
             priced twin; the sharded decode's logits against the
             unsharded decode's on one fixed mid-run batch (limit
             ``SHARD["tol"]`` of the logits' scale; argmax equal where the
             top-2 margin exceeds the error), both beside the fp32 decode;
28. serve-obs — the serve launcher (``main(argv)``) on that trace and DB
             with ``--shard --ranks 4 --obs --trace-out --parity``: the
             divergence report (no unmatched span or node), its provenance
             classes, the overlay parsed as a Chrome trace, compositions
             equal;
29. serve-analyze — the launcher's ``--analyze`` on the same trace and DB:
             no error-level finding;
30. serve-shard-profile — the decode step's host wall and the card's busy
             time, unsharded and sharded (after the launcher phases: a
             profiler session slows later launches);
31. pp-analyze, pp-obs — phase 19 runs with the launcher's ``--analyze``
             (the plan verified before the first step) and ``--obs``
             (after the last: every F, B, send and gradAR node of the
             plan replayed on the card under its uid, none skipped, the
             divergence report and the overlay; the replay's launches
             counted apart from the steps');
32. ckpt    — llama3.2-1b at full width and depth through
             ``launch.train.train`` with a checkpoint directory (the
             [dense-train] shape, AdamW): (A) 2 steps into a fresh
             directory, (B) the same directory to step 4, restored from
             step 2, (C) 4 steps with no directory; B's losses of steps 3-4
             and its final parameters and moments against C's, bit for bit
             (``CKPT``); the checkpoint's bytes (14,829,772,808), the
             blocking snapshot, the background write, the restore and the
             disk's free space, checked first (launches asserted as phase 9;
             the directory removed after);
33. ft      — that run's heartbeat file and the straggler policy's verdict
             on each step;
34. netprof — the collective sweep over 4 logical ranks of the card: all
             five kinds in fp32, bf16 and int8, on the flat mesh and the
             2 x 2 sub-axes, 4 KiB .. 256 MiB (``NETPROF``), and the
             concurrent sweep; the entries by kind and group, the fitted
             latency and wire rate; ``calibrate --verify`` on the saved DB;
             the acceptance graph and phase 21's pp = 2 x dp = 2 plan priced
             from it against the H100 SXM data sheet's NVLink ring, and the
             train launcher's plan and parity reports with ``--netprof-db``,
             every collective node priced from measurements.  The ranks
             share the card: the measurements are device-local copies, not
             NVLink times;
35. int8-kv — llama3.2-1b at full width and depth (random seeded weights,
             fp32 masters cast once to bf16 as serving does) through the
             non-paged ``Model.prefill`` of 1024 seeded tokens a row and 64
             greedy decode steps, batch 8, a 2048-position cache, once with
             the bf16 cache and once with ``kv_cache_dtype="int8"`` (fed the
             bf16 run's tokens): the caches' bytes (536,870,912 and
             276,824,064, exact), the int8 logits against the bf16 logits
             at every step (limit 5 % of their scale, the JAX package's own
             bound) and the greedy tokens that agree, the card's quantiser
             against the CPU's on the k/v bits the prefill quantised (bit
             for bit), 16 flash and 33 RMSNorm launches a forward; then
             ``int8-kv-step``: a decode step at mid-run length with each
             cache (A B B A), host and CUDA-event ms, busy ms and launches of
             profiled steps, and the dequantising read of one layer alone
             beside its eager traffic;
36. roofline — the ``dense_llama`` and ``ssm_mamba2`` simtrain rows' traced
             steps (phases 8 and 12, 2 x 2048) through the copy of
             ``core/roofline.py`` at the H100 SXM: its row, the fraction at
             the H100's peak beside the copy's v5e one (ROADMAP C17), the
             measured step and busy time, the bound's share of the busy
             time, the graph's contractions at their dtype's rate; the
             terms finite and positive (collective 0 on one card) and the
             model flops 6 N tokens gated;
37. dryrun — the port's dry run (``launch/dryrun.py``) at full configs on the
             production (16, 16) mesh, each cell's rank program traced on
             fake CUDA tensors in a process of its own (the card visible,
             nothing allocated on it), all started together: llama3.2-1b train_4k, prefill_32k and
             decode_32k, phi4-mini-3.8b train_4k baseline and ``seqpar``,
             qwen3-moe prefill_32k (FSDP, experts); per cell the status,
             a rank's argument and temp bytes, flops, ICI/DCN collective
             bytes, the roofline row at the H100 SXM with the fraction at
             its peak, the drops and the seconds; gated: status ``ok``,
             the arguments equal to the shard bytes recomputed here, every
             term finite and not negative;
38. dryrun-check — the dry run against the card on a 1-rank mesh, at
             llama3.2-1b's full width: the train cell of phase 9 (seq
             2048, batch 8, grad_accum 4) and the bf16 decode cell of phase
             35 (batch 8, 2048 positions); the predicted arguments against
             the allocated state, batch, weights, cache and token, byte for
             byte (and the int8 cache's), the traced graph's kernel nodes
             against the launches of one real step (the path: counts from
             zero before it), and the predicted peak (arguments + traced
             temp) beside ``max_memory_allocated`` of that step (not gated);
39. bench-gate — the port's bench gate (``scripts/bench_gate_port.py``):
             its 52 deterministic rows (schedule ticks, the serve twin and
             coverage audit on the acceptance trace, the overlap pins, the
             pipeline byte twins, the netprof fit) against the JAX package's
             ``benchmarks/baselines/bench_baseline.json`` within their bands;
             its executor rows on the card: the tiny 4-layer llama (fp32)
             through interleaved 1F1B on a 1-rank mesh from a seeded init,
             every gradient leaf against autograd of the unpipelined
             reference within the baseline's band (the loss printed beside
             the baseline's, not held: another init), 16 flash and 34
             RMSNorm launches asserted;
40. a JSON line of every kernel at the serve and train shapes: launches on
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

Phase 3 also holds flash attention at the train and decode paths' shapes
(``FLASH_TRAIN``: llama3.2-1b's microbatch in bf16, the moe_qwen3 variant's
in fp32, jamba's 64/8 heads of 128, seamless-m4t's non-causal encoder and
cross-attention, its causal decoder and a decode step's cross-attention over
4096 frames; no masks) against its plain version, prints the bf16 launch
plan, and runs ``torch.library.opcheck`` on the op on the card.  The kernel
rows of every path hold their kernel against its plain version again.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 2e-2        # tests/test_kernels.py::tol for bfloat16
FP32_TOL = 2e-5        # ... and for float32
# bf16 attention: outputs over 1-2k keys are only ~0.03-0.05 here, so 2e-2
# would pass a dropped tile; 4x the worst error measured on the H100 (1e-3).
# Held against the plain version's fp32 output (``attention_plain``)
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
# profiler ranges: the train step's phases, the kernel ops and the
# collectives' exchanges (``dist.all_to_all``)
RANGES = ("train_step.", "repro_torch::", "dist.")
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
SIMTRAIN = dict(seq=2048, batch=2, steps=5, repeats=5)
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
# flash attention at the train and decode paths' shapes ((B, Sq, Skv, H, K,
# D), dtype, tolerance, causal; no masks): one microbatch of llama3.2-1b, the
# moe_qwen3 variant's batch, one microbatch of the jamba variant (64/8 heads
# of 128), one microbatch of seamless-m4t (its encoder and cross-attention
# see every key, its decoder self-attention is causal) and a seamless decode
# step's cross-attention over the 4096-frame memory (fp32, as the decode
# check runs it)
FLASH_TRAIN = {"dense-train": ((2, 2048, 2048, 32, 8, 64), torch.bfloat16,
                               ATTN_BF16_TOL, True),
               "moe_qwen3": ((8, 128, 128, 8, 4, 32), torch.float32, FP32_TOL,
                             True),
               "jamba-train": ((4, 2048, 2048, 64, 8, 128), torch.bfloat16,
                               ATTN_BF16_TOL, True),
               "encdec-train-encoder-cross": ((4, 2048, 2048, 16, 16, 64),
                                              torch.bfloat16, ATTN_BF16_TOL,
                                              False),
               "encdec-train-decoder-self": ((4, 2048, 2048, 16, 16, 64),
                                             torch.bfloat16, ATTN_BF16_TOL,
                                             True),
               "encdec-decode-cross": ((2, 1, 4096, 16, 16, 64), torch.float32,
                                       FP32_TOL, False),
               "pp-train": ((1, 2048, 2048, 32, 8, 64), torch.bfloat16,
                            ATTN_BF16_TOL, True),
               "ep-train": ((4, 2048, 2048, 64, 4, 128), torch.bfloat16,
                            ATTN_BF16_TOL, True),
               "ckpt-train": ((2, 2048, 2048, 32, 8, 64), torch.bfloat16,
                              ATTN_BF16_TOL, True),
               "int8kv-prefill": ((8, 1024, 1024, 32, 8, 64), torch.bfloat16,
                                  ATTN_BF16_TOL, True),
               "dryrun-check-train": ((2, 2048, 2048, 32, 8, 64),
                                      torch.bfloat16, ATTN_BF16_TOL, True),
               "bench-exec": ((2, 16, 16, 2, 2, 32), torch.float32, FP32_TOL,
                              True)}
# [moe-serve]: qwen3-moe-235b-a22b at its published widths, 4 of its 94
# layers (every layer is MoE, so one whole period), through the llama serve
# phase's engine, trace and twin; then two of the trace's requests prefilled
# chunk by chunk and decoded together against the sequential decode, at a
# capacity no dispatch group can overflow (bf16: the serve check's limit)
MOE_SERVE = dict(arch="qwen3-moe-235b-a22b", layers=4, decode=8)
# [jamba]: one whole period of jamba-1.5-large-398b (1 attention : 7 mamba,
# MoE on every other layer, 64/8 heads of 128, 16 experts top-2, mamba head
# 64, d_state 128, chunk 256, vocab 65,536, adafactor, full remat), d_model
# cut to 1024 and d_ff to 3 x 1024; 3 steps at seq 2048, batch 4
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA = dict(seq=2048, batch=4, grad_accum=1, steps=3, seed=0)
JAMBA_DECODE = dict(batch=2, prompt=512, decode=8, seed=1, tol=1e-3)
# [encdec-*]: seamless-m4t-large-v2 at its published widths and depth (24 +
# 24 layers, d_model 1024, 16 heads of 64, d_ff 8192, vocab 256,206, untied
# head, fp32 master weights, bf16 compute, AdamW); frames as long as the
# tokens; the config's grad_accum (2).  Decode: the source_len (4096) frames
# and a 64-token prefix, 8 steps against the whole-sequence prefill in fp32
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC = dict(seq=2048, batch=8, grad_accum=2, steps=3, seed=0)
ENCDEC_DECODE = dict(batch=2, prompt=64, decode=8, seed=1, tol=1e-3)
# [pp-*]: llama3.2-1b at full width and depth on 4 logical ranks of the one
# card, pp=2 x dp=2, 1F1B, int8 compression with error feedback: the
# [dense-train] tokens (a global batch of 8 x 2048), each data rank 4
# microbatches of 1 x 2048; a warm-up step and 3 timed ones
PP = dict(seq=2048, batch=8, pp=2, dp=2, microbatches=4, schedule="1f1b",
          compression="int8", steps=4, seed=0)
# [ep-*]: qwen3-moe-235b-a22b at its published widths (d_model 4096, 64/4
# heads of 128, 128 experts top-8 of width 1536, capacity factor 1.25,
# groups of 512, vocab 151,936, untied head; bf16 parameters, Adafactor,
# "full" remat), impl="ep_a2a" on a (data 4 x model 1) mesh of 4 logical
# ranks of the one card.  Cut: depth 94 -> 2, grad_accum 8 -> 1.  Tokens
# (4, 2048) from the synthetic pipeline: each rank's 2048 tokens are 4 of the
# 16 global groups, C = 40 slots an expert; 3 steps
EP_ARCH, EP_LAYERS = "qwen3-moe-235b-a22b", 2
EP = dict(seq=2048, batch=4, ranks=4, grad_accum=1, steps=3, seed=0)
EP_REDUCED = {"num_layers": "94 -> 2", "grad_accum": "8 -> 1"}
# [ep-check]: EP against the einsum path on the same weights and tokens:
# the loss and aux relative 1e-3; each gradient leaf's relative L2
# difference, and the FFN alone's output's, within the reference's bf16
# tolerance (both paths route in fp32 on matmuls of other shapes, so a
# near-tie can flip a token's choice: a relative norm, not a max)
EP_CHECK_TOL = {"scalar": 1e-3, "grad": BF16_TOL, "ffn": BF16_TOL}
# [ep-check] FFN alone: one layer's experts on x (4, 2048, 4096) bf16
EP_FFN_MESHES = ((4, 1), (2, 2))
# [ep-parity]: the all-to-all bytes of one forward pass: 2 layers x 2
# exchanges (dispatch, return) x 4 ranks x one rank's payload of 128
# experts x 4 groups x 40 slots x 4096 x 2 bytes (bf16)
EP_A2A_FORWARD_BYTES = 2 * 2 * 4 * 167_772_160
# [serve-shard]: the serve cell with its decode slot-sharded over 4 logical
# ranks of the card (2 of the 8 slots a rank).  Its logits against the
# unsharded decode's on one fixed mid-run batch (the pool's K/V and the
# tokens drawn from ``seed``), and both against the same decode in fp32
# compute; limit relative to the logits' scale: twice the largest error
# measured on the H100 (1.75 % of the scale, sharded against unsharded:
# 2-row and 8-row bf16 GEMMs take other cuBLAS kernels through 16 layers);
# the decode step's busy and wall time over ``steps`` steps, sharded and
# not, measured after the launcher phases (a torch.profiler session slows
# the host's later launches)
SHARD = dict(ranks=4, tol=4e-2, seed=2, steps=5)
# [autotune]: llama3.2-1b on 8 H100 SXM at PP's global batch; the layer is
# profiled on the card at every microbatch size a candidate can have
AUTOTUNE = dict(chips=8, micro_batches=(1, 2, 4, 8))
# [pp-check]: the pipelined steps against the unpipelined one on the same
# weights and tokens.  "scalar": the loss and grad norm, relative; "grad",
# by the reference's grad_accum: the relative norm of the difference of
# every gradient leaf and of every layer's row of a block leaf.  Measured on
# the H100 (PERF.md): scalars 9.3e-7, gradients 7.1e-8 against grad_accum 8
# and 2.1e-3 against grad_accum 4; a dropped microbatch of the eight moves
# a gradient by about an eighth or more
PP_CHECK_TOL = {"scalar": 1e-4, "grad": {8: 1e-5, 4: 2e-2}}
# [ckpt]: llama3.2-1b at full width and depth through ``launch.train.train``
# with a checkpoint directory, the [dense-train] run's shape (seq 2048,
# batch 8, grad_accum 4, AdamW): (A) ``first`` steps into a fresh
# directory, (B) the same directory to ``steps`` (it restores step
# ``first``), (C) ``steps`` steps with no directory.  B's losses after the
# restore and its final parameters and moments must equal C's bit for bit;
# if two uninterrupted runs (C and one more) already differ, B is held to
# ``spread_factor`` times their measured spread instead
CKPT = dict(DENSE, steps=4, first=2, spread_factor=2.0)
# [netprof]: the collective sweep over 4 logical ranks of the card: the five
# kinds in fp32, bf16 and int8, on the flat mesh and the 2 x 2 sub-axes, 5
# samples a point (the median recorded); the concurrent sweep (2 streams,
# fp32, the default payloads) beside it.  Payloads: the sweep's default 4
# KiB .. 4 MiB and on to 256 MiB: up to 4 MiB a collective of ranks sharing
# the card costs the same at every payload (its launches and the host
# loop; measured on the H100), so the copies' rate shows only above it, and
# the pp x dp plan reduces 749 MB a stage
NETPROF = dict(ranks=4, dtypes=("float32", "bfloat16", "int8"), repeats=5,
               streams=2, payload_bytes=tuple(2**p for p in range(12, 29, 2)))
# [int8-kv]: llama3.2-1b at full width and depth, non-paged prefill of 1024
# seeded tokens a row and 64 decode steps, batch 8, a 2048-position cache,
# bf16 and int8; the int8 logits within 5 % of the bf16 logits' scale (the
# JAX package's own bound, tests/test_models_smoke.py); the decode step
# timed over ``steps`` calls (half in each of the A B B A runs) and
# profiled over ``profiled``
INT8KV = dict(arch="llama3.2-1b", batch=8, prompt=1024, max_len=2048,
              decode=64, seed=3, gap_tol=0.05, steps=20, profiled=5)
# the caches' bytes by arithmetic: k and v, 16 layers, (8, 2048, 8, 64)
# values; int8 adds a bf16 scale a (position, kv head)
INT8KV_BYTES = {"bfloat16": 2 * 16 * 8 * 2048 * 8 * 64 * 2,
                "int8": 2 * 16 * (8 * 2048 * 8 * 64 + 8 * 2048 * 8 * 2)}


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


def attention_plain(q, k, v, **kw) -> torch.Tensor:
    """The plain version (``attention_ref``) on the same inputs, its output
    left in fp32: what a bf16 kernel output is held against (the rows also
    give the kernel against the plain output rounded to the inputs' dtype,
    ``max_abs_err_vs_plain_rounded``).  The kernel
    rounds its fp32 result to bf16 once; the plain version's own bf16 output
    is a second, independent rounding, and the two differ by a whole ulp
    (0.0156 for |o| in [2, 4), where causal rows that see few keys lie)
    wherever their fp32 values straddle a rounding boundary."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    return attention_ref(q.float(), k.float(), v.float(), **kw)


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
                            attention_plain(q, k, v, **kw), attn_tol,
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
    for label, ((b, sq, skv, h, kh, d), dtype, tol, causal) in \
            FLASH_TRAIN.items():
        q = rand(b, sq, h, d, dtype=dtype)
        k, v = (rand(b, skv, kh, d, dtype=dtype) for _ in range(2))
        dt_name = "bf16" if dtype == torch.bfloat16 else "fp32"
        results.append((f"attention train {label} {dtype}",
                        flash_attention(q, k, v, causal=causal),
                        attention_plain(q, k, v, causal=causal), tol,
                        f"attention {dt_name}"))
        del q, k, v
    b, s, _, h, kh, d = FLASH_TRAIN["dense-train"][0]
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


def serve_trace():
    """The serve cell's open-loop Poisson trace (``TRACE``)."""
    from repro_torch.serve.trace import poisson_trace

    return poisson_trace(TRACE["n"], TRACE["rate"],
                         prompt_lens=TRACE["prompt_lens"],
                         max_new_tokens=TRACE["max_new_tokens"],
                         seed=TRACE["seed"])


def trace_context(trace, scfg) -> int:
    """The mean context of the trace's decode tokens, where the steps are
    timed: the attention kernel's work follows the context, and at 0 (the
    JAX package's choice) a decode step does almost no attention."""
    import numpy as np

    return round(float(np.mean([
        t.prompt_len + i for t in trace
        for i in range(scfg.effective_max_tokens(t.prompt_len,
                                                 t.max_new_tokens))])))


def serve(dev, failures: list, cfg, tag: str = "serve") -> dict:
    """``cfg`` served at full width (calibrate, engine, twins), as the
    ``serve`` phase describes; for a dense model also its chunked prefill
    against the whole-prompt prefill (an MoE model's is checked apart, by
    ``moe_serve_check``: its capacity depends on the tokens of a call)."""
    import numpy as np

    from repro_torch.core.database import ProfileDB
    from repro_torch.core.estimator import OpTimeEstimator
    from repro_torch.core.hardware import platform_for_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models import build_model
    from repro_torch.netprof.pricing import graph_provenance
    from repro_torch.serve.cost import calibrate_serve
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.policy import ServeConfig
    from repro_torch.serve.report import (
        latency_report, records_from_requests, serve_parity_report,
    )
    from repro_torch.serve.sim import replay_schedule, simulate_serve
    from repro_torch.serve.trace import prompt_tokens

    platform = platform_for_device(torch.cuda.get_device_name(dev))
    scfg = ServeConfig(**SERVE)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    trace = serve_trace()
    context = trace_context(trace, scfg)

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

    prefill_check = None
    if cfg.moe is None:
        prefill_check = chunked_prefill_check(dev, model, engine.params, trace,
                                              scfg, failures)

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

    phase(tag, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
          platform=platform.name, serve=SERVE,
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
          prefill_logits=prefill_check)
    return {"launches": launches, "forward_calls": forwards,
            "platform": platform, "trace": trace, "cfg": cfg, "scfg": scfg,
            "params": engine.params}


def prefill_in_chunks(dev, params, pool, prompt, table, cfg, scfg):
    """``prompt`` through ``paged.prefill_chunk`` chunk by chunk into
    ``pool`` on the blocks of ``table``, as the engine runs it: the last
    chunk's logits."""
    import numpy as np

    from repro_torch.serve import paged

    start = 0
    while start < len(prompt):
        width = min(scfg.chunk, len(prompt) - start)
        toks = np.zeros((1, scfg.bucket(width)), np.int32)
        toks[0, :width] = prompt[start:start + width]
        logits, pool = paged.prefill_chunk(
            params, pool, torch.as_tensor(toks, device=dev), start, width,
            table, 0, cfg, scfg)
        start += width
    return logits


def chunked_prefill_check(dev, model, params, trace, scfg,
                          failures: list) -> dict:
    """The engine's chunked prefill (paged functions, fresh pool) against
    the whole-prompt ``Model.prefill``, for the first request of several
    chunks."""
    from repro_torch.serve import paged
    from repro_torch.serve.trace import prompt_tokens

    cfg = model.cfg
    req = next(t for t in trace if t.prompt_len > scfg.chunk)
    prompt = prompt_tokens(req, cfg.vocab_size)
    row = torch.arange(1, scfg.max_blocks_per_slot + 1, dtype=torch.int32,
                       device=dev)
    with torch.inference_mode():
        chunked = prefill_in_chunks(dev, params,
                                    paged.init_pool(cfg, scfg, dev), prompt,
                                    row, cfg, scfg)
        whole, _ = model.prefill(params,
                                 torch.as_tensor(prompt[None], device=dev))
    torch.cuda.synchronize()
    ref_scale = float(whole.abs().max())
    logit_err = max_err(chunked, whole)
    if not (torch.isfinite(chunked).all() and chunked.shape == whole.shape
            and logit_err <= BF16_TOL * max(1.0, ref_scale)):
        failures.append(f"chunked prefill logits of request {req.rid} "
                        f"differ from "
                        f"Model.prefill by {logit_err:.3g} "
                        f"(logit scale {ref_scale:.3g})")
    return {"rid": req.rid, "prompt_len": req.prompt_len,
            "max_abs_err": logit_err, "logit_scale": ref_scale}


def roomy(cfg):
    """``cfg`` with an MoE capacity factor of E / k: a group's capacity is
    the group, so no expert of any dispatch group overflows and a token's
    output does not depend on the other tokens of its call."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def moe_serve_check(dev, ctx: dict, failures: list) -> None:
    """Two of the trace's requests (the first of several chunks and the one
    after it) through the paged path, prefilled chunk by chunk into a fresh
    pool and then decoded together, against each request's sequential
    ``Model.prefill`` / ``decode`` fed the same tokens (its greedy ones),
    at a capacity no group can overflow: a chunk, a decode batch and a
    whole prompt route different groups (ROADMAP C1).  Every step's logits
    within the serve check's limit (bf16 tolerance x the logits' scale)."""
    from repro_torch.models import build_model
    from repro_torch.serve import paged
    from repro_torch.serve.trace import prompt_tokens

    cfg, scfg, params = roomy(ctx["cfg"]), ctx["scfg"], ctx["params"]
    model = build_model(cfg)
    trace = ctx["trace"]
    first = next(i for i, t in enumerate(trace) if t.prompt_len > scfg.chunk)
    reqs = trace[first:first + 2]
    n_dec = MOE_SERVE["decode"]
    mb = scfg.max_blocks_per_slot
    tables = (torch.arange(2 * mb, dtype=torch.int32, device=dev).view(2, mb)
              + 1)
    pool = paged.init_pool(cfg, scfg, dev)
    errs, scales, want, toks = [], [], [], []

    def compare(got, ref):
        errs.append(max_err(got, ref))
        scales.append(float(ref.abs().max()))
        if not (torch.isfinite(got).all() and got.shape == ref.shape):
            failures.append(f"moe-serve check: logits {tuple(got.shape)} "
                            f"not finite or not {tuple(ref.shape)}")

    with torch.inference_mode():
        for slot, req in enumerate(reqs):
            prompt = prompt_tokens(req, cfg.vocab_size)
            # the sequential decode: greedy tokens and each step's logits
            logits, cache = model.prefill(
                params, torch.as_tensor(prompt[None], device=dev),
                len(prompt) + n_dec)
            seq = [logits]
            for i in range(n_dec):
                tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
                logits, cache = model.decode(params, cache, tok,
                                             len(prompt) + i)
                seq.append(logits)
            want.append(seq)
            compare(prefill_in_chunks(dev, params, pool, prompt,
                                      tables[slot], cfg, scfg), seq[0])
        lengths = torch.tensor([t.prompt_len for t in reqs], dtype=torch.int32,
                               device=dev)
        for i in range(n_dec):
            toks = torch.cat([torch.argmax(w[i][:, -1], -1) for w in want])
            got, pool = paged.decode_batch(
                params, pool, toks[:, None].to(torch.int32), lengths, tables,
                cfg, scfg)
            for slot in range(2):
                compare(got[slot:slot + 1], want[slot][i + 1])
            lengths = lengths + 1
    torch.cuda.synchronize()
    for j, (e, sc) in enumerate(zip(errs, scales)):
        if e > BF16_TOL * max(1.0, sc):
            failures.append(f"moe-serve check {j}: logits differ from the "
                            f"sequential decode by {e:.3g} (scale {sc:.3g})")
    phase("moe-serve-check", arch=ctx["cfg"].name,
          rids=[t.rid for t in reqs], prompt_lens=[t.prompt_len for t in reqs],
          decode=n_dec, capacity_factor=cfg.moe.capacity_factor,
          max_abs_err=errs, logit_scale=scales, tol=BF16_TOL)


def mid_run_lengths(ctx: dict) -> list:
    """A decode batch in mid-run: each slot's context is its prompt plus half
    its token budget (the first ``slots`` requests of the trace)."""
    scfg = ctx["scfg"]
    return [min(t.prompt_len + t.max_new_tokens // 2, scfg.view_len - 1)
            for t in ctx["trace"][: scfg.slots]]


# -- phase 5: where a decode step's time goes -----------------------------------


def decode_step(dev, ctx: dict, lengths: list, mesh=None):
    """One full decode step (argmax readback included) with the lanes at
    ``lengths``, each lane on its own blocks; slot-sharded over ``mesh``
    where one is given, as the engine runs it."""
    from repro_torch.serve import paged

    cfg, scfg, params = ctx["cfg"], ctx["scfg"], ctx["params"]
    s, mb = scfg.slots, scfg.max_blocks_per_slot
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tables = (torch.arange(s * mb, dtype=torch.int32, device=dev).view(s, mb)
              + 1)
    toks = torch.ones((s, 1), dtype=torch.int32, device=dev)
    pool = paged.init_pool(cfg, scfg, dev)
    reps = paged.replicas(params, pool, mesh) if mesh is not None else None

    def step():
        with torch.inference_mode():
            if reps is None:
                logits, _ = paged.decode_batch(params, pool, toks, lens,
                                               tables, cfg, scfg)
            else:
                logits, _ = paged.decode_slot_sharded(
                    reps, toks, lens, tables, cfg, scfg, mesh)
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


def busy_and_wall(step, steps: int) -> tuple:
    """``step``'s mean host wall ms over ``steps`` calls (after 3 warm-up
    calls), the wall ms of as many calls under torch.profiler, the card's
    busy ms a call in those (the kernels' durations), and the kernels."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    wall = wall_ms(step, steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = wall_ms(step, steps)
    kernels = device_kernels(prof)
    busy = sum(float(getattr(e, "device_time_total", 0.0) or 0.0)
               for e in kernels) / steps / 1e3
    return wall, wall_prof, busy, kernels


def profile_decode(dev, ctx: dict, tag: str = "profile",
                   steps: int = 5) -> None:
    """Host wall time of one full decode step against the card's busy time
    (torch.profiler's kernel durations), at the mid-run lengths.  The idle
    share is taken over the profiled steps themselves (busy and wall of the
    same steps; the profiler slows the host); the wall time of as many
    steps without the profiler is printed beside it."""
    s = ctx["scfg"].slots
    lengths = mid_run_lengths(ctx)
    wall, wall_prof, busy_ms, kernels = busy_and_wall(
        decode_step(dev, ctx, lengths), steps)

    def dev_us(e):
        return float(getattr(e, "device_time_total", 0.0) or 0.0)

    if busy_ms <= 0.0:
        phase(tag, step="decode", lengths=lengths, wall_ms=wall,
              wall_ms_profiled=wall_prof, device_busy_ms="not measured")
        return
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    phase(tag, step="decode", slots=s, lengths=lengths,
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


def kernel_table(dev, gen, ctx: dict, failures: list,
                 prefix: str = "", lanes: int = 0,
                 phases=("decode", "prefill")) -> list:
    """RMSNorm and flash attention at a serve path's decode and prefill
    shapes (``ctx``: the serve phase's, or launches None), each held against
    its plain version (the kernel checks' bf16 tolerances); rows named
    ``<kernel>@<prefix><decode|prefill>``.  ``lanes``: the decode call's
    batch where it is not all the slots (one rank's of a slot-sharded
    decode)."""
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
    lanes = lanes or scfg.slots
    lengths = mid_run_lengths(ctx)[:lanes]
    shapes = {"decode": (lanes, 1, lengths),
              "prefill": (1, scfg.chunk, [3 * scfg.chunk])}
    shapes = {k: shapes[k] for k in phases}

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
        y, yr = fused_rmsnorm(x, w), rmsnorm_ref(x, w)
        err = max_err(y, yr)
        if not close(y, yr, BF16_TOL):
            failures.append(f"rmsnorm@{prefix}{phase_name}: max abs err "
                            f"{err:.3g} over tolerance {BF16_TOL}")
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
            "name": f"rmsnorm@{prefix}{phase_name}", "route": "cuda",
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
        o, ref = flash_attention(q, k, v, **kw), attention_plain(q, k, v, **kw)
        err = max_err(o, ref)
        if not close(o, ref, ATTN_BF16_TOL):
            failures.append(f"flash_attention@{prefix}{phase_name}: max abs "
                            f"err {err:.3g} over tolerance {ATTN_BF16_TOL}")
        err_bf16 = max_err(o, attention_ref(q, k, v, **kw))
        del o, ref
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
            "name": f"flash_attention@{prefix}{phase_name}", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:127",
            "launches": launches("flash_attention"),
            "launches_per_forward": per_forward("flash_attention"),
            "shape": f"q ({b}, {sq}, {h}, {hd}) vs k/v ({b}, {view}, {kh}, "
                     f"{hd}) bf16, q_offset {offs}",
            "max_abs_err": err, "max_abs_err_vs_plain_rounded": err_bf16,
            "ms": ms, "call_ms": call,
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


def train_kernel_table(dev, gen, ctx: dict, failures: list,
                       tag: str = "train") -> list:
    """The kernels at a train path's shapes: the SSD scan and RMSNorm of one
    microbatch of ``ctx["cfg"]`` (mamba2-2.7b for ``train``, the jamba
    variant for ``jamba-train``); launches from that train run.  Each
    output is held against its plain version with the kernel checks'
    bf16 tolerance."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ops import cost as ssd_cost
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.mamba import mamba_dims

    cfg, chip, run = ctx["cfg"], ctx["platform"].chip, ctx["run"]
    counts = ctx["launches"]

    def launches(name: str):
        """The train run's launches; None where no path was driven."""
        return None if counts is None else counts[name]

    def per_step(name: str):
        return None if counts is None else counts[name] / run["steps"]

    m, _, nh = mamba_dims(cfg)
    b, s, q = run["batch"] // run["grad_accum"], run["seq"], m.chunk_size
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
        failures.append(f"ssd_scan@{tag}: max abs err {err:.3g} over "
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
            failures.append(f"ssd_scan@{tag} {name}: the library launches "
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
        "name": f"ssd_scan@{tag}", "route": "cuda",
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

    out.append(rmsnorm_row(dev, gen, chip, f"rmsnorm@{tag}", (b, s, cfg.d_model),
                           cfg.norm_eps, launches("rmsnorm"),
                           per_step("rmsnorm"), failures))
    return out


def rmsnorm_row(dev, gen, chip, name: str, shape: tuple, eps: float,
                launches, per_step, failures: list,
                dtype=torch.bfloat16) -> dict:
    """RMSNorm at a train path's shape, x in ``dtype`` (bf16 unless the
    path computes in fp32) and w fp32 as in the model, held against its
    plain version with that dtype's tolerance."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import cost as rms_cost
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    d = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = torch.randn(d, generator=gen, device=dev)
    ops_, nbytes = rms_cost(x, w, eps, x.dtype)
    bms, by = bound_ms(chip, nbytes, ops_, FP32_FLOPS)
    w_lib = w.to(dtype)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    y, yr = fused_rmsnorm(x, w, eps=eps), rmsnorm_ref(x, w, eps)
    err = max_err(y, yr)
    if not close(y, yr, tol):
        failures.append(f"{name}: max abs err {err:.3g} over tolerance "
                        f"{tol}")
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:37",
        "launches": launches, "launches_per_step": per_step,
        "shape": f"x {tuple(shape)} "
                 f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}, w fp32",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fused_rmsnorm(x, w, eps=eps)),
        "call_ms": call_ms(lambda: fused_rmsnorm(x, w, eps=eps)),
        "plain_ms": cuda_ms(lambda: rmsnorm_ref(x, w, eps)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: F.rms_norm(x, (d,), w_lib, eps)),
        "library": "torch.nn.functional.rms_norm"}


def flash_train_row(dev, gen, chip, name: str, launches, per_step,
                    failures: list) -> dict:
    """Flash attention at a path's shape (``FLASH_TRAIN``), no masks, as
    ``layers.attention`` calls it (causal, or non-causal for the encoder and
    the cross-attention); held against its plain version, timed beside SDPA
    (``is_causal`` as the row, GQA)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import cost as fa_cost
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, launch_plan, sm_count,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref

    (b, sq, skv, h, kh, d), dtype, tol, causal = FLASH_TRAIN[name]
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, skv, kh, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    o = flash_attention(q, k, v, causal=causal)
    ref = attention_plain(q, k, v, causal=causal)
    err = max_err(o, ref)
    if not close(o, ref, tol):
        failures.append(f"flash_attention@{name}: max abs err {err:.3g} "
                        f"over tolerance {tol}")
    err_bf16 = max_err(o, attention_ref(q, k, v, causal=causal))
    del o, ref
    ops_, nbytes = fa_cost(q, k, v, causal)
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
        "shape": f"q ({b}, {sq}, {h}, {d}) vs k/v ({b}, {skv}, {kh}, {d}) "
                 f"{'bf16' if bf16 else 'fp32'}, "
                 f"{'causal' if causal else 'non-causal'}, no masks",
        "max_abs_err": err, "max_abs_err_vs_plain_rounded": err_bf16,
        "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=causal)),
        "call_ms": call_ms(lambda: flash_attention(q, k, v, causal=causal)),
        "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, causal=causal),
                            iters=5),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)),
        "library": f"torch.nn.functional.scaled_dot_product_attention "
                   f"(is_causal={causal}, enable_gqa)"}
    if bf16:
        plan = launch_plan(b, sq, skv, h, kh, d, sm_count(dev.index))
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
    mixers (SSD scan or flash attention) and block norms in the forward
    pass, again in the backward pass where the layer is recomputed (remat),
    and the final norms once (the decoder's, and the encoder's in the
    encoder-decoder).  The gradients of all three ops are the plain
    versions' VJPs and launch no kernel."""
    from repro_torch.models.hybrid import _n_superblocks, _sublayer_kinds

    passes = 1 if cfg.remat_policy == "none" else 2
    if cfg.family == "audio":
        # encoder: self-attention, 2 norms; decoder: self- and cross-
        # attention, 3 norms
        enc, dec = cfg.encoder_layers, cfg.num_layers
        attn, ssd, norms, finals = enc + 2 * dec, 0, 2 * enc + 3 * dec, 2
    elif cfg.family == "hybrid":
        kinds, n_sb = _sublayer_kinds(cfg), _n_superblocks(cfg)
        attn = n_sb * sum(1 for m, _ in kinds if m == "attn")
        ssd = n_sb * sum(1 for m, _ in kinds if m == "mamba")
        norms = n_sb * sum(1 + (f != "none") for _, f in kinds)
        finals = 1
    elif cfg.family == "ssm":
        attn, ssd, norms, finals = 0, cfg.num_layers, cfg.num_layers, 1
    else:
        attn, ssd, norms, finals = cfg.num_layers, 0, 2 * cfg.num_layers, 1
    return {"ssd_scan": passes * ssd * grad_accum,
            "flash_attention": passes * attn * grad_accum,
            "rmsnorm": (passes * norms + finals) * grad_accum}


def synthetic_batch(cfg, run: dict, step: int, dev, rows=None) -> dict:
    """The train run's batch of ``step`` on the card (its first ``rows``
    rows), as ``launch.train`` draws it: frames as long as the tokens for
    the encoder-decoder."""
    from repro_torch.data import SyntheticTokens

    src = SyntheticTokens(
        cfg.vocab_size, run["seq"], run["batch"], seed=run["seed"],
        frontend_dim=cfg.frontend_dim if cfg.family == "audio" else 0,
        frames_len=run["seq"])
    return {k: torch.as_tensor(v[:rows], device=dev)
            for k, v in src.batch_at(step).items()}


def kernel_counters() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return {"ssd_scan": ssd_ops.LAUNCHES, "rmsnorm": rms_ops.LAUNCHES,
            "flash_attention": fa_ops.LAUNCHES}


def train_phase(dev, failures: list, cfg, run: dict, tag: str) -> dict:
    """``run["steps"]`` steps of ``launch.train.train`` on ``cfg`` (over
    ``run["ranks"]`` logical ranks where the run names them); per step the
    loss, ce and aux, host and device ms, tokens/s, the peak memory of that
    step and each kernel's launches, which must be ``train_launches``'s."""
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
    logs: list = []
    # the main path: counts from zero, read right after
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    state, losses = train(cfg, steps=run["steps"], seq=run["seq"],
                          batch=run["batch"], grad_accum=run["grad_accum"],
                          ranks=run.get("ranks"), seed=run["seed"],
                          device=dev, on_step=on_step, log_fn=logs.append)
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
            "logs": logs,
            "platform": platform_for_device(torch.cuda.get_device_name(dev))}


def profile_train_step(dev, ctx: dict, tag: str, step=None) -> None:
    """One more step of the same run under torch.profiler: the card's busy
    time against the host wall time of that step, and the kernels that take
    it.  The wall time of the run's last step, without the profiler, is
    printed beside it.  ``step``: the run's step function (default: the
    plain step with the run's grad_accum)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    from repro_torch.optim import cosine_with_warmup, make_optimizer
    from repro_torch.train.step import make_train_step

    cfg, run = ctx["cfg"], ctx["run"]
    if step is None:
        step = make_train_step(build_model(cfg),
                               make_optimizer(cfg.optimizer),
                               cosine_with_warmup(3e-4, 20, 21),
                               grad_accum=run["grad_accum"])
    batch = synthetic_batch(cfg, run, run["steps"], dev)
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
                           label: str, failures: list, **inputs) -> tuple:
    """``Model.prefill`` of ``prompt`` tokens (and ``inputs``, the encoder-
    decoder's frames), then ``decode`` steps, each against the whole-
    sequence prefill at the same position: the max abs errors and the
    logits' scales."""
    errs, scales = [], []
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens[:, :prompt],
                                      prompt + decode, **inputs)
        for i in range(decode):
            pos = prompt + i
            logits, cache = model.decode(params, cache,
                                         tokens[:, pos:pos + 1], pos)
            whole, _ = model.prefill(params, tokens[:, :pos + 1], **inputs)
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


def attention_check(dev, ctx: dict, failures: list, tag: str) -> None:
    """One microbatch of a train run's model (its trained parameters)
    through the kernel, as the run takes it, against the same microbatch
    with attention swapped for ``attention_ref`` where ``models/layers.py``
    calls the op: the loss and the global grad norm."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import build_model
    from repro_torch.models import layers
    from repro_torch.tree import leaves

    cfg, run, params = ctx["cfg"], ctx["run"], ctx["state"].params
    model = build_model(cfg)
    mb = run["batch"] // run["grad_accum"]
    batch = synthetic_batch(cfg, run, 0, dev, rows=mb)

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
        failures.append(f"{tag}: {n_kernel} kernel launches through "
                        f"the kernel (expected {want}), {n_plain} with "
                        "attention_ref (expected 0)")
    rel = [abs(a - b) / abs(b) for a, b in zip(kern, ref)]
    if not all(math.isfinite(x) for x in kern + ref) or max(rel) > \
            DENSE_CHECK_TOL:
        failures.append(f"{tag}: loss and grad norm {kern} through "
                        f"the kernel, {ref} through attention_ref (relative "
                        f"{rel}, tolerance {DENSE_CHECK_TOL})")
    phase(tag, arch=cfg.name, microbatch=[mb, run["seq"]],
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
    from repro_torch.launch.sim_accuracy import smoke_config
    from repro_torch.models import build_model

    cfg = smoke_config(MOE_ARCH)
    ctx = train_phase(dev, failures, cfg, MOE, "moe-train")
    auxes = [r["aux"] for r in ctx["steps"]]
    if not all(math.isfinite(a) and a > 0 for a in auxes):
        failures.append(f"moe: aux losses {auxes}, expected finite and > 0")
    moe, check = cfg.moe, roomy(cfg)
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
        build_model(check), ctx["state"].params, tokens, d["prompt"],
        d["decode"], "moe", failures)
    launches = {k: c.count for k, c in counters.items()}
    if launches != want:
        failures.append(f"moe decode: launches {launches}, expected {want}")
    check_decode_errors(errs, scales, d["tol"], "moe", failures)
    phase("moe", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
          experts=moe.num_experts, top_k=moe.top_k, aux=auxes,
          decode={**d, "capacity_factor": check.moe.capacity_factor,
                  "max_abs_err": errs, "logit_scale": scales,
                  "launches": launches})
    return ctx


# -- phases 14-18: MoE serving, the jamba superblock, the encoder-decoder -------


def moe_serve_config():
    """qwen3-moe-235b-a22b at its published widths, depth cut to
    ``MOE_SERVE["layers"]``."""
    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(MOE_SERVE["arch"]),
                               num_layers=MOE_SERVE["layers"])


def jamba_config():
    """One whole period of jamba-1.5-large-398b with d_model cut to 1024 and
    the dense and expert FFNs to 3 x 1024 (the published ratio); every
    head, state and expert count as published."""
    from repro_torch.configs.base import get_config

    cfg = get_config(JAMBA_ARCH)
    return dataclasses.replace(
        cfg, num_layers=cfg.attn_every, d_model=1024, d_ff=3 * 1024,
        moe=dataclasses.replace(cfg.moe, d_ff_expert=3 * 1024))


def decode_launches(cfg, prefills: int, steps: int) -> dict:
    """Kernel launches of ``prefills`` whole-sequence prefills and ``steps``
    decode steps: every attention (a decode step's too) is one flash launch
    and every norm one RMSNorm launch, as in a forward pass without remat;
    a prefill runs an SSD scan a mamba layer, a decode step none (the O(1)
    state update); an encoder-decoder's decode step runs the decoder
    alone."""
    one = train_launches(dataclasses.replace(cfg, remat_policy="none"), 1)
    step = dict(one, ssd_scan=0)
    if cfg.family == "audio":
        step.update(flash_attention=2 * cfg.num_layers,
                    rmsnorm=3 * cfg.num_layers + 1)
    return {k: prefills * one[k] + steps * step[k] for k in one}


def jamba_phase(dev, failures: list) -> dict:
    """``JAMBA``'s train run of the jamba variant (launches asserted a
    step, finite losses, aux > 0), then its prefill and decode against the
    whole-sequence prefill on the trained parameters, in fp32 compute at a
    capacity no group can overflow."""
    from repro_torch.models import build_model

    cfg = jamba_config()
    ctx = train_phase(dev, failures, cfg, JAMBA, "jamba-train")
    auxes = [r["aux"] for r in ctx["steps"]]
    if not all(math.isfinite(a) and a > 0 for a in auxes):
        failures.append(f"jamba: aux losses {auxes}, expected finite and > 0")
    ctx["state"] = ctx["state"]._replace(opt_state=None)
    d = JAMBA_DECODE
    gen = torch.Generator(device=dev).manual_seed(d["seed"])
    tokens = torch.randint(1, cfg.vocab_size,
                           (d["batch"], d["prompt"] + d["decode"]),
                           generator=gen, device=dev)
    check = roomy(dataclasses.replace(cfg, compute_dtype="float32"))
    want = decode_launches(cfg, 1 + d["decode"], d["decode"])
    counters = kernel_counters()
    # this path's run: counts from zero, read right after
    for c in counters.values():
        c.reset()
    errs, scales = decode_against_prefill(
        build_model(check), ctx["state"].params, tokens, d["prompt"],
        d["decode"], "jamba", failures)
    launches = {k: c.count for k, c in counters.items()}
    if launches != want:
        failures.append(f"jamba decode: launches {launches}, expected {want}")
    check_decode_errors(errs, scales, d["tol"], "jamba", failures)
    phase("jamba", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
          aux=auxes, decode={**d, "compute": "float32",
                             "capacity_factor": check.moe.capacity_factor,
                             "max_abs_err": errs, "logit_scale": scales,
                             "launches": launches})
    return ctx


def encdec_decode(dev, ctx: dict, failures: list) -> dict:
    """The trained seamless-m4t's prefill of ``source_len`` frames and a
    ``prompt``-token prefix, then ``decode`` steps, each against the
    whole-sequence prefill, in fp32 compute (its parameters are fp32)."""
    from repro_torch.models import build_model

    cfg, d = ctx["cfg"], ENCDEC_DECODE
    gen = torch.Generator(device=dev).manual_seed(d["seed"])
    tokens = torch.randint(1, cfg.vocab_size,
                           (d["batch"], d["prompt"] + d["decode"]),
                           generator=gen, device=dev)
    frames = torch.randn(d["batch"], cfg.source_len, cfg.frontend_dim,
                         generator=gen, device=dev)
    check = dataclasses.replace(cfg, compute_dtype="float32")
    want = decode_launches(cfg, 1 + d["decode"], d["decode"])
    counters = kernel_counters()
    # this path's run: counts from zero, read right after
    for c in counters.values():
        c.reset()
    errs, scales = decode_against_prefill(
        build_model(check), ctx["state"].params, tokens, d["prompt"],
        d["decode"], "encdec", failures, frames=frames)
    launches = {k: c.count for k, c in counters.items()}
    if launches != want:
        failures.append(f"encdec decode: launches {launches}, expected "
                        f"{want}")
    check_decode_errors(errs, scales, d["tol"], "encdec", failures)
    phase("encdec-decode", arch=cfg.name, source_len=cfg.source_len, **d,
          compute="float32", max_abs_err=errs, logit_scale=scales,
          launches=launches)
    return launches


def new_path_kernel_table(dev, gen, ctx: dict, failures: list) -> list:
    """The kernels at the jamba and seamless paths' shapes: the SSD scan,
    RMSNorm and flash attention of one jamba microbatch, RMSNorm and the
    three attentions of one seamless microbatch and a decode step's cross-
    attention; launches from those paths' runs (None where no path was
    driven; a flash row gives all the flash launches of its run)."""
    from repro_torch.configs.base import get_config

    chip = ctx["platform"].chip

    def counts(run: str, kernel: str, steps: int):
        c = ctx[run]
        return (None, None) if c is None else (c[kernel], c[kernel] / steps)

    jcfg, ecfg = jamba_config(), get_config(ENCDEC_ARCH)
    rows = train_kernel_table(dev, gen, {
        "cfg": jcfg, "run": JAMBA, "platform": ctx["platform"],
        "launches": ctx["jamba"], "ptxas": ctx["ptxas"]}, failures,
        "jamba-train")
    rows.append(flash_train_row(
        dev, gen, chip, "jamba-train",
        *counts("jamba", "flash_attention", JAMBA["steps"]), failures))
    b = ENCDEC["batch"] // ENCDEC["grad_accum"]
    rows.append(rmsnorm_row(
        dev, gen, chip, "rmsnorm@encdec-train",
        (b, ENCDEC["seq"], ecfg.d_model), ecfg.norm_eps,
        *counts("encdec", "rmsnorm", ENCDEC["steps"]), failures))
    for name in ("encdec-train-encoder-cross", "encdec-train-decoder-self"):
        rows.append(flash_train_row(
            dev, gen, chip, name,
            *counts("encdec", "flash_attention", ENCDEC["steps"]), failures))
    rows.append(flash_train_row(
        dev, gen, chip, "encdec-decode-cross",
        *counts("encdec_decode", "flash_attention", 1), failures))
    return rows


# -- phases 8 and 12: the simulator's train-step loop ---------------------------


def simtrain_phase(dev, cfg, seq: int, batch: int, failures: list,
                   db=None) -> dict:
    from repro_torch.launch.sim_accuracy import run

    row = run(cfg, seq=seq, batch=batch, steps=SIMTRAIN["steps"],
              profile_repeats=SIMTRAIN["repeats"], device=dev,
              log_fn=lambda _: None, db=db)
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


# -- this slice: the "dots" remat, data and pipeline parallelism ---------------


class CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched while active (the backward pass's
    included)."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def zero_lr(dev):
    """A schedule of learning rate 0: the step computes its loss, gradients
    and grad norm and leaves the parameters as they were, so several steps
    read the same weights."""
    zero = torch.zeros((), device=dev)
    return lambda step: zero


def remat_phase(dev, failures: list) -> None:
    """``[remat-dots]``: llama3.2-1b at full width and depth, the
    ``[dense-train]`` run's shapes.  One microbatch's loss and gradient under
    "none", "full" and "dots" with the aten ops counted: the backward's
    ``aten.mm`` under "dots" must equal "none"'s (the gradients' own: no
    projection recomputed) and be fewer than "full"'s; then one step under
    "full" and one under "dots" from the same state: loss and grad norm
    within the bf16 tolerance, each step's time and peak memory."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import leaves

    cfg = get_config(DENSE_ARCH)
    models = {p: build_model(dataclasses.replace(cfg, remat_policy=p))
              for p in ("none", "full", "dots")}
    opt = make_optimizer(cfg.optimizer)
    state = init_state(models["dots"],
                       torch.Generator(device=dev).manual_seed(DENSE["seed"]),
                       opt)
    mb = DENSE["batch"] // DENSE["grad_accum"]
    micro = synthetic_batch(cfg, DENSE, 0, dev, rows=mb)
    mm = torch.ops.aten.mm.default
    counts = {}
    for pol, model in models.items():
        flat = leaves(state.params)
        with CountOps() as fwd:
            loss, _ = model.loss(state.params, micro)
        with CountOps() as bwd:
            grads = torch.autograd.grad(loss, flat)
        counts[pol] = {"forward_mm": fwd.counts.get(mm, 0),
                       "backward_mm": bwd.counts.get(mm, 0)}
        del loss, grads
        torch.cuda.empty_cache()
    if not (counts["dots"]["backward_mm"] == counts["none"]["backward_mm"]
            < counts["full"]["backward_mm"]):
        failures.append(f"remat-dots: backward aten.mm counts {counts}: "
                        "'dots' must recompute no projection")
    batch = synthetic_batch(cfg, DENSE, 0, dev)
    steps = {}
    for pol in ("full", "dots"):
        step = make_train_step(models[pol], opt, zero_lr(dev),
                               grad_accum=DENSE["grad_accum"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        steps[pol] = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                      "step_ms": 1e3 * (time.perf_counter() - t0),
                      "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    rel = {k: abs(steps["dots"][k] - steps["full"][k]) / abs(steps["full"][k])
           for k in ("loss", "grad_norm")}
    if max(rel.values()) > BF16_TOL or not all(
            math.isfinite(v["loss"]) for v in steps.values()):
        failures.append(f"remat-dots: full {steps['full']} vs dots "
                        f"{steps['dots']} (relative {rel}, tolerance "
                        f"{BF16_TOL})")
    phase("remat-dots", arch=cfg.name, microbatch=[mb, DENSE["seq"]],
          aten_mm=counts, steps=steps, rel_err=rel, tol=BF16_TOL,
          batch=DENSE["batch"], grad_accum=DENSE["grad_accum"])


def pp_train_phase(dev, failures: list) -> dict:
    """``[pp-train]``: llama3.2-1b at full width and depth through
    ``launch.train.train`` on 4 logical ranks of the one card, pp=2 x dp=2,
    1F1B, int8 compression with error feedback: ``PP["steps"]`` steps (the
    first a warm-up); per step the loss, host and device ms, tokens/s, peak
    memory and launches, which must be 256 flash attentions and 520
    RMSNorms; the launcher's own plan and parity lines; and the bytes the
    executor moved (hops, int8 payloads)."""
    from repro_torch.configs.base import get_config
    from repro_torch.dist import mesh as M
    from repro_torch.launch.train import train

    cfg = get_config(DENSE_ARCH)
    want = train_launches(cfg, grad_accum=PP["dp"] * PP["microbatches"])
    want = {k: v for k, v in want.items() if k != "ssd_scan"}
    counters = {k: c for k, c in kernel_counters().items()
                if k in want}
    steps, logs, seen = [], [], {k: 0 for k in counters}

    t_last = [0.0]

    def on_step(i, rec):
        t_last[0] = time.perf_counter()
        rec = dict(rec, step=i + 1, launches={
            k: c.count - seen[k] for k, c in counters.items()},
            tokens_per_s=PP["batch"] * PP["seq"] / (rec["host_ms"] / 1e3),
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        torch.cuda.reset_peak_memory_stats(dev)
        seen.update({k: c.count for k, c in counters.items()})
        steps.append(rec)
        phase("pp-train-step", **rec)
        if rec["launches"] != want:
            failures.append(f"pp-train step {i + 1}: launches "
                            f"{rec['launches']}, expected {want}")
        if rec["peak_gb"] >= 80.0:
            failures.append(f"pp-train step {i + 1}: {rec['peak_gb']} GB")

    obs = {}

    def on_obs(report, counts):
        obs.update(report=report, counts=counts, t=time.perf_counter(),
                   launches={k: c.count - seen[k]
                             for k, c in counters.items()})

    overlay = os.path.join(tempfile.mkdtemp(prefix="pp-obs-"),
                           "pp_overlay.json")
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: counts from zero, read right after its last step (the
    # --obs replay after it launches the kernels again, counted apart)
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    state, losses = train(
        cfg, steps=PP["steps"], seq=PP["seq"], batch=PP["batch"],
        pp=PP["pp"], pp_schedule=PP["schedule"],
        microbatches=PP["microbatches"], compression=PP["compression"],
        ranks=PP["dp"] * PP["pp"], seed=PP["seed"], device=dev,
        analyze=True, obs=True, trace_out=overlay, on_step=on_step,
        on_obs=on_obs, log_fn=logs.append)
    wall = time.perf_counter() - t0
    launches = dict(seen)
    traffic = dict(M.TRAFFIC)
    pp_analyze_obs(obs, logs, overlay, failures)
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"pp-train: non-finite losses {losses}")
    timed = [r["host_ms"] for r in steps[1:]]
    med = sorted(timed)[len(timed) // 2]
    phase("pp-train", arch=cfg.name, layers=cfg.num_layers,
          d_model=cfg.d_model, vocab=cfg.vocab_size, **PP,
          remat=cfg.remat_policy, losses=losses, launches=launches,
          launches_per_step_expected=want, median_step_ms=med,
          timed_step_ms=timed, tokens_per_s=PP["batch"] * PP["seq"] / med
          * 1e3, max_memory_allocated_gb=max(r["peak_gb"] for r in steps),
          traffic_bytes=traffic, launcher_lines=[
              ln for ln in logs if ln.startswith(("[pp-", "[comm]"))],
          seconds=wall, seconds_after_last_step=obs["t"] - t_last[0],
          note="4 logical ranks share one card and run one after another: "
               "not a multi-card step time")
    return {"cfg": cfg, "run": PP, "state": state, "median_s": med / 1e3,
            "last_step_ms": steps[-1]["host_ms"], "traffic": traffic,
            "launches": launches}


def chrome_trace_ok(path: str) -> dict:
    """A Chrome/Perfetto trace file's event counts by track side (``sim:``,
    ``real:``); raises if it does not parse as one."""
    with open(path) as f:
        trace = json.load(f)
    label = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    sides: dict = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            side = label[e["pid"]].split(":", 1)[0]
            sides[side] = sides.get(side, 0) + 1
            if not (e["dur"] >= 0 and math.isfinite(e["ts"])):
                raise ValueError(f"event {e['name']}: ts {e['ts']}, "
                                 f"dur {e['dur']}")
    return sides


def obs_summary(report) -> dict:
    """A divergence report's ``obs_*`` metrics, O-codes and provenance
    classes (real and simulated seconds, relative error)."""
    d = report.to_dict()
    return {"metrics": {k: v for k, v in d["metrics"].items()
                        if k.startswith("obs_")},
            "codes": sorted(f["code"] for f in d["findings"]),
            "classes": d["extras"]["obs_diff"]["classes"],
            "top": [{k: r[k] for k in ("name", "real_s", "sim_s",
                                       "provenance")}
                    for r in d["extras"]["obs_diff"]["top"][:5]]}


def pp_analyze_obs(obs: dict, logs: list, overlay: str,
                   failures: list) -> None:
    """``[pp-analyze]``: the launcher's static check of the [pp-train] plan
    before its first step (it raises on an error-level finding);
    ``[pp-obs]``: its --obs post-pass after the last step — every F, B,
    send and gradAR node of the plan's graph replayed on the card under its
    uid (none skipped), the divergence report and the overlay."""
    phase("pp-analyze", lines=[ln for ln in logs
                               if ln.startswith("[analyze]")])
    report, counts = obs["report"], obs["counts"]
    summary = obs_summary(report)
    m = summary["metrics"]
    try:
        sides = chrome_trace_ok(overlay)
    except (OSError, ValueError, KeyError) as e:
        sides = None
        failures.append(f"pp-obs: overlay {overlay} is not a Chrome trace: "
                        f"{e}")
    if counts is None or counts["skipped"] != 0 or counts["measured"] == 0:
        failures.append(f"pp-obs: replay counts {counts}")
    if m.get("obs_unmatched_real") != 0 or m.get("obs_unmatched_sim") != 0:
        failures.append(f"pp-obs: unmatched spans or nodes {m}")
    if not all(obs["launches"].values()):
        failures.append(f"pp-obs: the replay launched {obs['launches']}")
    phase("pp-obs", replay=counts, replay_launches=obs["launches"],
          overlay_events=sides, **summary,
          lines=[ln for ln in logs if ln.startswith("[obs] mean")])


def profile_pp_step(dev, ctx: dict) -> None:
    """``[pp-train-profile]``: one more pp x dp step of the run under
    torch.profiler (busy against wall, device time by kind and under the
    step's ranges: ``train_step.pipeline``, ``.reduce``, ``.optimizer``)."""
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.pipeline import make_plan
    from repro_torch.optim import cosine_with_warmup, make_optimizer
    from repro_torch.train.step import make_pipeline_train_step

    cfg = ctx["cfg"]
    step = make_pipeline_train_step(
        build_model(cfg), make_optimizer(cfg.optimizer),
        cosine_with_warmup(3e-4, 20, 21),
        make_mesh((PP["dp"], PP["pp"]), ("data", "stage"), dev),
        make_plan(cfg, PP["pp"], PP["microbatches"],
                  schedule=PP["schedule"]), compression=PP["compression"])
    profile_train_step(dev, ctx, "pp-train-profile", step=step)


def first_moments(step, state, opt, batch):
    """Run ``step`` from a fresh AdamW state (learning rate 0: the weights
    stay): its metrics, and its first moments, ``(1 - b1)`` times the
    clipped gradient of every leaf."""
    from repro_torch.tree import leaves

    state = state._replace(opt_state=opt.init(state.params))
    state, m = step(state, batch)
    return state, m, leaves(state.opt_state["m"])


def leaf_names(tree, prefix: str = "") -> list:
    """The leaves' paths, in ``repro_torch.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def moment_err(got: list, ref: list, names: list) -> tuple:
    """The largest ||got - ref|| / ||ref|| over the leaves and, for the
    stacked block leaves, over their layers' rows; and where it is."""
    worst, where = 0.0, None
    for g, r, name in zip(got, ref, names):
        views = [(g.reshape(1, -1), r.reshape(1, -1), name)]
        if name.startswith("blocks/"):
            views.append((g.reshape(g.shape[0], -1),
                          r.reshape(r.shape[0], -1), name + "[layer]"))
        for gg, rr, tag in views:
            err = (gg - rr).norm(dim=1) / rr.norm(dim=1).clamp_min(1e-30)
            i = int(err.argmax())
            if float(err[i]) > worst:
                worst = float(err[i])
                where = tag.replace("[layer]", f"[{i}]")
    return worst, where


def pp_check_phase(dev, ctx: dict, failures: list) -> None:
    """``[pp-check]``: the pp=2 x dp=2 step without compression against the
    unpipelined step on the same weights and tokens (the ``[dense-train]``
    batch), for 1F1B, GPipe and interleaved 1F1B (2 virtual stages a rank).
    Two unpipelined references: ``grad_accum`` 8, the same eight (1, 2048)
    microbatches as the pipeline, so only the order of the fp32 sums
    differs; and the ``[dense-train]`` step's ``grad_accum`` 4, whose
    (2, 2048) microbatches round their bf16 weight gradients elsewhere.
    Each step starts from a fresh optimizer state at learning rate 0, so
    every step reads the same weights and its first moments are its clipped
    gradient: the loss and grad norm must agree within
    ``PP_CHECK_TOL["scalar"]``, and every gradient leaf and every layer's
    row of a block leaf within ``PP_CHECK_TOL["grad"]`` of that reference
    (the relative norm of the difference)."""
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.pipeline import make_plan
    from repro_torch.optim import make_optimizer
    from repro_torch.train.step import make_pipeline_train_step, make_train_step

    cfg = ctx["cfg"]
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    state = ctx["state"]._replace(comp_state=None, opt_state=None)
    ctx["state"] = None
    names = leaf_names(state.params)
    torch.cuda.empty_cache()
    batch = synthetic_batch(cfg, DENSE, 0, dev)
    refs = {}
    for accum in PP_CHECK_TOL["grad"]:
        step = make_train_step(model, opt, zero_lr(dev), grad_accum=accum)
        state, m, mom = first_moments(step, state, opt, batch)
        refs[accum] = ({k: float(m[k]) for k in ("loss", "grad_norm")},
                       [t.clone() for t in mom])
        del mom
    mesh = make_mesh((PP["dp"], PP["pp"]), ("data", "stage"), dev)
    rows = {}
    for sched, v in (("1f1b", 1), ("gpipe", 1), ("interleaved_1f1b", 2)):
        plan = make_plan(cfg, PP["pp"], PP["microbatches"], schedule=sched,
                         vstages=v)
        pstep = make_pipeline_train_step(model, opt, zero_lr(dev), mesh,
                                         plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m, got_m = first_moments(pstep, state, opt, batch)
        got = {k: float(m[k]) for k in ("loss", "grad_norm")}
        row = dict(got, step_ms=1e3 * (time.perf_counter() - t0))
        for accum, (ref, ref_m) in refs.items():
            rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in got}
            err, where = moment_err(got_m, ref_m, names)
            row[f"vs_grad_accum_{accum}"] = dict(rel_err=rel, grad_rel_err=err,
                                                 worst=where)
            tol = PP_CHECK_TOL["grad"][accum]
            if max(rel.values()) > PP_CHECK_TOL["scalar"] or err > tol:
                failures.append(
                    f"pp-check {plan.describe()} against grad_accum {accum}: "
                    f"{got} vs {ref} (relative {rel}), gradients {err} at "
                    f"{where}; tolerances {PP_CHECK_TOL['scalar']}, {tol}")
        rows[plan.describe()] = row
        del got_m
    phase("pp-check", unpipelined={a: r for a, (r, _) in refs.items()},
          pipelined=rows, tol=PP_CHECK_TOL, batch=DENSE["batch"],
          seq=DENSE["seq"])
    del refs
    ctx["state"] = state


def pp_plan_phase(dev, ctx: dict, db, failures: list) -> dict:
    """``[pp-plan]``, ``[pp-parity]``: one llama3.2-1b layer profiled on
    the card (its forward and its backward at every microbatch of
    ``AUTOTUNE``, into the ProfileDB the dense ``simtrain`` row built), then
    the ``[pp-train]`` strategy's ``model_pipeline_graph`` priced from that
    DB (a chunk of n layers as n times the layer) on 4 H100 SXM (data-sheet
    NVLink for the collectives) and simulated; the simulated boundary and
    all-reduce bytes held exactly against the executor's twins and the
    bytes ``[pp-train]`` moved."""
    from repro_torch.core.estimator import OpTimeEstimator, dist_comm_bytes
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.simulator import simulate
    from repro_torch.core.strategy import model_pipeline_graph
    from repro_torch.dist.compress import compressed_psum_bytes
    from repro_torch.models import build_model
    from repro_torch.models.pipeline import (
        make_plan,
        model_layer_cost,
        profile_layer,
        stage_param_trees,
    )

    cfg = ctx["cfg"]
    t0 = time.perf_counter()
    layer = {mb: profile_layer(db, H100_SXM.name, cfg, mb, PP["seq"], dev)
             for mb in AUTOTUNE["micro_batches"]}
    profile_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    est = OpTimeEstimator(H100_SXM, db)
    plan = make_plan(cfg, PP["pp"], PP["microbatches"],
                     schedule=PP["schedule"])
    mbs = PP["batch"] // (PP["dp"] * PP["microbatches"])
    params, _ = build_model(cfg).abstract_params()
    graph = model_pipeline_graph(
        cfg, plan.strategy(dp=PP["dp"], compression=PP["compression"]),
        mbs, PP["seq"], params=params,
        cost=model_layer_cost(cfg, mbs, PP["seq"], db=db,
                              platform=H100_SXM.name))
    res = simulate(graph, est.duration, record_events=False)
    chunks = sum(n.kind in ("fwd", "bwd") for n in graph.nodes)
    if est.layer_chunks != chunks:
        failures.append(f"pp-plan: {est.layer_chunks} of {chunks} chunks "
                        "priced from the measured layer")
    phase("pp-plan", strategy=plan.strategy(
        dp=PP["dp"], compression=PP["compression"]).describe(),
          simulated=True, platform=H100_SXM.name, chips=PP["dp"] * PP["pp"],
          simulated_step_ms=1e3 * res.makespan,
          simulated_ms_by_kind={k: 1e3 * v
                                for k, v in res.time_by_kind.items()},
          layer_profile_ms={mb: {k[:-2] + "_ms": 1e3 * v
                                 for k, v in r.items()}
                            for mb, r in layer.items()},
          profile_seconds=profile_s, estimator_stats=dict(est.stats))

    # byte parity: simulated == executor twin == what [pp-train] moved
    by = {n.name: n for n in graph.nodes}
    sim_hops = sum(dist_comm_bytes(n) for n in graph.nodes
                   if n.kind == "collective-permute")
    twin_hops = plan.boundary_bytes_per_step(mbs, PP["seq"])
    passes = PP["steps"] * PP["dp"]
    exec_hops = ctx["traffic"].get("ppermute", 0) / passes
    sim_ar = [dist_comm_bytes(by[f"gradAR{s}"]) for s in range(PP["pp"])]
    trees = stage_param_trees(plan, params)
    twin_ar = [compressed_psum_bytes(t, PP["compression"]) for t in trees]
    exec_ar = ctx["traffic"].get("psum_int8", 0) / passes
    # the executor reduces the tied table's two gradient paths once, merged
    # (the reference's numerics); the twin prices each stage's own copy
    tied = (compressed_psum_bytes({"embed": params["embed"]},
                                  PP["compression"])
            if cfg.tie_embeddings else 0.0)
    ok = (sim_hops == twin_hops == exec_hops and sim_ar == twin_ar
          and exec_ar == sum(sim_ar) - tied)
    phase("pp-parity", boundary_bytes={"sim": sim_hops, "twin": twin_hops,
                                       "executed": exec_hops},
          allreduce_bytes={"sim_per_stage": sim_ar, "twin_per_stage": twin_ar,
                           "executed_per_data_rank": exec_ar,
                           "tied_table_reduced_once": tied},
          ok=ok)
    if not ok:
        failures.append("pp-parity: simulated and executed bytes differ")

    return {"db": db, "est": est}


def autotune_phase(ctx: dict, failures: list) -> None:
    """``[autotune]``: the (dp x pp x microbatch x schedule) candidates for
    llama3.2-1b on 8 H100 SXM at a global batch of 8 x 2048, ranked by
    simulated step from the card-profiled layer cost (every chunk priced
    as its layer count times the layer ``pp_plan_phase`` measured): the
    top 5, simulated."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.autotuner import Autotuner
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.models.pipeline import model_layer_cost

    cfg = get_config(DENSE_ARCH)
    db, est = ctx["db"], ctx["est"]
    tuner = Autotuner(
        cfg, chips=AUTOTUNE["chips"], global_batch=PP["batch"],
        seq=PP["seq"], platform=H100_SXM, estimator=est,
        layer_cost=lambda mb, tp: model_layer_cost(
            cfg, mb, PP["seq"], tp, db=db, platform=H100_SXM.name))
    t0 = time.perf_counter()
    before, chunks0 = dict(est.stats), est.layer_chunks
    res = tuner.search(tp_options=(1,), microbatch_options=AUTOTUNE[
        "micro_batches"])
    priced = {k: est.stats[k] - before.get(k, 0) for k in est.stats}
    priced["layer_chunks"] = est.layer_chunks - chunks0
    if not res or not priced["layer_chunks"] or any(
            priced[k] for k in est.stats):
        failures.append(f"autotune: {len(res)} results, pricing {priced} "
                        "(every chunk must come from the measured layer)")
    phase("autotune", simulated=True, chips=AUTOTUNE["chips"],
          platform=H100_SXM.name, global_batch=PP["batch"], seq=PP["seq"],
          candidates=len(res), prune_stats=tuner.prune_stats,
          pricing=priced, seconds=time.perf_counter() - t0,
          top5=[{"strategy": r.strategy.describe(),
                 "simulated_step_ms": 1e3 * r.makespan_s,
                 "bubble": r.bubble_fraction, "comm": r.comm_fraction}
                for r in res[:5]])


def pp_kernel_table(dev, gen, platform, launches, failures: list) -> list:
    """The kernels at the pipelined step's shapes (microbatch 1 x 2048):
    RMSNorm and flash attention, launches from ``[pp-train]``."""
    from repro_torch.configs.base import get_config

    cfg, chip = get_config(DENSE_ARCH), platform.chip
    steps = PP["steps"]
    return [
        rmsnorm_row(dev, gen, chip, "rmsnorm@pp-train",
                    (1, PP["seq"], cfg.d_model), cfg.norm_eps,
                    launches["rmsnorm"], launches["rmsnorm"] / steps,
                    failures),
        flash_train_row(dev, gen, chip, "pp-train",
                        launches["flash_attention"],
                        launches["flash_attention"] / steps, failures)]


def pp_phases(dev, gen, platform, db, failures: list) -> list:
    """The "dots" remat and the data and pipeline parallel phases, in order
    (remat-dots, pp-train, pp-train-profile, pp-check, pp-plan, pp-parity,
    autotune), the layer profiled into ``db``; returns the kernel rows at
    the pipelined step's shapes."""
    remat_phase(dev, failures)
    torch.cuda.empty_cache()
    pctx = pp_train_phase(dev, failures)
    profile_pp_step(dev, pctx)
    torch.cuda.empty_cache()
    pp_check_phase(dev, pctx, failures)
    pctx["state"] = None
    torch.cuda.empty_cache()
    autotune_phase(pp_plan_phase(dev, pctx, db, failures), failures)
    torch.cuda.empty_cache()
    return pp_kernel_table(dev, gen, platform, pctx["launches"], failures)


# -- phases 23-26: expert parallelism --------------------------------------------


def ep_config():
    """qwen3-moe-235b-a22b at its published widths, ``EP_LAYERS`` of its
    94 layers, MoE through ``impl="ep_a2a"``."""
    from repro_torch.configs.base import get_config

    cfg = get_config(EP_ARCH)
    return dataclasses.replace(cfg, num_layers=EP_LAYERS,
                               moe=dataclasses.replace(cfg.moe,
                                                       impl="ep_a2a"))


def ep_mesh(dev, shape=(EP["ranks"], 1)):
    from repro_torch.dist.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), dev)


def ep_train_phase(dev, failures: list) -> dict:
    """``[ep-train]``: ``train_phase`` on the EP cell (4 flash and 9 RMSNorm
    launches a step: 2 layers' forward and recompute, the final norm), then
    ``[ep-train-path]``: the MoE calls by path, which must all be EP (2
    layers x 2 passes a step), aux > 0 every step, the bytes the
    all-to-alls moved and the launcher's ``[comm]`` and ``[moe]`` lines."""
    from repro_torch.dist import mesh as M
    from repro_torch.models import moe as moe_mod

    ectx = train_phase(dev, failures, ep_config(), EP, "ep-train")
    cfg = ectx["cfg"]
    calls = dict(moe_mod.EP_CALLS)
    ectx["traffic"] = dict(M.TRAFFIC)
    want = {"ep_a2a": EP["steps"] * cfg.num_layers * 2}
    if calls != want:
        failures.append(f"ep-train: MoE calls by path {calls}, expected "
                        f"{want}")
    aux = [r["aux"] for r in ectx["steps"]]
    if not all(a > 0.0 for a in aux):
        failures.append(f"ep-train: aux {aux}")
    phase("ep-train-path", experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
          capacity_factor=cfg.moe.capacity_factor,
          group_size=cfg.moe.group_size, optimizer=cfg.optimizer,
          param_dtype=cfg.param_dtype, mesh={"data": EP["ranks"],
                                             "model": 1},
          reduced=EP_REDUCED, aux=aux, moe_calls_by_path=calls,
          traffic_bytes=ectx["traffic"], launcher_lines=[
              ln for ln in ectx["logs"] if ln.startswith(("[comm]",
                                                          "[moe]"))],
          note="4 logical ranks share one card and run one after another: "
               "not a multi-card step time")
    return ectx


def ep_step(cfg, mesh):
    """The launcher's step for the EP cell, under its sharding context."""
    from repro_torch.models import build_model
    from repro_torch.models.sharding import make_ctx, use_sharding
    from repro_torch.optim import cosine_with_warmup, make_optimizer
    from repro_torch.train.step import make_sharded_train_step

    inner = make_sharded_train_step(
        build_model(cfg), make_optimizer(cfg.optimizer),
        cosine_with_warmup(3e-4, 20, 21), mesh)
    ctx = make_ctx(mesh, overrides=cfg.sharding_overrides)

    def step(state, batch):
        with use_sharding(ctx):
            return inner(state, batch)

    return step


def rel_l2(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 26) -> float:
    """||a - b|| / ||b||, the squares summed in fp64 a chunk of the
    flattened tensors at a time: an fp64 copy of a whole stacked expert
    leaf (1.6 G elements) would not fit beside two gradient trees."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for i in range(0, b.numel(), chunk):
        x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
        num += float((x - y).square().sum())
        den += float(y.square().sum())
    return math.sqrt(num / max(den, 1e-60))


def ep_check_phase(dev, ectx: dict, failures: list) -> None:
    """``[ep-check]``: (1) the run's weights and first batch through one
    forward and backward (no update) under EP, then through the einsum
    path: EP taken in the forward and in the "full" remat's recompute (and
    the einsum path in both without the context), loss and aux within
    ``EP_CHECK_TOL["scalar"]``, every gradient leaf within
    ``EP_CHECK_TOL["grad"]`` (relative L2).  (2) The FFN alone at full
    width, x (4, 2048, 4096) bf16 and layer 0's experts, on each mesh of
    ``EP_FFN_MESHES`` against the einsum path: output within
    ``EP_CHECK_TOL["ffn"]`` (relative L2), aux within the scalar limit, and
    the device time of each (one card: the ranks in series)."""
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.sharding import make_ctx, use_sharding
    from repro_torch.tree import leaves

    cfg, run = ectx["cfg"], ectx["run"]
    params = ectx["state"].params
    model = build_model(cfg)
    batch = synthetic_batch(cfg, run, 0, dev)
    ctx = make_ctx(ep_mesh(dev), overrides=cfg.sharding_overrides)
    flat = leaves(params)
    out = {}
    for path in ("ep_a2a", "einsum"):
        moe_mod.reset_ep_calls()
        with use_sharding(ctx if path == "ep_a2a" else None):
            loss, met = model.loss(params, batch)
            fwd_calls = dict(moe_mod.EP_CALLS)
            grads = torch.autograd.grad(loss, flat)
        n = cfg.num_layers
        calls = {"forward": fwd_calls, "with_recompute":
                 dict(moe_mod.EP_CALLS)}
        if calls != {"forward": {path: n}, "with_recompute": {path: 2 * n}}:
            failures.append(f"ep-check {path}: MoE calls by path {calls}")
        out[path] = (float(loss.detach()), float(met["aux"].detach()),
                     grads, calls)
        del loss, met, grads
    (l_ep, a_ep, g_ep, c_ep), (l_e, a_e, g_e, _) = out["ep_a2a"], \
        out["einsum"]
    names = leaf_names(params)
    errs = {name: rel_l2(a, b) for name, a, b in zip(names, g_ep, g_e)}
    del out, g_ep, g_e
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    scal = {"loss": abs(l_ep - l_e) / abs(l_e), "aux": abs(a_ep - a_e)
            / abs(a_e)}
    ok = (max(scal.values()) <= EP_CHECK_TOL["scalar"]
          and max(errs.values()) <= EP_CHECK_TOL["grad"])
    if not ok:
        failures.append(f"ep-check: scalars {scal}, worst gradient leaves "
                        f"{worst} over {EP_CHECK_TOL}")
    phase("ep-check-step", loss={"ep_a2a": l_ep, "einsum": l_e},
          aux={"ep_a2a": a_ep, "einsum": a_e}, rel_err=scal,
          grad_rel_l2_worst=dict(worst), leaves=len(errs),
          moe_calls=c_ep, tol=EP_CHECK_TOL, ok=ok)

    # the FFN alone, at full width
    torch.cuda.empty_cache()
    moe = cfg.moe
    p = {k: v[0].detach() for k, v in params["blocks"]["moe"].items()}
    x = torch.randn((run["batch"], run["seq"], cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev).to(torch.bfloat16)
    cdt = torch.bfloat16
    rows = {}
    with torch.no_grad():
        y_e, aux_e = moe_mod.moe_ffn(p, x, moe, cdt)      # no context
        rows["einsum"] = {"ms": cuda_ms(lambda: moe_mod.moe_ffn(
            p, x, moe, cdt), iters=3, warmup=1)}
        for shape in EP_FFN_MESHES:
            fctx = make_ctx(ep_mesh(dev, shape))
            moe_mod.reset_ep_calls()
            with use_sharding(fctx):
                y, aux = moe_mod.moe_ffn(p, x, moe, cdt)
                calls = dict(moe_mod.EP_CALLS)
                ms = cuda_ms(lambda: moe_mod.moe_ffn(p, x, moe, cdt),
                             iters=3, warmup=1)
            err = rel_l2(y, y_e)
            aux_err = abs(float(aux) - float(aux_e)) / abs(float(aux_e))
            name = f"ep_a2a data {shape[0]} x model {shape[1]}"
            rows[name] = {"ms": ms, "y_rel_l2": err,
                          "y_max_abs_err": max_err(y, y_e),
                          "aux_rel_err": aux_err, "moe_calls": calls}
            if (calls != {"ep_a2a": 1} or err > EP_CHECK_TOL["ffn"]
                    or aux_err > EP_CHECK_TOL["scalar"]):
                failures.append(f"ep-check {name}: {rows[name]}")
            del y
    slots = moe_mod.capacity(moe, moe_mod.group_size(moe, x.shape[0]
                                                     * x.shape[1]))
    phase("ep-check-ffn", x=list(x.shape), dtype="bfloat16",
          experts=moe.num_experts, top_k=moe.top_k, capacity=slots,
          tol=EP_CHECK_TOL["ffn"], paths=rows,
          note="one card: every rank's work in series")


def ep_parity_phase(dev, ectx: dict, failures: list) -> None:
    """``[ep-parity]``: the all-to-all bytes of one forward pass of the run's
    model, as executed (``mesh.TRAFFIC["all_to_all"]``), as the twin
    (layers x 2 exchanges x 4 ranks x ``moe_a2a_bytes`` at the compute
    dtype's itemsize, 2 for bf16), and as the
    estimator prices the all-to-all nodes of ``model_pipeline_graph`` for
    the same strategy (dp 4, one microbatch of 1 x 2048 a rank): each node
    is one rank's dispatch, so times its group of 4, times 2 for the
    return exchange that the graph does not carry.  All equal
    ``EP_A2A_FORWARD_BYTES``.  A train step moves twice the forward's: the
    "full" remat recomputes each layer, its exchanges included; the
    backward's transposed exchanges are autograd's copies, not counted."""
    from repro_torch.core.estimator import dist_comm_bytes
    from repro_torch.core.strategy import Strategy, model_pipeline_graph
    from repro_torch.dist import mesh as M
    from repro_torch.dist.ep_a2a import moe_a2a_bytes
    from repro_torch.models import build_model
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.sharding import make_ctx, use_sharding

    cfg, run = ectx["cfg"], ectx["run"]
    model = build_model(cfg)
    dp = run["ranks"]
    batch = synthetic_batch(cfg, run, 0, dev)
    M.reset_traffic()
    with torch.no_grad(), use_sharding(make_ctx(ep_mesh(dev))):
        model.loss(ectx["state"].params, batch)
    executed = M.TRAFFIC.get("all_to_all", 0)
    tokens_local = run["batch"] // dp * run["seq"]
    itemsize = dtype_of(cfg.compute_dtype).itemsize
    payload = moe_a2a_bytes(cfg.moe, tokens_local, cfg.d_model, itemsize)
    twin = cfg.num_layers * 2 * dp * payload
    graph = model_pipeline_graph(cfg, Strategy(dp=dp), run["batch"] // dp,
                                 run["seq"])
    a2a = [n for n in graph.nodes if n.kind == "all-to-all"]
    sim_dispatch = sum(dist_comm_bytes(n) for n in a2a)
    sim = 2 * sum(dist_comm_bytes(n) * n.group_size for n in a2a)
    per_step = ectx["traffic"].get("all_to_all", 0) / run["steps"]
    ok = (executed == twin == sim == EP_A2A_FORWARD_BYTES
          and per_step == 2 * executed)
    phase("ep-parity", all_to_all_bytes_forward={
        "executed": executed, "twin": twin, "simulated": sim,
        "expected": EP_A2A_FORWARD_BYTES},
          payload_per_rank=payload, simulated_nodes=len(a2a),
          simulated_dispatch_per_device=sim_dispatch,
          train_step_executed=per_step,
          train_step_note="the full remat recomputes each layer's "
                          "exchanges: 2 x the forward's",
          ok=ok)
    if not ok:
        failures.append("ep-parity: executed, twin and simulated "
                        "all-to-all bytes differ")


def ep_plan_phase(dev, ectx: dict, db, failures: list) -> None:
    """``[ep-plan]``: one EP-cell layer profiled on the card (forward and
    backward at a microbatch of 1 x 2048, the einsum FFN on one rank's
    tokens, as a rank computes it), then the cell's strategy (dp 4, experts
    over the data ranks) priced from that profile on 4 H100 SXM
    (data-sheet NVLink for the collectives) and simulated: the step, its
    all-to-all time and share.  Simulated, not compared with the one-card
    wall time of 4 ranks in series."""
    from repro_torch.core.estimator import OpTimeEstimator
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.simulator import simulate
    from repro_torch.core.strategy import Strategy, model_pipeline_graph
    from repro_torch.models.pipeline import model_layer_cost, profile_layer

    cfg, run = ectx["cfg"], ectx["run"]
    dp, mbs = run["ranks"], run["batch"] // run["ranks"]
    t0 = time.perf_counter()
    layer = profile_layer(db, H100_SXM.name, cfg, mbs, run["seq"], dev)
    profile_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    est = OpTimeEstimator(H100_SXM, db)
    strategy = Strategy(dp=dp)
    graph = model_pipeline_graph(
        cfg, strategy, mbs, run["seq"],
        cost=model_layer_cost(cfg, mbs, run["seq"], db=db,
                              platform=H100_SXM.name))
    res = simulate(graph, est.duration, record_events=False)
    chunks = sum(n.kind in ("fwd", "bwd") for n in graph.nodes)
    if est.layer_chunks != chunks:
        failures.append(f"ep-plan: {est.layer_chunks} of {chunks} chunks "
                        "priced from the measured layer")
    a2a_s = sum(v for k, v in res.time_by_kind.items()
                if k.startswith("link:ep"))
    phase("ep-plan", strategy=strategy.describe(), simulated=True,
          platform=H100_SXM.name, chips=dp, micro_batch=mbs,
          seq=run["seq"], simulated_step_ms=1e3 * res.makespan,
          simulated_ms_by_kind={k: 1e3 * v
                                for k, v in res.time_by_kind.items()},
          all_to_all_ms=1e3 * a2a_s,
          all_to_all_share=a2a_s / res.makespan,
          layer_profile_ms={k[:-2] + "_ms": 1e3 * v
                            for k, v in layer.items()},
          profile_seconds=profile_s, estimator_stats=dict(est.stats),
          note="the graph carries one dispatch all-to-all a MoE layer and "
               "forward, and the gradient all-reduce of the whole tree "
               "(the reference's strategy graph)")


def ep_kernel_table(dev, gen, platform, launches, failures: list) -> list:
    """The kernels at the EP step's shapes (x (4, 2048, 4096); q 64 heads
    against k/v 4 heads of 128): RMSNorm and flash attention, launches
    from ``[ep-train]``."""
    cfg, chip = ep_config(), platform.chip
    steps = EP["steps"]
    return [
        rmsnorm_row(dev, gen, chip, "rmsnorm@ep-train",
                    (EP["batch"], EP["seq"], cfg.d_model), cfg.norm_eps,
                    launches["rmsnorm"], launches["rmsnorm"] / steps,
                    failures),
        flash_train_row(dev, gen, chip, "ep-train",
                        launches["flash_attention"],
                        launches["flash_attention"] / steps, failures)]


def ep_phases(dev, gen, platform, db, failures: list) -> list:
    """The expert-parallel phases, in order (ep-train, ep-train-profile,
    ep-check, ep-parity, ep-plan), the layer profiled into ``db``; returns
    the kernel rows at the EP step's shapes."""
    ectx = ep_train_phase(dev, failures)
    profile_train_step(dev, ectx, "ep-train-profile",
                       step=ep_step(ectx["cfg"], ep_mesh(dev)))
    ectx["state"] = ectx["state"]._replace(opt_state=None)
    torch.cuda.empty_cache()
    ep_check_phase(dev, ectx, failures)
    torch.cuda.empty_cache()
    ep_parity_phase(dev, ectx, failures)
    ectx["state"] = None
    torch.cuda.empty_cache()
    ep_plan_phase(dev, ectx, db, failures)
    torch.cuda.empty_cache()
    return ep_kernel_table(dev, gen, platform, ectx["launches"], failures)


# -- phases 27-31: the launchers' checks and telemetry -------------------------


def shard_logits_check(dev, ctx: dict, failures: list) -> dict:
    """The slot-sharded decode's logits against the unsharded decode's on
    one fixed mid-run batch: a pool of random K/V, each lane on its own
    blocks at the mid-run lengths, random tokens; and each of the two
    against the unsharded decode in fp32 compute on the same weights,
    pool and tokens (printed, not gated: what bf16 rounding alone moves).
    The limit is ``SHARD["tol"]`` of the logits' scale; the argmax must
    agree on every lane whose top-2 margin exceeds the measured error."""
    from repro_torch.models.build import compute_params, to_device
    from repro_torch.serve import paged

    cfg, scfg, params, mesh = (ctx["cfg"], ctx["scfg"], ctx["params"],
                               ctx["mesh"])
    g = torch.Generator(device=dev).manual_seed(SHARD["seed"])
    s, mb = scfg.slots, scfg.max_blocks_per_slot
    lens = torch.tensor(mid_run_lengths(ctx), dtype=torch.int32, device=dev)
    tables = (torch.arange(s * mb, dtype=torch.int32, device=dev).view(s, mb)
              + 1)
    toks = torch.randint(0, cfg.vocab_size, (s, 1), generator=g, device=dev,
                         dtype=torch.int32)
    pool = paged.init_pool(cfg, scfg, dev)
    for t in pool.values():
        t.copy_(torch.randn(t.shape, generator=g, device=dev).to(t.dtype))
    with torch.inference_mode():
        plain, _ = paged.decode_batch(params, pool, toks, lens, tables, cfg,
                                      scfg)
        sharded, _ = paged.decode_slot_sharded(
            paged.replicas(params, pool, mesh), toks, lens, tables, cfg,
            scfg, mesh)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        pool32 = {k: v.float() for k, v in pool.items()}
        fp32, _ = paged.decode_batch(
            compute_params(to_device(ctx["master_params"], dev), cfg32),
            pool32, toks, lens, tables, cfg32, scfg)
        del pool32
    torch.cuda.synchronize()
    err, scale = max_err(sharded, plain), float(plain.abs().max())
    to_fp32 = {"unsharded": max_err(plain, fp32),
               "sharded": max_err(sharded, fp32)}
    top2 = plain[:, -1].float().topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    agree = (torch.argmax(sharded[:, -1], -1)
             == torch.argmax(plain[:, -1], -1)).tolist()
    decided = [i for i, m in enumerate(margin) if m > err]
    if not (torch.isfinite(sharded).all() and sharded.shape == plain.shape
            and err <= SHARD["tol"] * max(1.0, scale)):
        failures.append(f"serve-shard: sharded decode logits differ from the "
                        f"unsharded by {err:.3g} (scale {scale:.3g}, limit "
                        f"{SHARD['tol']} of it)")
    if not all(agree[i] for i in decided):
        failures.append(f"serve-shard: argmax differs on a lane whose top-2 "
                        f"margin exceeds the error: {margin}, {agree}")
    return {"max_abs_err": err, "logit_scale": scale,
            "max_abs_err_to_fp32": to_fp32,
            "tol": SHARD["tol"], "top2_margin": margin,
            "argmax_agree": agree, "lanes_decided": decided,
            "lengths": lens.tolist()}


def serve_shard_phase(dev, failures: list) -> dict:
    """``[serve-shard]``: llama3.2-1b at full width served with its decode
    slot-sharded over ``SHARD["ranks"]`` logical ranks of the card (2 of the
    8 slots a rank): ``calibrate_serve(mesh=)`` into a ProfileDB at the
    trace's mean decode context (two passes, as [serve]), the engine over
    the serve trace (launches asserted: every rank's decode is a forward),
    the replay twin (compositions equal) and the priced twin; the sharded
    decode's logits against the unsharded decode's (``shard_logits_check``).
    The decode step's busy and wall time come later
    (``shard_decode_profile``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.database import ProfileDB
    from repro_torch.core.estimator import OpTimeEstimator
    from repro_torch.core.hardware import platform_for_device
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.cost import calibrate_serve
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.policy import ServeConfig
    from repro_torch.serve.report import (
        latency_report, records_from_requests, serve_parity_report,
    )
    from repro_torch.serve.sim import replay_schedule, simulate_serve
    from repro_torch.serve.trace import prompt_tokens

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    platform = platform_for_device(torch.cuda.get_device_name(dev))
    scfg = ServeConfig(**SERVE)
    mesh = make_mesh((SHARD["ranks"],), ("serve",), dev)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    trace = serve_trace()
    context = trace_context(trace, scfg)
    # two calibration passes, as [serve]: the first also warms the host up
    # (the sharded steps are host-bound); the twins price from the second
    dbs = []
    t0 = time.perf_counter()
    for _ in range(CAL_PASSES):
        dbs.append(ProfileDB())
        n_entries = calibrate_serve(dbs[-1], model, params, scfg,
                                    platform.name, repeats=CAL_REPEATS,
                                    device=dev, context=context, mesh=mesh)
    t_cal = time.perf_counter() - t0
    db = dbs[-1]

    engine = ServeEngine(model, params, device=dev, mesh=mesh, **SERVE)
    engine.warmup()
    for t in trace:
        engine.submit(Request(rid=t.rid,
                              prompt=prompt_tokens(t, cfg.vocab_size),
                              max_new_tokens=t.max_new_tokens,
                              arrival_s=t.arrival_s))
    counters = {k: c for k, c in kernel_counters().items()
                if k != "ssd_scan"}
    # the main path: counts from zero, read right after
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    finished = engine.run_until_done()
    t_run = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    n_prefill = sum(1 for st in engine.step_log if st[2] is not None)
    n_decode = sum(1 for st in engine.step_log if st[3])
    # a prefill chunk is one forward (one replica: every rank on the card);
    # a decode step one forward a rank
    forwards = n_prefill + SHARD["ranks"] * n_decode
    per_fwd = {"rmsnorm": 2 * cfg.num_layers + 1,
               "flash_attention": cfg.num_layers}
    for name, per in per_fwd.items():
        if launches[name] != per * forwards or launches[name] == 0:
            failures.append(f"serve-shard: {name} {launches[name]} launches, "
                            f"expected {per} x {forwards} forward calls")
    for r in finished:
        want = scfg.effective_max_tokens(len(r.prompt), r.max_new_tokens)
        if len(r.output) != want or not all(0 <= t < cfg.vocab_size
                                            for t in r.output):
            failures.append(f"serve-shard: request {r.rid} has "
                            f"{len(r.output)} tokens (expected {want})")
    if len(finished) != len(trace):
        failures.append(f"serve-shard: {len(finished)}/{len(trace)} "
                        "requests finished")
    records = records_from_requests(finished)
    eng_lat = latency_report(records, max(t for r in finished
                                          for t in r.token_times_s))
    sim = simulate_serve(trace, cfg, scfg,
                         OpTimeEstimator(platform, db=db, use_learned=False),
                         name=f"serve-{cfg.name}")
    twin = replay_schedule(trace, scfg, engine.step_durations)
    report = serve_parity_report(engine.step_log, twin.step_log,
                                 engine_latency=eng_lat,
                                 sim_latency=sim.latency)
    if not report["composition_ok"]:
        failures.append(f"serve-shard: step compositions differ: "
                        f"{report['composition_mismatches'][:2]}")

    ctx = {"cfg": cfg, "scfg": scfg, "params": engine.params, "mesh": mesh,
           "trace": trace, "platform": platform, "db": db,
           "launches": launches, "forward_calls": forwards,
           "master_params": params}
    check = shard_logits_check(dev, ctx, failures)
    del ctx["master_params"], params
    decode_only = [d for st, d in zip(engine.step_log, engine.step_durations)
                   if st[2] is None and st[3]]
    phase("serve-shard", arch=cfg.name, layers=cfg.num_layers,
          d_model=cfg.d_model, serve=SERVE, ranks=SHARD["ranks"],
          lanes_per_rank=scfg.slots // SHARD["ranks"], trace=TRACE,
          requests=len(finished), steps=len(engine.step_log),
          forward_calls={"prefill": n_prefill, "decode_steps": n_decode,
                         "decode_rank_calls": SHARD["ranks"] * n_decode},
          launches=launches, db_entries=n_entries,
          calibration_context=context,
          db_ms=[{f"{fam}@{e.args.get('tokens', e.args.get('slots'))}":
                  1e3 * e.mean_s
                  for fam in ("serve_prefill", "serve_decode")
                  for e in d.entries(platform.name, fam)} for d in dbs],
          engine_decode_only_ms_p50=1e3 * sorted(decode_only)[
              len(decode_only) // 2] if decode_only else None,
          composition_ok=report["composition_ok"],
          sim_vs_engine_rel_err=report["latency_rel_err"],
          logits=check,
          seconds={"calibrate": t_cal, "engine": t_run,
                   "phase": time.perf_counter() - t_phase})
    return ctx


def shard_decode_profile(dev, ctx: dict) -> None:
    """``[serve-shard-profile]``: the decode step at the mid-run lengths,
    unsharded and slot-sharded: host wall ms, and the card's busy ms and
    launches a step from torch.profiler (``busy_and_wall``)."""
    steps = {}
    for name, m in (("unsharded", None), ("sharded", ctx["mesh"])):
        wall, wall_prof, busy, kernels = busy_and_wall(
            decode_step(dev, ctx, mid_run_lengths(ctx), m), SHARD["steps"])
        steps[name] = {"wall_ms": wall, "wall_ms_profiled": wall_prof,
                       "device_busy_ms": busy if busy > 0 else
                       "not measured",
                       "idle_share": 1.0 - busy / wall_prof,
                       "launches_per_step": sum(e.count for e in kernels)
                       / SHARD["steps"]}
    phase("serve-shard-profile", step="decode", ranks=SHARD["ranks"],
          lengths=mid_run_lengths(ctx), steps_per_run=SHARD["steps"],
          **steps)


def serve_launcher(argv: list) -> tuple:
    """``launch.serve.main(argv)`` with its output captured: (exit code,
    the lines it printed)."""
    import contextlib
    import io

    from repro_torch.launch import serve as launcher

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(argv)
    return rc, buf.getvalue().splitlines()


def serve_obs_phases(dev, ctx: dict, failures: list) -> None:
    """``[serve-obs]``: the serve launcher on the [serve-shard] trace and
    DB, slot-sharded (``--shard --ranks 4``), with ``--obs --trace-out``
    and ``--parity``: the twin re-priced on the engine's measured steps, the
    divergence report (no unmatched span or node), the overlay (parsed as a
    Chrome trace) and the parity verdict (compositions equal; latency not
    gated, as [serve]); ``[serve-analyze]``: the launcher's ``--analyze``
    on the same trace and DB (no error-level finding)."""
    from repro_torch.serve.trace import save_trace

    scfg = ctx["scfg"]
    tmp = tempfile.mkdtemp(prefix="serve-obs-")
    trace_file = os.path.join(tmp, "trace.json")
    db_file = os.path.join(tmp, "db.json")
    overlay = os.path.join(tmp, "serve_overlay.json")
    parity = os.path.join(tmp, "parity.json")
    analyze = os.path.join(tmp, "analyze.json")
    save_trace(trace_file, ctx["trace"])
    ctx["db"].save(db_file)
    shape = ["--arch", ARCH, "--slots", str(scfg.slots), "--max-len",
             str(scfg.max_len), "--block-size", str(scfg.block_size),
             "--chunk", str(scfg.chunk), "--trace-file", trace_file,
             "--db", db_file]

    counters = {k: c for k, c in kernel_counters().items()
                if k != "ssd_scan"}
    # the main path: counts from zero, read right after
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    rc, lines = serve_launcher(shape + [
        "--shard", "--ranks", str(SHARD["ranks"]), "--obs", "--trace-out",
        overlay, "--parity", "--tol-rel", "1e9", "--report", parity])
    seconds = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    if rc != 0 or not all(launches.values()):
        failures.append(f"serve-obs: launcher exit {rc}, launches "
                        f"{launches}")
    with open(os.path.splitext(overlay)[0] + "_report.json") as f:
        rep = json.load(f)
    with open(parity) as f:
        par = json.load(f)
    m = {k: v for k, v in rep["metrics"].items() if k.startswith("obs_")}
    if m.get("obs_unmatched_real") != 0 or m.get("obs_unmatched_sim") != 0:
        failures.append(f"serve-obs: unmatched spans or nodes {m}")
    if not par["composition_ok"]:
        failures.append("serve-obs: the sharded engine's compositions "
                        "differ from the replay twin's")
    try:
        sides = chrome_trace_ok(overlay)
    except (OSError, ValueError, KeyError) as e:
        sides = None
        failures.append(f"serve-obs: overlay is not a Chrome trace: {e}")
    classes = rep["extras"]["obs_diff"]["classes"]
    phase("serve-obs", metrics=m,
          codes=sorted(f["code"] for f in rep["findings"]),
          classes=classes, overlay_events=sides, launches=launches,
          composition_ok=par["composition_ok"],
          sim_vs_engine_rel_err=par["latency_rel_err"],
          run_spec=rep["extras"].get("run_spec"), seconds=seconds,
          lines=[ln for ln in lines if ln.startswith("[serve] ")])

    t0 = time.perf_counter()
    rc, lines = serve_launcher(shape + ["--analyze", "--analyze-report",
                                        analyze])
    with open(analyze) as f:
        doc = json.load(f)
    if rc != 0 or doc["counts"]["error"] != 0:
        failures.append(f"serve-analyze: exit {rc}, counts {doc['counts']}")
    phase("serve-analyze", counts=doc["counts"],
          codes=sorted(f["code"] for f in doc["findings"]),
          metrics=doc["metrics"], seconds=time.perf_counter() - t0)
    shutil.rmtree(tmp, ignore_errors=True)


def obs_phases(dev, gen, failures: list) -> list:
    """This slice's serve phases, in order (serve-shard, serve-obs,
    serve-analyze, serve-shard-profile); returns the kernel rows at the
    sharded decode's shape (one rank's lanes), launches from
    [serve-shard]."""
    ctx = serve_shard_phase(dev, failures)
    serve_obs_phases(dev, ctx, failures)
    shard_decode_profile(dev, ctx)
    rows = kernel_table(dev, gen, ctx, failures, "serve-shard-",
                        lanes=ctx["scfg"].slots // SHARD["ranks"],
                        phases=("decode",))
    del ctx
    torch.cuda.empty_cache()
    return rows


# -- this slice: checkpoint and resume, fault tolerance, the interconnect sweep


def ckpt_state_bytes(cfg) -> int:
    """Bytes of a train state under AdamW: the parameters, both fp32
    moments and the two int32 counters (step, count)."""
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    params, _ = build_model(cfg).abstract_params()
    return sum(math.prod(p.shape) * (p.dtype.itemsize + 8)
               for p in leaves(params)) + 8


def state_diff(a, b) -> dict:
    """Two train states compared by part (``params``, ``opt_state/m``,
    ``opt_state/v``, the counters): leaves, leaves equal bit for bit, the
    largest absolute difference and the largest relative L2 difference of
    a leaf."""
    from repro_torch.tree import flatten_with_path

    other = dict(flatten_with_path(b))
    out: dict = {}
    for path, x in flatten_with_path(a):
        y = other[path]
        part = ("/".join(path[:2]) if path[:2] in (("opt_state", "m"),
                                                   ("opt_state", "v"))
                else "params" if path[0] == "params" else "counters")
        d = out.setdefault(part, {"leaves": 0, "equal": 0, "max_abs": 0.0,
                                  "max_rel_l2": 0.0})
        d["leaves"] += 1
        if torch.equal(x, y):
            d["equal"] += 1
            continue
        d["max_abs"] = max(d["max_abs"],
                           float((x.double() - y.double()).abs().max()))
        d["max_rel_l2"] = max(d["max_rel_l2"], rel_l2(x.float(), y.float()))
    return out


def ckpt_run(dev, cfg, tag: str, steps: int, failures: list, ckpt_dir=None,
             counters=None) -> dict:
    """``launch.train.train`` on the [ckpt] run's shape up to ``steps``,
    with ``ckpt_dir`` or none; per step the loss, times, launches (each
    must be ``train_launches``'s) and the straggler verdict."""
    from repro_torch.launch.train import train

    want = train_launches(cfg, CKPT["grad_accum"])
    counters = counters or kernel_counters()
    seen = {k: c.count for k, c in counters.items()}
    steps_out, events, logs = [], [], []

    def on_step(i, rec):
        rec = dict(rec, step=i + 1, launches={
            k: c.count - seen[k] for k, c in counters.items()},
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        torch.cuda.reset_peak_memory_stats(dev)
        seen.update({k: c.count for k, c in counters.items()})
        steps_out.append(rec)
        phase(f"ckpt-{tag}-step", **rec)
        for k, n in rec["launches"].items():
            if n != want[k]:
                failures.append(f"ckpt {tag} step {i + 1}: {n} {k} "
                                f"launches, expected {want[k]}")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, losses = train(cfg, steps=steps, seq=CKPT["seq"],
                          batch=CKPT["batch"], grad_accum=CKPT["grad_accum"],
                          seed=CKPT["seed"], device=dev, ckpt_dir=ckpt_dir,
                          on_step=on_step, on_ckpt=events.append,
                          log_fn=logs.append)
    torch.cuda.synchronize(dev)
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"ckpt {tag}: non-finite losses {losses}")
    return {"state": state, "losses": losses, "steps": steps_out,
            "events": events, "seconds": time.perf_counter() - t0,
            "lines": [ln for ln in logs
                      if ln.startswith(("[restore]", "[ckpt]"))]}


def ckpt_phase(dev, failures: list) -> dict:
    """``[ckpt]`` and ``[ft]``: llama3.2-1b at full width and depth trained
    through ``launch.train.train`` with a checkpoint directory: (A)
    ``CKPT["first"]`` steps into a fresh directory, (B) the same directory
    to ``CKPT["steps"]`` (restored from step ``first``), (C) the same steps
    with no directory.  A and B are the path: the kernel counts go from 0
    before A and are read after B.  B's losses after the restore and its
    final parameters and moments are held against C's bit for bit (or, if
    two uninterrupted runs differ, against ``spread_factor`` times their
    spread); the checkpoint's bytes, the blocking snapshot, the background
    write and the restore are timed, the disk's free space checked first;
    the directory is removed afterwards.  ``[ft]``: the heartbeat file and
    the straggler policy's verdict on each step."""
    from repro_torch.configs.base import get_config

    cfg = get_config(DENSE_ARCH)
    need = ckpt_state_bytes(cfg)
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    free = shutil.disk_usage(base).free
    if free < 2.05 * need:
        failures.append(f"ckpt: two checkpoints of {need} bytes do not fit "
                        f"the {free} bytes free under {base}")
        phase("ckpt", ok=False, checkpoint_bytes=need, free_bytes=free)
        return {"launches": None}
    counters = kernel_counters()
    root = tempfile.mkdtemp(prefix="ckpt-", dir=base)
    try:
        # the main path: counts from zero before A, read right after B
        for c in counters.values():
            c.reset()
        a = ckpt_run(dev, cfg, "A", CKPT["first"], failures, root, counters)
        a["state"] = None
        b = ckpt_run(dev, cfg, "B", CKPT["steps"], failures, root, counters)
        launches = {k: c.count for k, c in counters.items()}
        listing = sorted(os.listdir(root))
        with open(os.path.join(root, "hb", "host_0.hb")) as f:
            heartbeat = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    c = ckpt_run(dev, cfg, "C", CKPT["steps"], failures)
    first = CKPT["first"]
    diff = state_diff(b["state"], c["state"])
    bitwise = (all(d["equal"] == d["leaves"] for d in diff.values())
               and b["losses"] == c["losses"][first:])
    spread = None
    if not bitwise:
        # two uninterrupted runs: the nondeterminism B is held to
        c2 = ckpt_run(dev, cfg, "C2", CKPT["steps"], failures)
        spread = state_diff(c2["state"], c["state"])
        spread["losses"] = [abs(x - y) for x, y in
                            zip(c2["losses"], c["losses"])]
        c2["state"] = None
        k = CKPT["spread_factor"]
        for part, d in diff.items():
            lim = k * spread[part]["max_rel_l2"]
            if d["max_rel_l2"] > lim:
                failures.append(f"ckpt: resumed {part} differs from the "
                                f"uninterrupted run by {d['max_rel_l2']:.3g} "
                                f"(relative L2), over {k} x the spread of "
                                f"two uninterrupted runs ({lim:.3g})")
        lim = k * max(spread["losses"][first:])
        for x, y in zip(b["losses"], c["losses"][first:]):
            if abs(x - y) > lim:
                failures.append(f"ckpt: resumed loss {x} vs {y}, over "
                                f"{lim:.3g}")
    want_steps = {"A": list(range(1, first + 1)),
                  "B": list(range(first + 1, CKPT["steps"] + 1))}
    for tag, run in (("A", a), ("B", b)):
        if [r["step"] for r in run["steps"]] != want_steps[tag]:
            failures.append(f"ckpt {tag}: steps "
                            f"{[r['step'] for r in run['steps']]}, expected "
                            f"{want_steps[tag]}")
    saves = {tag: next(e for e in run["events"] if e["event"] == "save")
             for tag, run in (("A", a), ("B", b))}
    restored = [e for e in b["events"] if e["event"] == "restore"]
    if not restored or restored[0]["step"] != first:
        failures.append(f"ckpt B: restore events {b['events']}")
    if listing != ["hb", f"step_{first:08d}",
                   f"step_{CKPT['steps']:08d}"]:
        failures.append(f"ckpt: directory holds {listing}")
    if saves["A"]["bytes"] != need:
        failures.append(f"ckpt: {saves['A']['bytes']} bytes written, "
                        f"expected {need}")
    phase("ckpt", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
          **{k: v for k, v in CKPT.items() if k != "spread_factor"},
          free_bytes_before=free, directory_base=base,
          checkpoint_bytes=saves["A"]["bytes"],
          snapshot_ms={t: 1e3 * e["snapshot_s"] for t, e in saves.items()},
          write_s={t: e["write_s"] for t, e in saves.items()},
          restore_s=restored[0]["seconds"] if restored else None,
          run_seconds={"A": a["seconds"], "B": b["seconds"],
                       "C": c["seconds"]},
          losses={"A": a["losses"], "B": b["losses"], "C": c["losses"]},
          resumed_equals_uninterrupted_bitwise=bitwise, state_diff=diff,
          uninterrupted_spread=spread, launches=launches,
          launcher_lines=a["lines"] + b["lines"], listing=listing)
    phase("ft", heartbeat=heartbeat,
          straggler_verdicts={t: [r["straggler"] for r in run["steps"]]
                              for t, run in (("A", a), ("B", b),
                                             ("C", c))})
    if heartbeat.get("step") != CKPT["steps"] - 1:
        failures.append(f"ft: heartbeat {heartbeat}")
    return {"launches": launches}


def ckpt_kernel_table(dev, gen, platform, launches, failures: list) -> list:
    """The kernels at the [ckpt] runs' shapes (one llama3.2-1b microbatch
    of 2 x 2048), launches from runs A and B."""
    from repro_torch.configs.base import get_config

    cfg, chip = get_config(DENSE_ARCH), platform.chip
    steps = CKPT["steps"]       # A's and B's together

    def counts(kernel):
        return ((None, None) if launches is None
                else (launches[kernel], launches[kernel] / steps))

    b, s = CKPT["batch"] // CKPT["grad_accum"], CKPT["seq"]
    return [rmsnorm_row(dev, gen, chip, "rmsnorm@ckpt-train",
                        (b, s, cfg.d_model), cfg.norm_eps,
                        *counts("rmsnorm"), failures),
            flash_train_row(dev, gen, chip, "ckpt-train",
                            *counts("flash_attention"), failures)]


def netprof_phase(dev, failures: list) -> None:
    """``[netprof]``: the collective sweep over ``NETPROF["ranks"]``
    logical ranks of the card (every kind, dtype and axis of the grid),
    the concurrent sweep, the entries by kind and group, the fitted
    latency and wire rate, ``calibrate --verify`` on the saved DB, the
    acceptance graph and the [pp-plan] pp = 2 x dp = 2 int8 plan priced
    measured against the H100 SXM data sheet's NVLink ring, and the train
    launcher's plan and parity reports with ``--netprof-db``: every
    collective node priced from measurements."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.database import ProfileDB
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.strategy import model_pipeline_graph
    from repro_torch.launch import train as launcher
    from repro_torch.models import build_model
    from repro_torch.models.pipeline import make_plan
    from repro_torch.netprof import calibrate
    from repro_torch.netprof.model import COLLECTIVES, fit_link_contention
    from repro_torch.netprof.pricing import PROV_RING
    from repro_torch.netprof.report import acceptance_graph, measured_vs_ring
    from repro_torch.netprof.sweep import (
        SweepConfig,
        mesh_plans,
        sweep_collectives,
        sweep_concurrent,
    )

    name = H100_SXM.name
    cfg_sweep = SweepConfig(payload_bytes=NETPROF["payload_bytes"],
                            dtypes=NETPROF["dtypes"],
                            repeats=NETPROF["repeats"])
    db = ProfileDB()
    t0 = time.perf_counter()
    n = sweep_collectives(db, platform=name, config=cfg_sweep,
                          ranks=NETPROF["ranks"], device=dev)
    sweep_s = time.perf_counter() - t0
    axes = sum(len(p.sweep_axes) for p in mesh_plans(NETPROF["ranks"]))
    want = (len(cfg_sweep.collectives) * len(cfg_sweep.payload_bytes)
            * len(cfg_sweep.dtypes) * axes)
    if n != want:
        failures.append(f"netprof: {n} entries, expected {want}")
    t0 = time.perf_counter()
    nc = sweep_concurrent(db, platform=name,
                          config=SweepConfig(repeats=NETPROF["repeats"]),
                          streams=NETPROF["streams"], ranks=NETPROF["ranks"],
                          device=dev)
    concurrent_s = time.perf_counter() - t0
    by_kind = {}
    for kind in COLLECTIVES:
        for e in db.entries(name, kind):
            g = by_kind.setdefault(kind, {}).setdefault(
                f"g{e.args['devices']}", {"entries": 0, "us": {}})
            g["entries"] += 1
            if e.args["dtype"] == "float32":
                key = f"{e.args['per_device_bytes']}B@{e.args['axis']}"
                g["us"][key] = 1e6 * e.mean_s
    tmp = tempfile.mkdtemp(prefix="netprof-")
    try:
        path = os.path.join(tmp, "netprof_db.json")
        db.save(path)
        verify_lines: list = []
        rc = calibrate.verify(path, log_fn=verify_lines.append)
        if rc:
            failures.append(f"netprof: calibrate --verify exit {rc}: "
                            f"{verify_lines[-1:]}")
        acceptance = measured_vs_ring(acceptance_graph(), db, H100_SXM)
        cfg = get_config(DENSE_ARCH)
        plan = make_plan(cfg, PP["pp"], PP["microbatches"],
                         schedule=PP["schedule"])
        mbs = PP["batch"] // (PP["dp"] * PP["microbatches"])
        params, _ = build_model(cfg).abstract_params()
        graph = model_pipeline_graph(
            cfg, plan.strategy(dp=PP["dp"], compression=PP["compression"]),
            mbs, PP["seq"], params=params)
        pp_plan = measured_vs_ring(graph, db, H100_SXM)
        logs: list = []
        est, _ = launcher.netprof_estimator(path, log_fn=logs.append)
        launcher.pipeline_plan_report(
            cfg, pp=PP["pp"], schedule=PP["schedule"], vstages=1,
            microbatches=PP["microbatches"], batch=PP["batch"],
            seq=PP["seq"], netprof_db=path, log_fn=logs.append)
        parity = launcher.pipeline_parity_report(
            plan, micro_batch=mbs, seq=PP["seq"], dp=PP["dp"],
            compression=PP["compression"], estimator=est,
            log_fn=logs.append)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for what, r in (("acceptance", acceptance), ("pp-plan", pp_plan)):
        rings = sum(s.get(PROV_RING, 0) for s in r.provenance.values())
        if r.ring_fallbacks or rings:
            failures.append(f"netprof {what}: {rings} collective nodes "
                            f"ring-priced: {r.provenance}")
    launcher_rings = sum(s.get(PROV_RING, 0)
                         for s in parity["provenance"].values())
    if launcher_rings:
        failures.append(f"netprof: the launcher's --netprof-db parity "
                        f"priced {launcher_rings} nodes from the ring")
    fits = {kind: {f"g{g}": {"alpha_us": 1e6 * m.curves[g].alpha,
                             "wire_GB_per_s":
                                 1e-9 / m.curves[g].sec_per_wire_byte}
                   for g in m.groups}
            for kind, m in est.collective_pricer.models.items()}
    contention = fit_link_contention(db, name)
    phase("netprof", ranks=NETPROF["ranks"], dtypes=NETPROF["dtypes"],
          payload_bytes=cfg_sweep.payload_bytes, entries=n,
          entries_expected=want, concurrent_entries=nc, sweep_s=sweep_s,
          concurrent_s=concurrent_s, meta=db.meta(name)["netprof"],
          by_kind_and_group=by_kind, fits=fits,
          contention=contention.describe() if contention else None,
          verify_lines=verify_lines, acceptance_lines=acceptance.lines(),
          pp_plan=plan.strategy(dp=PP["dp"],
                                compression=PP["compression"]).describe(),
          pp_plan_lines=pp_plan.lines(),
          launcher_lines=[ln for ln in logs if ln.startswith(
              ("[netprof]", "[pp-plan]", "[pp-parity]"))],
          note="ring: the H100 SXM data sheet's NVLink (450 GB/s a "
               "direction); measured: 4 logical ranks sharing one card, "
               "their collectives device-local copies, not an NVLink time")


# -- phases 35 and 36: the int8 KV cache, the roofline of the train steps -------


def cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def step_times(step, n: int) -> tuple:
    """Host and CUDA-event milliseconds of each of ``n`` calls of ``step``
    (which ends in a host readback)."""
    host, events = [], []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        t0 = time.perf_counter()
        step()
        host.append(1e3 * (time.perf_counter() - t0))
        ev[1].record()
        ev[1].synchronize()
        events.append(ev[0].elapsed_time(ev[1]))
    return host, events


def int8kv_phase(dev, failures: list) -> dict:
    """``[int8-kv]``: llama3.2-1b at full width and depth through the
    non-paged ``Model.prefill``/``decode`` (``INT8KV``), once with the
    compute-dtype (bf16) cache and once with ``kv_cache_dtype="int8"`` on
    the same weights: the caches' bytes (exact), the int8 run's logits
    against the bf16 run's on the same tokens (it is fed the bf16 run's
    greedy tokens), the card's quantiser against the CPU's on the k/v bits
    the prefill quantised, the launches; then ``[int8-kv-step]``: one decode
    step at mid-run length timed with each cache in the order A B B A, its
    busy time and launches, and the dequantising read alone."""
    from unittest import mock

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.hardware import platform_for_device
    from repro_torch.models import build_model, compute_params, layers

    d = INT8KV
    base = get_config(d["arch"])
    cfgs = {"bfloat16": base,
            "int8": dataclasses.replace(base, kv_cache_dtype="int8")}
    models = {k: build_model(c) for k, c in cfgs.items()}
    params = compute_params(
        models["bfloat16"].init(torch.Generator(device=dev).manual_seed(0)),
        base)
    rng = np.random.default_rng(d["seed"])
    tokens = torch.as_tensor(rng.integers(
        1, base.vocab_size, (d["batch"], d["prompt"]), dtype=np.int32),
        device=dev)
    quantize, seen = layers._kv_quantize, []

    def recording(t):
        seen.append(t)
        return quantize(t)

    forwards = 2 * (1 + d["decode"])
    want = {"ssd_scan": 0, "flash_attention": forwards * base.num_layers,
            "rmsnorm": forwards * (2 * base.num_layers + 1)}
    counters = kernel_counters()
    # this path's run: both caches' prefill and decode, counted from zero
    for c in counters.values():
        c.reset()
    ref_logits, ref_tokens, runs, caches = [], [], {}, {}
    with torch.inference_mode():
        for name, model in models.items():
            t0 = time.perf_counter()
            with mock.patch.object(layers, "_kv_quantize", recording):
                logits, cache = model.prefill(params, tokens, d["max_len"])
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            if name == "bfloat16" and seen:
                failures.append(f"int8-kv: the bf16 cache quantised "
                                f"{len(seen)} tensors")
            step_logits = [logits[:, -1].float()]
            t0 = time.perf_counter()
            for i in range(d["decode"]):
                if name == "bfloat16":
                    ref_tokens.append(torch.argmax(step_logits[-1], -1))
                tok = ref_tokens[i][:, None].to(torch.int32)
                logits, cache = model.decode(params, cache, tok,
                                             d["prompt"] + i)
                step_logits.append(logits[:, -1].float())
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            if not all(bool(torch.isfinite(x).all()) for x in step_logits):
                failures.append(f"int8-kv {name}: logits not finite")
            if name == "bfloat16":
                ref_logits = step_logits
                gaps, agree = None, None
            else:
                gaps = [float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(step_logits, ref_logits)]
                agree = sum(int((torch.argmax(a, -1) == t).sum())
                            for a, t in zip(step_logits, ref_tokens))
                agree /= len(ref_tokens) * d["batch"]
            runs[name] = {"prefill_s": prefill_s, "decode_s": decode_s,
                          "cache_bytes": cache_bytes(cache),
                          "cache_dtypes": sorted({str(t.dtype).split(".")[-1]
                                                  for t in cache.values()}),
                          "logits_gap_by_step": gaps,
                          "greedy_agreement": agree}
            caches[name] = cache
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    if launches != want:
        failures.append(f"int8-kv: launches {launches}, expected {want}")
    for name, nbytes in INT8KV_BYTES.items():
        if runs[name]["cache_bytes"] != nbytes:
            failures.append(f"int8-kv {name}: cache {runs[name]['cache_bytes']}"
                            f" bytes, expected {nbytes}")
    gap = max(runs["int8"]["logits_gap_by_step"])
    if not gap < d["gap_tol"]:
        failures.append(f"int8-kv: logits gap {gap:.4g} of the bf16 logits' "
                        f"scale, limit {d['gap_tol']}")

    # the card's quantiser against the CPU's on the bits the prefill
    # quantised: layer by layer, k then v
    cache8, mism, elems = caches["int8"], 0, 0
    if len(seen) != 2 * base.num_layers:
        failures.append(f"int8-kv: {len(seen)} quantiser calls in the "
                        f"prefill, expected {2 * base.num_layers}")
    for i, t in enumerate(seen):
        layer, name = divmod(i, 2)
        name = "kv"[name]
        q_cpu, s_cpu = quantize(t.cpu())
        q = cache8[name][layer, :, :d["prompt"]].cpu()
        s = cache8[f"{name}_scale"][layer, :, :d["prompt"]].cpu()
        mism += int((q != q_cpu).sum()) + int((s != s_cpu).sum())
        elems += q.numel() + s.numel()
    if mism:
        failures.append(f"int8-kv: {mism} of {elems} int8 values and scales "
                        "differ between the card's quantiser and the CPU's")
    del seen
    phase("int8-kv", arch=base.name, layers=base.num_layers,
          d_model=base.d_model, kv_heads=base.num_kv_heads,
          head_dim=base.resolved_head_dim, batch=d["batch"],
          prompt=d["prompt"], max_len=d["max_len"], decode=d["decode"],
          cache_bytes={k: r["cache_bytes"] for k, r in runs.items()},
          cache_bytes_expected=INT8KV_BYTES,
          cache_ratio=runs["int8"]["cache_bytes"]
          / runs["bfloat16"]["cache_bytes"],
          logits_gap_max=gap, logits_gap_limit=d["gap_tol"],
          quantiser={"calls": 2 * base.num_layers, "elements": elems,
                     "mismatches": mism},
          launches=launches, launches_expected=want, runs=runs)

    # one decode step at mid-run length with each cache, A B B A
    clen = d["prompt"] + d["decode"] // 2
    tok = torch.ones((d["batch"], 1), dtype=torch.int32, device=dev)

    def step_of(name):
        def step():
            with torch.inference_mode():
                logits, _ = models[name].decode(params, caches[name], tok,
                                                clen)
                return torch.argmax(logits[:, -1], -1).cpu()
        return step

    steps = {k: step_of(k) for k in models}
    timed = {k: {"host_ms": [], "event_ms": []} for k in models}
    per_step = {}
    for name in ("bfloat16", "int8", "int8", "bfloat16"):
        for _ in range(3):
            steps[name]()           # warm-up, outside the counts
        before = {k: c.count for k, c in counters.items()}
        host, events = step_times(steps[name], d["steps"] // 2)
        per_step[name] = {k: (c.count - before[k]) / len(host)
                          for k, c in counters.items()}
        timed[name]["host_ms"] += host
        timed[name]["event_ms"] += events
    out = {}
    for name, t in timed.items():
        wall, wall_prof, busy, kernels = busy_and_wall(steps[name],
                                                       d["profiled"])
        out[name] = {
            "host_ms_median": float(np.median(t["host_ms"])),
            "host_ms_min": min(t["host_ms"]), "host_ms_max": max(t["host_ms"]),
            "event_ms_median": float(np.median(t["event_ms"])),
            "wall_ms": wall, "wall_ms_profiled": wall_prof,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "idle_share": 1.0 - busy / wall_prof if busy > 0 else None,
            "kernel_launches_per_step": sum(e.count for e in kernels)
            / d["profiled"],
            "port_launches_per_step": per_step[name]}
        if per_step[name] != {"ssd_scan": 0, "rmsnorm": 33.0,
                              "flash_attention": 16.0}:
            failures.append(f"int8-kv-step {name}: launches a step "
                            f"{per_step[name]}")
    # the dequantising read of one layer alone, and its eager traffic: the
    # casts of the int8 values and the scales, and their product
    lc8 = {k: v[0] for k, v in caches["int8"].items()}
    n, ns = lc8["k"].numel(), lc8["k_scale"].numel()
    read_bytes = 2 * (7 * n + 6 * ns)
    with torch.inference_mode():
        read_ms = cuda_ms(lambda: layers._cache_read(lc8, torch.bfloat16))
    chip = platform_for_device(torch.cuda.get_device_name(dev)).chip
    busy = [out[k]["device_busy_ms"] for k in ("int8", "bfloat16")]
    phase("int8-kv-step", step="decode", batch=d["batch"], length=clen,
          order="ABBA", steps_timed=d["steps"], profiled=d["profiled"],
          caches=out,
          dequant_read={"ms_per_layer": read_ms,
                        "ms_per_step": read_ms * base.num_layers,
                        "eager_bytes_per_layer": read_bytes,
                        "eager_bound_ms_per_layer":
                            1e3 * read_bytes / chip.hbm_bw,
                        "fused_bytes_per_layer": 2 * (n + 2 * ns + 2 * n),
                        "fused_bound_ms_per_layer":
                            1e3 * 2 * (3 * n + 2 * ns) / chip.hbm_bw},
          busy_ms_int8_minus_bf16=(
              busy[0] - busy[1] if all(isinstance(x, float) for x in busy)
              else "not measured"))
    return {"launches": launches, "forwards": forwards, "cfg": base}


def int8kv_kernel_table(dev, gen, platform, ctx, failures: list) -> list:
    """RMSNorm and flash attention at the [int8-kv] path's shapes: the
    decode step (x (8, 1, 2048); q (8, 1, 32, 64) against the whole
    non-paged cache, (8, 2048, 8, 64) bf16, at the mid-run length) and the
    prefill (x (8, 1024, 2048); ``FLASH_TRAIN["int8kv-prefill"]``);
    launches from that run (None where it was not driven)."""
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.ops import cost as fa_cost
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, launch_plan, sm_count,
    )
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask, attention_ref,
    )

    d, chip = INT8KV, platform.chip
    cfg = get_config(d["arch"])
    b, dm, h, kh, hd = (d["batch"], cfg.d_model, cfg.num_heads,
                        cfg.num_kv_heads, cfg.resolved_head_dim)
    launches = ctx["launches"] if ctx else None

    def counts(kernel):
        return ((None, None) if launches is None
                else (launches[kernel], launches[kernel] / ctx["forwards"]))

    rows = [rmsnorm_row(dev, gen, chip, f"rmsnorm@int8kv-{tag}", (b, sq, dm),
                        cfg.norm_eps, *counts("rmsnorm"), failures)
            for tag, sq in (("decode", 1), ("prefill", d["prompt"]))]
    rows.append(flash_train_row(dev, gen, chip, "int8kv-prefill",
                                *counts("flash_attention"), failures))
    for row in rows:
        row["launches_per_forward"] = row.pop("launches_per_step")

    # the decode step: one query a row at the mid-run length, as
    # ``attention_decode`` calls it (causal over absolute positions)
    skv, offs = d["max_len"], [d["prompt"] + d["decode"] // 2] * b
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, skv, kh, hd, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    qo = torch.tensor(offs, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=qo)
    o, ref = flash_attention(q, k, v, **kw), attention_plain(q, k, v, **kw)
    err = max_err(o, ref)
    if not close(o, ref, ATTN_BF16_TOL):
        failures.append(f"flash_attention@int8kv-decode: max abs err "
                        f"{err:.3g} over tolerance {ATTN_BF16_TOL}")
    err_bf16 = max_err(o, attention_ref(q, k, v, **kw))
    del o, ref
    ops_, nbytes = fa_cost(q, k, v, True, qo)
    bms, by = bound_ms(chip, nbytes, ops_, chip.peak_flops)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = attention_mask(b, 1, skv, causal=True, q_offset=qo, kv_len=None,
                          device=dev)[:, None]
    plan = launch_plan(b, 1, skv, h, kh, hd, sm_count(dev.index))
    n_l, per_fwd = counts("flash_attention")
    rows.insert(2, {
        "name": "flash_attention@int8kv-decode", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:127",
        "launches": n_l, "launches_per_forward": per_fwd,
        "shape": f"q ({b}, 1, {h}, {hd}) vs k/v ({b}, {skv}, {kh}, {hd}) "
                 f"bf16, causal, q_offset {offs}",
        "max_abs_err": err, "max_abs_err_vs_plain_rounded": err_bf16,
        "ms": cuda_ms(lambda: flash_attention(q, k, v, **kw)),
        "call_ms": call_ms(lambda: flash_attention(q, k, v, **kw)),
        "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=5),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "plan": {"keys_mode": plan.split_keys, "row_tiles": plan.row_tiles,
                 "splits": plan.splits,
                 "grid": [plan.row_tiles, b * kh, plan.splits],
                 "combine": plan.splits > 1}})
    return rows


def roofline_phase(rows: list, failures: list) -> None:
    """``[roofline]``: the Table-2 rows' traced train steps (``rows``: (cfg,
    simtrain row) pairs, one microbatch of 2 x 2048) through the port's
    copy of ``core/roofline.py`` at the H100 SXM: its row, and beside it the
    fraction at the H100's peak (the copy divides by the TPU v5e peak, ROADMAP
    C17), the row's measured step and busy time, the bound's share of the
    busy time, and the graph's contractions priced at their dtype's rate
    (bf16 on the tensor cores; fp32 at the CUDA cores' rate, TF32 off).
    Gated: compute and memory terms finite and positive, the collective term
    finite and not negative (one card), the model flops 6 N tokens."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.roofline import build_report, to_row

    peak = H100_SXM.chip.peak_flops
    for cfg, row in rows:
        shape = ShapeConfig("simtrain", row["seq"], row["batch"], "train")
        summary = {"flops": row["graph_flops"], "bytes": row["graph_bytes"]}
        r = build_report(cfg, shape, "single", 1, summary, platform=H100_SXM)
        mf = 6.0 * cfg.active_params() * shape.global_batch * shape.seq_len
        if not (all(math.isfinite(t) and t > 0
                    for t in (r.compute_s, r.memory_s))
                and math.isfinite(r.collective_s) and r.collective_s >= 0):
            failures.append(f"roofline {row['name']}: terms {r.compute_s}, "
                            f"{r.memory_s}, {r.collective_s}")
        if r.model_flops_global != mf:
            failures.append(f"roofline {row['name']}: model flops "
                            f"{r.model_flops_global}, expected {mf}")
        dots = row["dot_flops_by_dtype"]
        dot_s = sum(f / (peak if dt in ("bfloat16", "float16")
                         else FP32_FLOPS) for dt, f in dots.items())
        busy = row["busy_s"]
        phase("roofline", row=row["name"], platform=H100_SXM.name,
              **to_row(r),
              roofline_fraction_h100=(r.model_flops_global / r.chips / peak)
              / r.bound_time_s,
              model_flops_at_peak_s=r.model_flops_global / peak,
              measured_s=row["measured_s"],
              measured_min_s=row["measured_min_s"],
              measured_max_s=row["measured_max_s"], busy_s=busy,
              bound_share_of_busy=r.bound_time_s / busy if busy else None,
              dot_flops_by_dtype=dots, dot_s_at_dtype_rates=dot_s,
              dot_share_of_busy=dot_s / busy if busy else None,
              note="roofline_fraction: the copy's, at the TPU v5e peak "
                   "(ROADMAP C17); roofline_fraction_h100 at 989 TFLOP/s")


# [dryrun]: cells of the port's dry run at full configs on the production
# (16, 16) mesh, as (arch, shape, hillclimb variant); each traced in its own
# process, all started together, with the card visible (a train cell's
# autograd asks the runtime for its context) and nothing allocated on it.  qwen3-moe's train_4k
# (94 layers x 8 microbatches) traces for minutes: its prefill stands in for
# the FSDP and expert path here, the tier-1 tests cover its train specs
DRYRUN_CELLS = (("llama3.2-1b", "train_4k", "baseline"),
                ("llama3.2-1b", "prefill_32k", "baseline"),
                ("llama3.2-1b", "decode_32k", "baseline"),
                ("phi4-mini-3.8b", "train_4k", "baseline"),
                ("phi4-mini-3.8b", "train_4k", "seqpar"),
                ("qwen3-moe-235b-a22b", "prefill_32k", "baseline"))
# [dryrun-check]: the 1-rank cells held against the card, (name, seq,
# batch, kind): the dense train cell (DENSE) and the bf16 decode cell of
# [int8-kv] (a 2048-position cache, batch 8)
DRYRUN_CHECK = {"train": ("dryrun_check_train", DENSE["seq"], DENSE["batch"],
                          "train"),
                "decode": ("dryrun_check_decode", INT8KV["max_len"],
                           INT8KV["batch"], "decode")}
DRYRUN_TIMEOUT = 600


def dryrun_worker(spec: dict) -> int:
    """One cell of the dry run, in a child process (``--dryrun-cell``):
    ``run_cell`` at the spec's arch, shape (or a 1-rank mesh and a custom
    shape) and hillclimb variant, the record written under ``out``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.dist.mesh import Mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hillclimb import CELLS

    cfg = get_config(spec["arch"])
    if spec.get("kv_cache_dtype"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype=spec["kv_cache_dtype"])
    variant = spec["variant"]
    if variant != "baseline":
        cfg = next(t for c in CELLS.values() if c[0] == spec["arch"]
                   for v, _, t in c[2] if v == variant)(cfg)
    mesh = shape = None
    if spec.get("one_rank"):
        mesh = Mesh(("data", "model"), (1, 1), (torch.device("meta"),))
        shape = ShapeConfig(*spec["shape"])
    rec = D.run_cell(spec["arch"], shape.name if shape else spec["shape"],
                     "one" if mesh else "single", spec["out"], cfg=cfg,
                     tag="" if variant == "baseline" else variant,
                     device=spec.get("device", "cuda"), mesh=mesh,
                     shape=shape)
    print(json.dumps({"status": rec["status"]}), flush=True)
    return 0 if rec["status"] in ("ok", "skipped") else 1


def start_dryrun(out: str) -> list:
    """Start every [dryrun] and [dryrun-check] cell in a process of its own
    (the dry run allocates nothing on the card); returns (key, spec,
    process, log path)."""
    specs = [(f"{a}|{s}|{v}", {"arch": a, "shape": s, "variant": v})
             for a, s, v in DRYRUN_CELLS]
    for kind, shape in DRYRUN_CHECK.items():
        specs.append((f"check|{kind}", {"arch": DENSE_ARCH, "shape": shape,
                                        "variant": "baseline",
                                        "one_rank": True}))
    # the card stays visible: autograd on fake CUDA tensors asks the
    # runtime for the device's context (a trace with no device visible
    # fails there); nothing is allocated on it
    env = dict(os.environ, OMP_NUM_THREADS="1")
    started = []
    for key, spec in specs:
        spec["out"] = out
        log = os.path.join(out, key.replace("|", "__") + ".log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dryrun-cell",
                 json.dumps(spec)], stdout=f, stderr=subprocess.STDOUT,
                env=env, cwd=ROOT)
        started.append((key, spec, proc, log))
    return started


def finish_dryrun(started: list, failures: list) -> dict:
    """Wait for every dry-run process (killing any past the limit) and read
    its record; returns {key: record or None}."""
    t_end = time.time() + DRYRUN_TIMEOUT
    recs = {}
    for key, spec, proc, log in started:
        try:
            proc.wait(timeout=max(1.0, t_end - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failures.append(f"dryrun {key}: no record in {DRYRUN_TIMEOUT} s")
            recs[key] = None
            continue
        shape = spec["shape"]
        name = shape[0] if isinstance(shape, (list, tuple)) else shape
        mesh = "one" if spec.get("one_rank") else "single"
        tag = "" if spec["variant"] == "baseline" else f"__{spec['variant']}"
        path = os.path.join(spec["out"],
                            f"{spec['arch']}__{name}__{mesh}{tag}.json")
        if not os.path.exists(path):
            with open(log) as f:
                tail = f.read()[-1500:]
            failures.append(f"dryrun {key}: rc {proc.returncode}, no record: "
                            f"{tail}")
            recs[key] = None
            continue
        with open(path) as f:
            recs[key] = json.load(f)
    return recs


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x) and x >= 0


def dryrun_phase(recs: dict, failures: list) -> None:
    """``[dryrun]``: each production cell's record (see DRYRUN_CELLS),
    gated on its status, its arguments against the shard bytes of the
    specs recomputed in this process, and every term finite."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hillclimb import CELLS

    for a, s, v in DRYRUN_CELLS:
        rec = recs.get(f"{a}|{s}|{v}")
        if rec is None:
            continue
        if rec["status"] != "ok":
            failures.append(f"dryrun {a} {s} {v}: {rec['status']} "
                            f"{rec.get('error', '')}")
            phase("dryrun", arch=a, shape=s, variant=v, status=rec["status"],
                  error=rec.get("error"),
                  traceback=rec.get("traceback", "")[-1500:])
            continue
        cfg = get_config(a)
        if v != "baseline":
            cfg = next(t for c in CELLS.values() if c[0] == a
                       for n, _, t in c[2] if n == v)(cfg)
        _, shapes, in_specs, _, ctx, _ = D.build_cell(a, s, False, cfg=cfg)
        args = D.shard_bytes(shapes, in_specs, ctx.mesh.sizes)
        mem, summ, row = rec["memory"], rec["summary"], rec["roofline"]
        if mem["argument_size_in_bytes"] != args:
            failures.append(f"dryrun {a} {s} {v}: arguments "
                            f"{mem['argument_size_in_bytes']} != shard "
                            f"bytes {args}")
        terms = [mem[k] for k in ("argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes",
                                  "alias_size_in_bytes")]
        terms += [summ["flops"], summ["bytes"], summ["collective_bytes_ici"],
                  summ["collective_bytes_dcn"]]
        terms += [row[k] for k in ("compute_s", "memory_s", "collective_s",
                                   "collective_ring_s", "useful_flop_ratio",
                                   "roofline_fraction",
                                   "roofline_fraction_h100")]
        if not all(_finite(t) for t in terms):
            failures.append(f"dryrun {a} {s} {v}: a term is not finite and "
                            f"non-negative: {terms}")
        phase("dryrun", arch=a, shape=s, variant=v, mesh=rec["mesh"],
              chips=rec["chips"], status=rec["status"],
              argument_bytes=mem["argument_size_in_bytes"],
              argument_bytes_recomputed=args,
              temp_bytes=mem["temp_size_in_bytes"],
              output_bytes=mem["output_size_in_bytes"],
              alias_bytes=mem["alias_size_in_bytes"],
              flops=summ["flops"], bytes=summ["bytes"],
              collective_bytes_ici=summ["collective_bytes_ici"],
              collective_bytes_dcn=summ["collective_bytes_dcn"],
              collectives=summ["collectives"],
              kernel_nodes=summ["kernel_nodes"], rank=rec["rank"],
              roofline={k: row[k] for k in (
                  "compute_s", "memory_s", "collective_s",
                  "collective_ring_s", "dominant", "useful_flop_ratio",
                  "roofline_fraction", "roofline_fraction_h100",
                  "bound_time_s")},
              platform="h100_sxm", num_drops=rec["num_drops"],
              drops=rec["sharding_drops"][:8], notes=rec["notes"],
              build_s=rec["build_s"], trace_s=rec["trace_s"],
              graph_s=rec["graph_s"])


def tensor_bytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def dryrun_check_phase(dev, recs: dict, failures: list) -> dict:
    """``[dryrun-check]``: the 1-rank dry-run cells against the card (see
    DRYRUN_CHECK).  Train: the predicted arguments against the allocated
    AdamW state and batch, byte for byte; one real step of
    ``make_train_step`` (the path: the kernel counts from zero before it),
    its launches against the traced graph's kernel nodes, and the predicted
    peak (arguments + traced temp) beside ``max_memory_allocated`` of the
    step.  Decode: the same for the bf16 weights, the cache and the token,
    one decode step at position 2047, and the int8 cache's bytes."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.dist.mesh import Mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import leaves, tree_map

    cfg = get_config(DENSE_ARCH)
    mesh = Mesh(("data", "model"), (1, 1), (torch.device("meta"),))
    counters = kernel_counters()
    launches = {}
    for kind in ("train", "decode"):
        rec = recs.get(f"check|{kind}")
        if rec is None:
            continue
        if rec["status"] != "ok":
            failures.append(f"dryrun-check {kind}: {rec['status']} "
                            f"{rec.get('error', '')}")
            phase("dryrun-check", cell=kind, status=rec["status"],
                  error=rec.get("error"),
                  traceback=rec.get("traceback", "")[-1500:])
            continue
        name, seq, batch, _ = DRYRUN_CHECK[kind]
        shape = ShapeConfig(*DRYRUN_CHECK[kind])
        fn, shapes, in_specs, _, ctx, meta = D.build_cell(
            DENSE_ARCH, name, False, mesh=mesh, shape=shape)
        predicted = rec["memory"]["argument_size_in_bytes"]
        temp = rec["memory"]["temp_size_in_bytes"]
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        extra = {}
        if kind == "train":
            opt = make_optimizer(cfg.optimizer)
            state = init_state(model, gen, opt)
            data = synthetic_batch(cfg, DENSE, 0, dev)
            data = {k: data[k] for k in ("tokens", "labels")}
            allocated = tensor_bytes(
                {"p": state.params, "o": state.opt_state,
                 "s": state.step}) + tensor_bytes(data)
            step = make_train_step(model, opt,
                                   cosine_with_warmup(3e-4, 100, 10_000),
                                   grad_accum=meta["grad_accum"])

            def run():
                return step(state, data)
        else:
            params = tree_map(
                lambda t: t.to(torch.bfloat16) if t.is_floating_point()
                else t, model.init(gen))
            cache = model.init_cache(batch, seq, torch.bfloat16, dev)
            token = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
            allocated = (tensor_bytes(params) + tensor_bytes(cache)
                         + tensor_bytes(token))
            int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
            _, ishapes, ispecs, _, ictx, _ = D.build_cell(
                DENSE_ARCH, name, False, cfg=int8, mesh=mesh, shape=shape)
            icache = build_model(int8).init_cache(batch, seq, torch.bfloat16,
                                                  dev)
            extra = {"int8_cache_bytes_predicted": D.shard_bytes(
                ishapes[1], ispecs[1], ictx.mesh.sizes),
                "int8_cache_bytes_allocated": tensor_bytes(icache)}
            del icache
            if (extra["int8_cache_bytes_predicted"]
                    != extra["int8_cache_bytes_allocated"]
                    or extra["int8_cache_bytes_allocated"]
                    != INT8KV_BYTES["int8"]):
                failures.append(f"dryrun-check int8 cache: {extra}")

            def run():
                with torch.no_grad():
                    return model.decode(params, cache, token, seq - 1)
        if predicted != allocated:
            failures.append(f"dryrun-check {kind}: predicted arguments "
                            f"{predicted} != allocated {allocated}")
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        # the path: counts from zero, read right after the step
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t0
        launches[kind] = {k: c.count for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        nodes = rec["summary"]["kernel_nodes"]
        if {k: v for k, v in launches[kind].items() if v} != nodes:
            failures.append(f"dryrun-check {kind}: launches "
                            f"{launches[kind]} != traced kernel nodes "
                            f"{nodes}")
        measured_temp = peak - base
        phase("dryrun-check", cell=kind, arch=cfg.name, seq=seq, batch=batch,
              grad_accum=meta.get("grad_accum"),
              arguments_predicted=predicted, arguments_allocated=allocated,
              arguments_exact=predicted == allocated,
              temp_predicted=temp, temp_measured=measured_temp,
              temp_ratio=temp / measured_temp if measured_temp else None,
              peak_predicted=predicted + temp, peak_measured=peak,
              max_memory_allocated_gb=peak / 1e9,
              kernel_nodes=nodes, launches=launches[kind],
              flops=rec["summary"]["flops"], bytes=rec["summary"]["bytes"],
              trace_s=rec["trace_s"], graph_s=rec["graph_s"],
              real_step_s=step_s, **extra)
        del out, run
        if kind == "train":
            del state, data, step
        else:
            del params, cache, token
        torch.cuda.empty_cache()
    return launches


def dryrun_kernel_table(dev, gen, platform, launches: dict,
                        failures: list) -> list:
    """The kernels at the [dryrun-check] train step's shapes (one
    llama3.2-1b microbatch of 2 x 2048), launches from that step."""
    from repro_torch.configs.base import get_config

    cfg, chip = get_config(DENSE_ARCH), platform.chip
    train = launches.get("train")

    def counts(kernel):
        return (None, None) if train is None else (train[kernel],
                                                   train[kernel])

    b, s = DENSE["batch"] // DENSE["grad_accum"], DENSE["seq"]
    return [rmsnorm_row(dev, gen, chip, "rmsnorm@dryrun-check-train",
                        (b, s, cfg.d_model), cfg.norm_eps,
                        *counts("rmsnorm"), failures),
            flash_train_row(dev, gen, chip, "dryrun-check-train",
                            *counts("flash_attention"), failures)]


def dryrun_phases(dev, gen, platform, failures: list) -> list:
    """``[dryrun]`` and ``[dryrun-check]``: every cell's process started
    together, the card's real steps run meanwhile, then the records."""
    out = tempfile.mkdtemp(prefix="dryrun-", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    started = start_dryrun(out)
    try:
        recs = finish_dryrun(started, failures)
    finally:
        for *_, proc, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    traced_s = time.perf_counter() - t0
    dryrun_phase(recs, failures)
    launches = dryrun_check_phase(dev, recs, failures)
    phase("dryrun-time", processes=len(started), traces_wall_s=traced_s,
          phases_s=time.perf_counter() - t0)
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return dryrun_kernel_table(dev, gen, platform, launches, failures)


def bench_gate_module():
    """``scripts/bench_gate_port.py`` as a module (``scripts/`` is not a
    package); it imports neither JAX nor the JAX package unless its
    ``jax_params`` is called, which this script never does."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_gate_port", os.path.join(ROOT, "scripts", "bench_gate_port.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_gate_phase(dev, gen, platform, failures: list) -> list:
    """``[bench-gate]``: the port's bench gate on the card.  Its 52
    deterministic rows are held to benchmarks/baselines/bench_baseline.json
    within their bands.  Its executor rows run the tiny 4-layer llama
    (d_model 64, 2/2 heads of 32, fp32, "dots" remat) through interleaved
    1F1B with 2 virtual stages on a 1-rank mesh, 2 microbatches of 2 x 16
    tokens, from the port's own seeded init: the worst gradient leaf against
    autograd of the unpipelined reference within the baseline's band (which
    does not depend on the init); the loss is printed and not held (the
    baseline's is the JAX package's init's).  The executor's step runs
    through the kernels (the counts from zero before it); then the kernel
    rows at its shapes."""
    from repro_torch.models import build_model

    G = bench_gate_module()
    with open(G.DEFAULT_BASELINE) as f:
        baseline = json.load(f)["metrics"]
    t0 = time.perf_counter()
    metrics = G.deterministic_metrics()
    det_s = time.perf_counter() - t0
    cfg = G.exec_config()
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    for c in kernel_counters().values():
        c.reset()
    t0 = time.perf_counter()
    loss_row, grad_row = G.execution_rows(params, dev)
    torch.cuda.synchronize(dev)
    exec_s = time.perf_counter() - t0
    launches = grad_row["launches"]
    want = {k: v for k, v in train_launches(cfg, G.EXEC_MICROBATCHES).items()
            if k in launches}
    if launches != want:
        failures.append(f"bench-gate: the executor's step launched "
                        f"{launches}, want {want}")
    metrics[grad_row["name"]] = G._metric(grad_row)
    # the loss is this init's, not the baseline's: reported, not held
    held = {k: v for k, v in baseline.items() if k != loss_row["name"]}
    rows = G.drift_table(metrics, held)
    for msg in G.compare(metrics, held, rows=rows):
        failures.append(f"bench-gate: {msg}")
    det = [r for r in rows if r["name"] in metrics
           and not r["name"].startswith("pipe_exec")]
    phase("bench-gate", baseline=os.path.relpath(G.DEFAULT_BASELINE, ROOT),
          metrics=len(baseline), held=len(rows),
          in_band=sum(r["status"] == "ok" for r in rows),
          deterministic=len(det),
          deterministic_exact=sum(r["diff"] == 0.0 for r in det),
          out_of_band=[r["name"] for r in rows if r["status"] != "ok"],
          pipe_exec_loss=loss_row["value"],
          pipe_exec_loss_baseline=baseline[loss_row["name"]]["value"],
          pipe_exec_grad_rel_err=grad_row["value"],
          pipe_exec_grad_band=baseline[grad_row["name"]]["tol_abs"],
          launches=launches, launches_expected=want,
          deterministic_s=det_s, executor_s=exec_s)
    b, s = G.EXEC_BATCH // G.EXEC_MICROBATCHES, G.EXEC_SEQ
    return [rmsnorm_row(dev, gen, platform.chip, "rmsnorm@bench-exec",
                        (b, s, cfg.d_model), cfg.norm_eps,
                        launches["rmsnorm"], None, failures,
                        dtype=torch.float32),
            flash_train_row(dev, gen, platform.chip, "bench-exec",
                            launches["flash_attention"], None, failures)]


def kernels_only(dev, gen, failures: list, ptxas: dict) -> list:
    """``--only kernels``: the kernel rows at the serve and train shapes
    without driving the paths, so every launch field is null."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.hardware import platform_for_device
    from repro_torch.serve.policy import ServeConfig

    platform = platform_for_device(torch.cuda.get_device_name(dev))
    trace = serve_trace()
    ctx = {"scfg": ServeConfig(**SERVE), "platform": platform,
           "trace": trace, "launches": None, "forward_calls": None}
    table = kernel_table(dev, gen, dict(ctx, cfg=get_config(ARCH)), failures)
    table += kernel_table(dev, gen, dict(ctx, cfg=moe_serve_config()),
                          failures, "moe-serve-")
    table += train_kernel_table(dev, gen, {
        "cfg": get_config(TRAIN_ARCH), "run": TRAIN, "platform": platform,
        "launches": None, "ptxas": ptxas}, failures)
    table += dense_kernel_table(dev, gen, {
        "platform": platform, "dense": None, "moe": None}, failures)
    return table + new_path_kernel_table(dev, gen, {
        "platform": platform, "ptxas": ptxas, "jamba": None, "encdec": None,
        "encdec_decode": None}, failures)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("kernels", "pp", "ep", "obs", "ckpt",
                                       "netprof", "int8kv", "roofline",
                                       "dryrun", "bench"),
                    help="kernels: build, check and time the kernels alone "
                         "(no serve or train run, no launch counts); pp, ep, "
                         "obs, ckpt, netprof, int8kv, roofline, dryrun or "
                         "bench: build and "
                         "check the kernels, then that slice's phases alone "
                         "(remat-dots, pp-*, autotune; ep-*; serve-shard, "
                         "serve-obs, serve-analyze and pp-train with "
                         "pp-analyze and pp-obs; ckpt and ft; netprof; "
                         "int8-kv and int8-kv-step; the two simtrain rows "
                         "and their roofline; the layer profile into a fresh "
                         "ProfileDB; dryrun and dryrun-check; bench-gate).  "
                         "None prints the ok line")
    ap.add_argument("--dryrun-cell", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dryrun_cell:
        return dryrun_worker(json.loads(args.dryrun_cell))
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
    if args.only == "obs":
        from repro_torch.core.hardware import platform_for_device

        platform = platform_for_device(torch.cuda.get_device_name(dev))
        table = obs_phases(dev, gen, failures)
        pctx = pp_train_phase(dev, failures)
        pctx["state"] = None
        torch.cuda.empty_cache()
        table += pp_kernel_table(dev, gen, platform, pctx["launches"],
                                 failures)
        print(json.dumps({"kernels": table}), flush=True)
        for f in failures:
            print(f"FAIL {f}", flush=True)
        return 1 if failures else 0
    if args.only in ("ckpt", "netprof"):
        from repro_torch.core.hardware import platform_for_device

        platform = platform_for_device(torch.cuda.get_device_name(dev))
        table = []
        if args.only == "ckpt":
            launches = ckpt_phase(dev, failures)["launches"]
            torch.cuda.empty_cache()
            table = ckpt_kernel_table(dev, gen, platform, launches, failures)
        else:
            netprof_phase(dev, failures)
        print(json.dumps({"kernels": table}), flush=True)
        for f in failures:
            print(f"FAIL {f}", flush=True)
        return 1 if failures else 0
    if args.only in ("int8kv", "roofline"):
        from repro_torch.configs.base import get_config
        from repro_torch.core.hardware import platform_for_device

        platform = platform_for_device(torch.cuda.get_device_name(dev))
        table = []
        if args.only == "int8kv":
            ictx = int8kv_phase(dev, failures)
            torch.cuda.empty_cache()
            table = int8kv_kernel_table(dev, gen, platform, ictx, failures)
        else:
            rows = []
            for arch, batch in ((TRAIN_ARCH, SIMTRAIN["batch"]),
                                (DENSE_ARCH,
                                 DENSE["batch"] // DENSE["grad_accum"])):
                cfg = get_config(arch)
                rows.append((cfg, simtrain_phase(dev, cfg, SIMTRAIN["seq"],
                                                 batch, failures)))
                torch.cuda.empty_cache()
            roofline_phase(rows, failures)
        print(json.dumps({"kernels": table}), flush=True)
        for f in failures:
            print(f"FAIL {f}", flush=True)
        return 1 if failures else 0
    if args.only == "dryrun":
        from repro_torch.core.hardware import platform_for_device

        platform = platform_for_device(torch.cuda.get_device_name(dev))
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        print(json.dumps({"kernels": dryrun_phases(dev, gen, platform,
                                                   failures)}), flush=True)
        for f in failures:
            print(f"FAIL {f}", flush=True)
        return 1 if failures else 0
    if args.only == "bench":
        from repro_torch.core.hardware import platform_for_device

        platform = platform_for_device(torch.cuda.get_device_name(dev))
        print(json.dumps({"kernels": bench_gate_phase(dev, gen, platform,
                                                      failures)}), flush=True)
        for f in failures:
            print(f"FAIL {f}", flush=True)
        return 1 if failures else 0
    if args.only in ("pp", "ep"):
        from repro_torch.core.database import ProfileDB
        from repro_torch.core.hardware import platform_for_device

        platform = platform_for_device(torch.cuda.get_device_name(dev))
        phases = pp_phases if args.only == "pp" else ep_phases
        print(json.dumps({"kernels": phases(
            dev, gen, platform, ProfileDB(), failures)}), flush=True)
        for f in failures:
            print(f"FAIL {f}", flush=True)
        return 1 if failures else 0
    from repro_torch.configs.base import get_config
    from repro_torch.launch.sim_accuracy import smoke_config

    ctx = serve(dev, failures, get_config(ARCH))
    profile_decode(dev, ctx)
    context_effect(dev, ctx)
    table = kernel_table(dev, gen, ctx, failures)
    del ctx
    torch.cuda.empty_cache()

    tctx = train_phase(dev, failures, get_config(TRAIN_ARCH), TRAIN, "train")
    profile_train_step(dev, tctx, "train-profile")
    tctx["state"] = tctx["state"]._replace(opt_state=None)
    ssm_phase(dev, tctx, failures)
    tctx["ptxas"] = ptxas
    table += train_kernel_table(dev, gen, tctx, failures)
    cfg, platform = tctx["cfg"], tctx["platform"]
    del tctx
    torch.cuda.empty_cache()
    ssm_row = simtrain_phase(dev, cfg, SIMTRAIN["seq"], SIMTRAIN["batch"],
                             failures)
    ssm_cfg = cfg

    dctx = train_phase(dev, failures, get_config(DENSE_ARCH), DENSE,
                       "dense-train")
    profile_train_step(dev, dctx, "dense-train-profile")
    attention_check(dev, dctx, failures, "dense-check")
    dense_cfg, dense_launches = dctx["cfg"], dctx["launches"]
    del dctx
    torch.cuda.empty_cache()
    moe_launches = moe_phase(dev, failures)["launches"]
    table += dense_kernel_table(dev, gen, {
        "platform": platform, "dense": dense_launches,
        "moe": moe_launches}, failures)
    torch.cuda.empty_cache()
    from repro_torch.core.database import ProfileDB

    dense_db = ProfileDB()      # the card's profiles, kept for [pp-plan]
    dense_row = simtrain_phase(dev, dense_cfg, DENSE["seq"],
                               DENSE["batch"] // DENSE["grad_accum"],
                               failures, db=dense_db)
    # this slice: the roofline of the two traced steps
    roofline_phase([(ssm_cfg, ssm_row), (dense_cfg, dense_row)], failures)
    simtrain_phase(dev, smoke_config(MOE_ARCH), MOE["seq"], MOE["batch"],
                   failures)

    # this slice: MoE serving at the published widths, the jamba superblock,
    # the encoder-decoder at full width
    ctx = serve(dev, failures, moe_serve_config(), "moe-serve")
    profile_decode(dev, ctx, "moe-serve-profile")
    moe_serve_check(dev, ctx, failures)
    table += kernel_table(dev, gen, ctx, failures, "moe-serve-")
    del ctx
    torch.cuda.empty_cache()
    jamba_launches = jamba_phase(dev, failures)["launches"]
    torch.cuda.empty_cache()
    ectx = train_phase(dev, failures, get_config(ENCDEC_ARCH), ENCDEC,
                       "encdec-train")
    profile_train_step(dev, ectx, "encdec-train-profile")
    ectx["state"] = ectx["state"]._replace(opt_state=None)
    torch.cuda.empty_cache()
    attention_check(dev, ectx, failures, "encdec-check")
    encdec_decode_launches = encdec_decode(dev, ectx, failures)
    encdec_launches = ectx["launches"]
    del ectx
    torch.cuda.empty_cache()
    table += new_path_kernel_table(dev, gen, {
        "platform": platform, "ptxas": ptxas, "jamba": jamba_launches,
        "encdec": encdec_launches, "encdec_decode": encdec_decode_launches},
        failures)

    # the "dots" remat, data and pipeline parallelism
    table += pp_phases(dev, gen, platform, dense_db, failures)
    torch.cuda.empty_cache()
    # expert parallelism
    table += ep_phases(dev, gen, platform, dense_db, failures)
    torch.cuda.empty_cache()
    # this slice: the slot-sharded decode, the launchers' --obs and
    # --analyze (the pp ones ran with [pp-train])
    table += obs_phases(dev, gen, failures)
    torch.cuda.empty_cache()
    # this slice: checkpoint and resume with fault tolerance, the sweep
    launches = ckpt_phase(dev, failures)["launches"]
    torch.cuda.empty_cache()
    table += ckpt_kernel_table(dev, gen, platform, launches, failures)
    netprof_phase(dev, failures)
    torch.cuda.empty_cache()
    # this slice: the int8 KV cache
    ictx = int8kv_phase(dev, failures)
    torch.cuda.empty_cache()
    table += int8kv_kernel_table(dev, gen, platform, ictx, failures)
    del ictx
    torch.cuda.empty_cache()
    # this slice: the dry run and its check against the card
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    table += dryrun_phases(dev, gen, platform, failures)
    torch.cuda.empty_cache()
    # this slice: the bench gate's rows
    table += bench_gate_phase(dev, gen, platform, failures)
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
