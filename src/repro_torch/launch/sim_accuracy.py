"""The paper's Table 2 for one model: simulated vs measured train-step time.

The torch counterpart of ``benchmarks/bench_sim_accuracy.py::run`` for one
architecture, on the port's device (``cuda`` unless asked for the CPU):

  1. trace the model's real train step (``core/fx_graph.py``) into the
     dataflow graph;
  2. offline-profile the op families once (matmul grid, elementwise,
     reductions, memory ops) -> ProfileDB, over the JAX benchmark's grids
     extended to the traced step's sizes (:func:`profile_grids`), and
     calibrate the platform;
  3. estimate per-op durations (DB -> learned per-family MLP -> analytic)
     and simulate;
  4. let the new-op profiler measure the heaviest node signatures online —
     the real contractions, and the real kernel ops, which the JAX package's
     graph does not have;
  5. simulate again;
  6. measure the real step's wall time, and the kernel launches it makes,
     and report the error of both passes.

The JAX benchmark profiles before it compiles the step; the port traces
first, because the step's sizes decide how far the grids reach.  The rows
are the JAX benchmark's three, one model per mixer family, and keep its
names (``table2_dense_llama``, ``table2_ssm_mamba2``, ``table2_moe_qwen3``)::

    PYTHONPATH=src python -m repro_torch.launch.sim_accuracy --smoke --device cpu \\
        --arch llama3.2-1b

With ``--smoke`` the model is the JAX benchmark's reduced variant (4 layers,
d_model 256, 8/4 heads of 32, vocab 2048, fp32, no remat; the MoE keeps the
smoke config's 4 experts, top-2; seq 128, batch 8); without it, the model
at full width on one microbatch of ``chip_smoke.py``'s train cell.  The
MoE model runs only reduced: qwen3-moe-235b-a22b's training state (~3.8 TB)
needs expert parallelism (ROADMAP.md, 'Distributed').
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

# the JAX benchmark's row names (bench_sim_accuracy._models), by architecture
ROWS = {"llama3.2-1b": "dense_llama", "mamba2-2.7b": "ssm_mamba2",
        "qwen3-moe-235b-a22b": "moe_qwen3"}
# the JAX benchmark's profile grids, sized for its CPU-sized models;
# profile_grids extends them to a step's sizes
MATMUL_SIZES = (64, 128, 256, 512, 1024, 2048)
VECTOR_SIZES = tuple(2 ** p for p in range(12, 25, 2))
# dot and kernel signatures the new-op profiler times (the JAX loop's 24)
REFINE_TOP = 24


def smoke_config(arch: str):
    """The JAX benchmark's reduced variant of ``arch`` (``_models``)."""
    from repro_torch.configs.base import get_config, smoke_variant

    cfg = smoke_variant(get_config(arch))
    return dataclasses.replace(
        cfg, num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
        head_dim=32, d_ff=512 if cfg.d_ff else 0, vocab_size=2048,
        remat_policy="none", compute_dtype="float32", param_dtype="float32",
    )


def largest_ops(graph) -> dict:
    """The ops that set how far the grids reach: the contraction of most
    flops, the contraction of most bytes and the other op (priced as a
    vector op) of most bytes; each as (aten op, flops, bytes)."""
    dots = [n for n in graph.nodes if n.kind == "dot"]
    others = [n for n in graph.nodes
              if n.kind not in ("dot", "custom-call", "view", "parameter")]

    def top(nodes, key):
        n = max(nodes, key=key, default=None)
        return (None if n is None
                else (n.meta.get("aten"), n.flops, n.bytes_accessed))

    return {"dot_flops": top(dots, lambda n: n.flops),
            "dot_bytes": top(dots, lambda n: n.bytes_accessed),
            "other_bytes": top(others, lambda n: n.bytes_accessed)}


def profile_grids(graph, itemsize: int) -> tuple[list[int], list[int]]:
    """(matmul sides, vector sizes): the JAX benchmark's grids, extended
    until they reach ``graph``'s largest ops.

    The learned time model reads log flops and log bytes, and past the
    largest profiled entry it extrapolates; the JAX grids stop where its
    CPU-sized models do.  So the matmul sides double until the largest
    square product (2 P^3 flops, 3 P^2 elements of ``itemsize`` bytes)
    holds the flops and the bytes of the step's largest contraction, and
    the vector sizes quadruple until a binary op over the largest (three
    vectors) moves the bytes of the step's largest other op.  A step within
    the JAX grids keeps them."""
    big = largest_ops(graph)
    flops = big["dot_flops"][1] if big["dot_flops"] else 0.0
    dot_bytes = big["dot_bytes"][2] if big["dot_bytes"] else 0.0
    vec_bytes = big["other_bytes"][2] if big["other_bytes"] else 0.0
    mm, vec = list(MATMUL_SIZES), list(VECTOR_SIZES)
    while (2.0 * mm[-1] ** 3 < flops
           or 3.0 * mm[-1] ** 2 * itemsize < dot_bytes):
        mm.append(2 * mm[-1])
    while 3.0 * vec[-1] * itemsize < vec_bytes:
        vec.append(4 * vec[-1])
    return mm, vec


def run(cfg, *, seq: int, batch: int, steps: int = 12,
        profile_repeats: int = 5, device="cuda", log_fn=print) -> dict:
    """One Table-2 row for ``cfg``; returns it as a dict.

    The profiles are taken in fp32, as in the JAX benchmark, over the grids
    of :func:`profile_grids`; reductions and memory ops take every vector
    size but the largest, as there."""
    from repro_torch.core.database import ProfileDB
    from repro_torch.core.estimator import OpTimeEstimator
    from repro_torch.core.fx_graph import KERNEL_COSTS, step_summary
    from repro_torch.core.newop import NewOpProfiler
    from repro_torch.core.profiler import OfflineProfiler, calibrate_host
    from repro_torch.core.simulator import simulate
    from repro_torch.data import SyntheticTokens
    from repro_torch.device import resolve_device, synchronize
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.train.step import init_state, make_train_step

    dev = resolve_device(device)
    seconds = {}
    model = build_model(cfg)
    opt = adamw()
    sched = cosine_with_warmup(1e-3, 10, 1000)

    # 1. the step's graph, traced on fake tensors
    t0 = time.perf_counter()
    summary = step_summary(model, opt, sched, batch=batch, seq=seq,
                           device=dev)
    graph = summary["graph"]
    seconds["trace"] = time.perf_counter() - t0

    # 2. offline op profiles, over grids that reach the step's sizes
    t0 = time.perf_counter()
    db = ProfileDB()
    prof = OfflineProfiler(db, repeats=profile_repeats, device=dev)
    matmul_sizes, vector_sizes = profile_grids(graph, prof.dtype.itemsize)
    prof.profile_matmul(sizes=matmul_sizes, values_per_arg=6)
    prof.profile_elementwise(sizes=vector_sizes, values_per_arg=7)
    prof.profile_reduction(sizes=vector_sizes[:-1], values_per_arg=6)
    prof.profile_memory_ops(sizes=vector_sizes[:-1], values_per_arg=6)
    platform = calibrate_host(db, prof.platform)
    seconds["profile"] = time.perf_counter() - t0

    # 3. simulate from the offline DB
    t0 = time.perf_counter()
    est = OpTimeEstimator(platform, db)
    res1 = simulate(graph, est.duration)
    sim1, stats1 = res1.makespan, dict(est.stats)

    # 4. online profiles of the heaviest dot and kernel signatures
    newop = NewOpProfiler(db, platform.name, repeats=profile_repeats,
                          device=dev)
    costs = sorted(
        ((est.duration(n), n) for n in graph.nodes
         if n.meta.get("dot") or n.meta.get("kernel")),
        key=lambda t: -t[0],
    )
    seen = set()
    for _dur, n in costs:
        sig = (n.kind, int(n.flops), int(n.bytes_accessed))
        if sig in seen or len(seen) >= REFINE_TOP:
            continue
        seen.add(sig)
        newop.try_profile(n)

    # 5. simulate again
    est2 = OpTimeEstimator(platform, db)
    res2 = simulate(graph, est2.duration)
    sim2, stats2 = res2.makespan, dict(est2.stats)
    seconds["simulate"] = time.perf_counter() - t0

    # 6. the real step, and its kernel launches beside the graph's nodes
    t0 = time.perf_counter()
    step = make_train_step(model, opt, sched)
    state = init_state(model, torch.Generator(device=dev).manual_seed(0), opt)
    src = SyntheticTokens(cfg.vocab_size, seq, batch, seed=0)
    batch_t = {k: torch.as_tensor(v, device=dev)
               for k, v in src.batch_at(0).items()}
    state, _ = step(state, batch_t)           # warm-up (first-call costs)
    synchronize(dev)
    counters = {"ssd_scan": ssd_ops.LAUNCHES, "rmsnorm": rms_ops.LAUNCHES,
                "flash_attention": fa_ops.LAUNCHES}
    before = {k: c.count for k, c in counters.items()}
    t1 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, batch_t)
    float(metrics["loss"])                   # host sync: every step is done
    measured = (time.perf_counter() - t1) / steps
    launches = {k: (c.count - before[k]) / steps for k, c in counters.items()}
    seconds["measure"] = time.perf_counter() - t0
    del state

    err1 = abs(sim1 - measured) / measured
    err2 = abs(sim2 - measured) / measured
    row = {
        "name": f"table2_{ROWS.get(cfg.name, cfg.name)}",
        "arch": cfg.name, "platform": platform.name,
        "seq": seq, "batch": batch,
        "measured_s": measured, "sim_offline_s": sim1,
        "sim_refined_s": sim2, "err_offline": err1, "err_refined": err2,
        "provenance_offline": stats1, "provenance_refined": stats2,
        "sim_offline_s_by_kind": res1.time_by_kind,
        "sim_refined_s_by_kind": res2.time_by_kind,
        "matmul_sizes": matmul_sizes, "vector_sizes": vector_sizes,
        "largest_ops": largest_ops(graph),
        "refined_signatures": len(seen), "db_entries": len(db),
        "graph_nodes": summary["nodes"], "graph_kinds": summary["kinds"],
        "graph_kernel_nodes": {k: sum(1 for n in graph.nodes
                                      if n.meta.get("kernel") == k)
                               for k in KERNEL_COSTS},
        "kernel_launches_per_step": launches,
        "dot_flops": summary["dot_flops"], "seconds": seconds,
    }
    log_fn(
        f"{row['name']},{measured * 1e6:.2f},"
        f"sim_offline_us={sim1 * 1e6:.0f};err_offline={err1 * 100:.1f}%;"
        f"sim_refined_us={sim2 * 1e6:.0f};err_refined={err2 * 100:.1f}%"
    )
    return row


def main(argv=None) -> None:
    from repro_torch.configs.base import get_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b", choices=sorted(ROWS))
    ap.add_argument("--smoke", action="store_true",
                    help="the JAX benchmark's reduced variant (CPU-sized)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "moe" and not args.smoke:
        ap.error(f"{args.arch} at full width needs expert parallelism "
                 "(ROADMAP.md, 'Distributed'); pass --smoke")
    # the JAX benchmark's cell with --smoke; one microbatch of the train
    # cell of chip_smoke.py without
    row = run(cfg, seq=128 if args.smoke else 2048,
              batch=8 if args.smoke else 2, device=args.device)
    print(json.dumps(row, sort_keys=True))


if __name__ == "__main__":
    main()
