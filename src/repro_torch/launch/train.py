"""Training launcher: config -> model -> mesh -> data -> train step.

The torch counterpart of the JAX package's ``launch/train.py``.  Runs on the
CUDA card unless ``--device cpu`` is given; weights are random, drawn from a
``torch.Generator`` seeded with ``--seed``; tokens come from the synthetic
pipeline (``repro_torch.data``), bit-equal to the JAX package's batches.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --steps 3 --seq 64 --batch 4

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --steps 3 --seq 64 --batch 8 \\
        --ranks 4 --pp 2 --microbatches 2 --compression int8

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-moe-235b-a22b --smoke --device cpu --steps 2 \\
        --ranks 4 --moe-impl ep_a2a

Strategies run over a mesh of ``--ranks`` logical ranks
(``repro_torch.dist.mesh``; default: one per visible CUDA device, or 1).
Without ``--pp`` the mesh is (data = ranks, model = 1), and the launcher's
sharding context (``models.sharding``) runs ``--moe-impl ep_a2a`` MoE
layers expert-parallel over its data ranks (``dist.ep_a2a``): it prints the
per-rank all-to-all payload (``[comm]``) and, after training, how many MoE
calls took each path (``[moe]``).  ``--pp N`` runs the real model through
the scheduled pipeline executor on a (data = ranks / N, stage = N) mesh
(``--pp-schedule``, ``--vstages``, ``--microbatches``), ``--compression
int8`` reduces the gradients over the data ranks with int8 payloads and
error feedback, ``--overlap-buckets`` buckets that reduction; the
pipelined and the compressed steps run MoE through its einsum path.  The ranks of one card run one after another, so
the step time there is not a multi-card time.  Before training the launcher
prints the simulated plan (``[pp-plan]``), the byte parity of the simulated
graph against the executor (``[pp-parity]``; it raises on a mismatch) and
the gradient traffic (``[comm]``); after training, the bytes the executor's
hops moved against the same twin.

Each step is timed twice: on the host, up to the loss's host sync (as the
JAX launcher does, ``run_timed_step``), and on the card, between two CUDA
events around the step.

``--analyze`` verifies the plan statically before the first step
(``repro_torch.analysis``: schedule, graph, timeline; it raises
``PlanVerificationError`` on an error-level finding).  ``--obs`` records
the steps as spans and, after training with ``--pp``, prices the plan on the
launcher's platform, replays its ops on the mesh under the graph's node
uids (``repro_torch.obs.replay``) and prints the divergence report;
``--trace-out`` writes the sim-vs-real overlay there and the report beside
it:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --steps 2 --seq 32 --batch 8 --ranks 4 \\
        --pp 2 --microbatches 2 --analyze --obs --trace-out /tmp/t.json

Plans are priced on the launcher's platform: the card's spec, or
``CPU_HOST`` with ``--device cpu``.  ``--netprof-db db.json`` prices them
instead from a calibrated interconnect (``python -m
repro_torch.netprof.calibrate``): the DB's platform, its collectives from
the measured chain (``[netprof]`` lines give each kind's provenance), at
every place the plan is priced (``[pp-plan]``, ``[pp-parity]``,
``--analyze``, ``--obs``).  The shared flags are declared in
``launch/spec.py``, as the reference's.

``--ckpt-dir DIR`` checkpoints the train state (``repro_torch.ckpt``, the
reference's format 2): the newest valid checkpoint there is restored before
the first step (``[restore] resumed from step N``; ``--no-restore``
starts afresh), the data resume at that step, a checkpoint is taken every
``ckpt_every`` steps (50) and at the end through the async writer (the
step blocks only on the host copy).  Each step writes a heartbeat
(``DIR/hb``, else under the temporary directory) and feeds the step-time
monitor and the straggler policy (``repro_torch.ft``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --steps 4 --seq 64 --batch 4 --ckpt-dir /tmp/ck

``--overlap-comm`` is accepted and changes nothing: the executor always
elides the exchanges no rank receives
(``train.step.make_pipeline_train_step``).  Every family trains
unpipelined; ``--pp`` takes the ``dense`` and ``moe`` families, as the
reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.ckpt import AsyncCheckpointer, restore
from repro_torch.ckpt.checkpoint import tree_bytes
from repro_torch.configs.base import ShapeConfig, get_config, smoke_variant
from repro_torch.core.estimator import OpTimeEstimator
from repro_torch.core.profiler import platform_of
from repro_torch.data import make_train_iterator
from repro_torch.device import resolve_device
from repro_torch.dist import mesh as M
from repro_torch.ft import HeartbeatMonitor, StepTimeMonitor, StragglerPolicy
from repro_torch.models import build_model
from repro_torch.models.moe import EP_CALLS, reset_ep_calls
from repro_torch.models.sharding import make_ctx, use_sharding
from repro_torch.obs.record import Recorder
from repro_torch.optim import cosine_with_warmup, make_optimizer
from repro_torch.train.step import (
    init_state,
    make_sharded_train_step,
    run_timed_step,
)

def default_ranks(device) -> int:
    """One logical rank per visible CUDA device, or 1."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def build_mesh(ranks: int, pp: int = 0, device="cuda"):
    """(data, model) mesh of ``ranks`` x 1 ranks (the reference's GSPMD
    mesh); ``pp >= 1`` builds the (data, stage) pipeline mesh with ``pp``
    stage ranks instead."""
    from repro_torch.dist.mesh import make_mesh

    if pp >= 1:
        if ranks % pp != 0:
            raise ValueError(
                f"--pp {pp} needs a rank count divisible by it (have "
                f"{ranks})")
        return make_mesh((ranks // pp, pp), ("data", "stage"), device)
    return make_mesh((ranks, 1), ("data", "model"), device)


def comm_report(cfg, mesh, params, *, batch: int, seq: int,
                compression: str = "none", log_fn=print) -> None:
    """Log the per-step gradient all-reduce volume on this mesh: raw
    against int8-compressed, through the executor byte twin
    (``compressed_psum_bytes``) the simulator's annotated graph resolves
    to; and, for ep_a2a MoE configs, the per-rank payload of one dispatch
    all-to-all (``dist.ep_a2a.moe_a2a_bytes``) at the compute dtype's
    itemsize, the one the strategy graph prices (the reference's line
    uses 4 bytes whatever the dtype: ROADMAP.md, C9)."""
    from repro_torch.dist.compress import compressed_psum_bytes

    dp = mesh.sizes.get("data", 1)
    raw = compressed_psum_bytes(params, scheme="none")
    int8 = compressed_psum_bytes(params, scheme="int8")
    active = " (ACTIVE: error-feedback psum)" if compression == "int8" else ""
    log_fn(
        f"[comm] dp={dp} grad all-reduce/step: raw {raw / 2**20:.1f} MiB; "
        f"an int8+feedback ring would move {int8 / 2**20:.1f} MiB "
        f"({raw / int8:.1f}x less){active}"
    )
    if cfg.moe is not None and cfg.moe.impl == "ep_a2a":
        from repro_torch.dist.ep_a2a import moe_a2a_bytes
        from repro_torch.models.layers import dtype_of

        tokens_local = batch // max(dp, 1) * seq
        itemsize = dtype_of(cfg.compute_dtype).itemsize
        a2a = moe_a2a_bytes(cfg.moe, tokens_local, cfg.d_model, itemsize)
        log_fn(
            f"[comm] moe ep_a2a dispatch/layer: {a2a / 2**20:.2f} MiB "
            f"per device each way ({tokens_local} local tokens)"
        )


# one launch loads and fits a calibration DB once: the plan, parity,
# analysis and obs reports share the estimator (and its provenance ledger)
_NETPROF_CACHE: dict = {}


def netprof_estimator(db_path: str, log_fn=print):
    """(estimator, platform) priced from a calibrated interconnect DB.

    Loads the ProfileDB written by ``python -m repro_torch.netprof.calibrate``,
    picks the calibrated platform (``netprof.calibrate.calibrated_platform``:
    ``cpu_host`` when present, else the DB's first platform; a spec-sheet
    platform keeps its spec, the others are calibrated from the DB's own
    compute entries), and builds an :class:`OpTimeEstimator` whose
    collectives go through the measured chain (exact DB hit -> fitted
    CollectiveModel -> ring; ``repro_torch.netprof``).  Memoized per
    (path, mtime, size): repeated calls within one launch reuse the fitted
    estimator and log its banner once.
    """
    from repro_torch.core.database import ProfileDB
    from repro_torch.netprof.calibrate import calibrated_platform
    from repro_torch.netprof.pricing import netprof_meta

    st = os.stat(db_path)
    cache_key = (os.path.abspath(db_path), st.st_mtime_ns, st.st_size)
    hit = _NETPROF_CACHE.get(cache_key)
    if hit is not None:
        return hit
    db = ProfileDB.load(db_path)
    if not db.platforms():
        raise ValueError(f"--netprof-db {db_path}: no platforms in DB")
    name, platform = calibrated_platform(db)
    stamp = netprof_meta(db, name)
    if stamp:
        log_fn(
            f"[netprof] {db_path}: platform {name}, "
            f"{stamp.get('entries', 0)} collective measurements, "
            f"groups {stamp.get('groups')}, "
            f"collectives {len(stamp.get('collectives', []))}, "
            f"backend {stamp.get('backend')} "
            f"({stamp.get('ranks', stamp.get('device_count'))} ranks on "
            f"{stamp.get('device_count')} devices)"
        )
    else:
        log_fn(f"[netprof] {db_path}: platform {name} "
               f"(no netprof sweep stamp — collectives may ring-fall back)")
    out = (OpTimeEstimator(platform, db), platform)
    _NETPROF_CACHE[cache_key] = out
    return out


def pipeline_plan_report(cfg, *, pp: int, schedule: str, vstages: int,
                         microbatches: int, batch: int, seq: int,
                         netprof_db: Optional[str] = None, log_fn=print):
    """Simulate the requested pipeline schedule for this config and log it
    (marked simulated): the same step table the executor runs, priced by
    the DES through ``Autotuner.evaluate``; bubble, comm share and the
    scheduled boundary traffic.  With ``netprof_db`` the plan is priced on
    the calibrated platform with measured collectives, and each kind's
    provenance is logged.  Logs instead of failing when the config cannot
    realize the schedule."""
    from repro_torch.core.autotuner import Autotuner
    from repro_torch.core.strategy import Strategy
    from repro_torch.models.pipeline import model_layer_cost

    strategy = Strategy(pp=pp, microbatches=microbatches, schedule=schedule,
                        vstages=vstages)
    est = platform = None
    if netprof_db:
        est, platform = netprof_estimator(netprof_db, log_fn=log_fn)
    tuner = Autotuner(cfg, chips=pp, global_batch=max(batch, microbatches),
                      seq=seq,
                      **({"platform": platform, "estimator": est}
                         if est is not None else {}))
    try:
        result = tuner.evaluate(strategy)
    except (ValueError, AssertionError, ZeroDivisionError) as e:
        log_fn(f"[pp-plan] {strategy.describe()} not realizable: {e}")
        return None
    if est is not None and est.collective_pricer is not None:
        for line in est.collective_pricer.report_lines():
            log_fn(f"[netprof] {line}")
        ring = est.collective_pricer.ring_fallbacks_for_profiled()
        log_fn(f"[netprof] ring-fallback nodes for profiled collectives: "
               f"{ring}")
    micro_bs = max(batch // microbatches, 1)
    cost = model_layer_cost(cfg, micro_bs, seq, tp=1)
    hops = strategy.make_pipeline_schedule().comm_bytes(cost.boundary_bytes)
    log_fn(
        f"[pp-plan] {strategy.describe()} on {tuner.platform.name}: "
        f"simulated step {result.makespan_s * 1e3:.2f}ms, "
        f"bubble {result.bubble_fraction * 100:.1f}%, "
        f"comm share {result.comm_fraction * 100:.1f}%, "
        f"boundary traffic {hops / 2**20:.2f} MiB/step"
    )
    return result


def pipeline_parity_report(plan, *, micro_batch: int, seq: int, dp: int = 1,
                           compression: str = "none", params=None,
                           estimator=None, log_fn=print) -> dict:
    """Model-derived simulated bytes against the executor's twins; raises
    on drift.

    The simulator's collective-permute nodes over
    ``core.strategy.model_pipeline_graph`` must sum to exactly the
    scheduled boundary traffic the executor moves
    (``PipelinePlan.boundary_bytes_per_step``), and with ``dp > 1`` each
    stage's gradient all-reduce node to exactly
    ``compressed_psum_bytes`` of that stage's parameter tree.  With an
    ``estimator`` (``--netprof-db``) every comm node is also priced through
    its measured chain and each kind's provenance logged.  Returns the
    simulated byte counts.
    """
    from repro_torch.core.estimator import dist_comm_bytes
    from repro_torch.core.strategy import model_pipeline_graph
    from repro_torch.dist.compress import compressed_psum_bytes
    from repro_torch.models.pipeline import stage_param_trees

    g = model_pipeline_graph(
        plan.cfg, plan.strategy(dp=dp, compression=compression),
        micro_batch, seq, params=params,
    )
    sim = sum(dist_comm_bytes(n) for n in g.nodes
              if n.kind == "collective-permute")
    ex = plan.boundary_bytes_per_step(micro_batch, seq)
    ok = sim == ex
    out = {"hop_bytes_sim": sim, "hop_bytes_exec_twin": ex}
    line = (f"[pp-parity] {plan.describe()}: boundary bytes/step "
            f"sim={sim:.0f} exec={ex:.0f}")
    if dp > 1:
        if params is None:
            params, _ = build_model(plan.cfg).abstract_params()
        scheme = compression if compression != "none" else "none"
        by_name = {n.name: n for n in g.nodes}
        sim_ar = [dist_comm_bytes(by_name[f"gradAR{s}"])
                  for s in range(plan.pp)]
        ex_ar = [compressed_psum_bytes(t, scheme=scheme)
                 for t in stage_param_trees(plan, params)]
        ok = ok and sim_ar == ex_ar
        out.update(allreduce_bytes_sim=sim_ar, allreduce_bytes_exec_twin=ex_ar)
        line += (f"; grad all-reduce ({scheme}) per stage sim={sim_ar} "
                 f"exec={ex_ar}")
    log_fn(line + (" (parity ok)" if ok else " (PARITY MISMATCH)"))
    if not ok:
        raise AssertionError(f"pipeline byte parity drift: {out}")
    if estimator is not None:
        # bytes twin-exact AND time measured: the sim-vs-real loop closed
        from repro_torch.netprof.pricing import PROV_RING, graph_provenance

        for n in g.nodes:
            if n.is_collective:
                estimator.duration(n)
        prov = graph_provenance(g)
        for kind in sorted(prov):
            s = prov[kind]
            log_fn(f"[netprof] {kind}: "
                   + " / ".join(f"{v} {k}" for k, v in sorted(s.items())))
        rings = sum(s.get(PROV_RING, 0) for s in prov.values())
        log_fn(f"[netprof] comm nodes ring-priced: {rings}")
        out["provenance"] = prov
    return out


def plan_analysis_report(cfg, strategy, *, micro_batch: int, seq: int,
                         estimator=None, run_spec=None, log_fn=print):
    """Statically verify the launch plan before a single step executes.

    Runs the full ``repro_torch.analysis`` pass over the model-derived plan
    — schedule table legality and ppermute pairing, graph structure and
    accounting completeness, and the DES timeline audit — and raises
    :class:`repro_torch.analysis.PlanVerificationError` on any error-level
    finding: a plan that would deadlock the executor or price garbage never
    reaches the mesh.
    """
    from repro_torch.analysis import analyze_training_plan
    from repro_torch.launch import spec as runspec

    report = analyze_training_plan(
        cfg, strategy, micro_batch=micro_batch, seq=seq,
        estimator=estimator, use_model_graph=True,
    )
    runspec.attach(report, run_spec)
    for line in report.summary_lines():
        log_fn(f"[analyze] {line}")
    report.raise_on_errors()
    return report


def _obs_report(rec, cfg, plan, mesh, params, *, batch: int, seq: int,
                dp: int, grad_accum: int, compression: str,
                overlap_buckets: int, estimator, trace_out: str,
                run_spec=None, log_fn=print):
    """The --obs post-pass: price the plan, replay its ops for real,
    attribute the sim-vs-real gap, and export the overlay trace.

    The pipelined step runs every rank's ops in one host loop, so the real
    side of each op comes from :func:`repro_torch.obs.replay`'s
    instrumented standalone re-execution on the live mesh — the offline
    profiling the estimator is built from, turned into spans under the
    simulator's own node uids.  Returns ``(report, replay counts)``; both
    are None without a pipeline plan.
    """
    from repro_torch.launch import spec as runspec
    from repro_torch.obs import (
        divergence_report,
        overlay_chrome_trace,
        replay_pipeline_ops,
    )

    sim_res = graph = report = counts = None
    measured = None
    step_spans = [s for s in rec.spans if s.labels.get("role") == "step"]
    if step_spans:
        measured = sum(s.duration for s in step_spans) / len(step_spans)
    if plan is not None:
        from repro_torch.core.simulator import simulate
        from repro_torch.core.strategy import model_pipeline_graph

        micro_bs = max(batch // (dp * grad_accum * plan.microbatches), 1)
        strat = plan.strategy(dp=dp, compression=compression)
        if overlap_buckets:
            strat = dataclasses.replace(strat,
                                        overlap_buckets=overlap_buckets)
        graph = model_pipeline_graph(cfg, strat, micro_bs, seq)
        sim_res = simulate(graph, estimator.duration, record_events=True)
        counts = replay_pipeline_ops(
            rec, graph, cfg=cfg, plan=plan, mesh=mesh, params=params,
            micro_batch=micro_bs, seq=seq, log_fn=log_fn,
        )
        report = divergence_report(rec, sim_res, graph, name="train-obs")
        if measured is not None:
            report.metrics["obs_step_mean_s"] = float(measured)
            log_fn(
                f"[obs] mean real step {measured * 1e3:.1f}ms vs simulated "
                f"makespan {sim_res.makespan * 1e3:.2f}ms (the step also "
                f"carries executor dispatch overhead the per-op "
                f"attribution below excludes)"
            )
        runspec.attach(report, run_spec)
        for line in report.summary_lines():
            log_fn(f"[obs] {line}")
    else:
        log_fn(
            "[obs] no pipeline plan (--pp 1): recorded "
            f"{len(rec.spans)} spans; overlay will carry real tracks only"
        )
    if trace_out:
        overlay_chrome_trace(sim_res, rec, trace_out, graph=graph)
        log_fn(f"[obs] overlay trace written to {trace_out}")
        if report is not None:
            rpath = os.path.splitext(trace_out)[0] + "_report.json"
            report.to_json(rpath)
            log_fn(f"[obs] divergence report written to {rpath}")
    return report, counts


def _save(ckpt: AsyncCheckpointer, state, step: int, log_fn) -> None:
    """Hand the state to the async writer; logs the blocking part."""
    ckpt.save(state, step)
    log_fn(f"[ckpt] step {step}: {ckpt.last['bytes'] / 1e9:.3f} GB "
           f"snapshot to the host in {1e3 * ckpt.last['snapshot_s']:.1f} ms "
           "(blocking)")


def train(
    cfg,
    *,
    steps: int,
    seq: int,
    batch: int,
    lr: float = 3e-4,
    warmup: int = 20,
    grad_accum: int = 1,
    compression: str = "none",
    pp: int = 0,
    pp_schedule: str = "1f1b",
    vstages: int = 1,
    microbatches: int = 0,
    overlap_buckets: int = 0,
    ranks: Optional[int] = None,
    ckpt_dir: Optional[str] = None,
    restore_from: bool = True,
    netprof_db: Optional[str] = None,
    analyze: bool = False,
    obs: bool = False,
    trace_out: str = "",
    run_spec=None,
    log_every: int = 10,
    ckpt_every: int = 50,
    host_id: int = 0,
    num_hosts: int = 1,
    seed: int = 0,
    device="cuda",
    on_step: Optional[Callable[[int, dict], None]] = None,
    on_obs: Optional[Callable] = None,
    on_ckpt: Optional[Callable[[dict], None]] = None,
    log_fn=print,
):
    """Train up to step ``steps``; returns ``(state, losses)`` (the losses
    of the steps this call ran: from the restored step on, with
    ``ckpt_dir``).

    ``on_step(i, record)`` is called after each step with its loss, the
    model's ``ce`` and ``aux``, grad norm, learning rate, host milliseconds,
    (on the card) device milliseconds and the straggler policy's verdict
    on this host.  With ``obs``, ``on_obs(report, counts)`` gets the
    divergence report and the replay's measured and skipped node counts
    (None, None without ``--pp``).  With ``ckpt_dir``, ``on_ckpt(event)``
    gets the restore (``{"event": "restore", "step", "bytes", "seconds"}``)
    and the last save once written (``{"event": "save", "step", "bytes",
    "snapshot_s", "write_s", "path"}``).
    """
    dev = resolve_device(device)
    ranks = ranks or default_ranks(dev)
    shape = ShapeConfig("train_launch", seq, batch, "train")
    pipeline_on = pp > 1 or vstages > 1
    plan = None
    if pipeline_on:
        from repro_torch.models.pipeline import make_plan

        pp = max(pp, 1)
        plan = make_plan(cfg, pp, microbatches or pp, schedule=pp_schedule,
                         vstages=vstages)
        mesh = build_mesh(ranks, pp, dev)
    else:
        mesh = build_mesh(ranks, device=dev)
    dp = mesh.sizes["data"]
    # plans are priced on the launcher's own platform (the card's, or the
    # CPU host's), or on a calibrated interconnect's
    if netprof_db:
        estimator, _ = netprof_estimator(netprof_db, log_fn=log_fn)
    else:
        estimator = OpTimeEstimator(platform_of(dev))
    if analyze:
        from repro_torch.core.strategy import Strategy

        mb_count = plan.microbatches if plan is not None else 1
        plan_analysis_report(
            cfg,
            Strategy(
                dp=dp,
                pp=plan.pp if plan is not None else 1,
                microbatches=mb_count,
                schedule=pp_schedule if pipeline_on else "1f1b",
                vstages=vstages if pipeline_on else 1,
                compression=compression,
                overlap_buckets=overlap_buckets,
            ),
            micro_batch=max(batch // (dp * grad_accum * mb_count), 1),
            seq=seq, estimator=estimator, run_spec=run_spec, log_fn=log_fn,
        )
    ctx = make_ctx(mesh, overrides=cfg.sharding_overrides)
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    sched = cosine_with_warmup(lr, warmup, max(steps, warmup + 1))
    step_fn = make_sharded_train_step(
        model, opt, sched, mesh, grad_accum=grad_accum,
        compression=compression, pipeline=plan,
        overlap_buckets=overlap_buckets)
    micro_bs = 0
    if plan is not None:
        micro_bs = batch // (dp * grad_accum * plan.microbatches)
        log_fn(f"[pp-exec] executing {plan.describe()} on mesh "
               f"dp{dp}xpp{plan.pp} ({micro_bs} seqs/microbatch)")
        pipeline_parity_report(plan, micro_batch=micro_bs, seq=seq, dp=dp,
                               compression=compression,
                               estimator=estimator if netprof_db else None,
                               log_fn=log_fn)
    # init and the steps under the sharding context: ep_a2a MoE layers
    # run expert-parallel over the mesh (models.moe)
    with use_sharding(ctx):
        state = init_state(model,
                           torch.Generator(device=dev).manual_seed(seed),
                           opt, compression=compression, dp=dp)
        comm_report(cfg, mesh, state.params, batch=batch, seq=seq,
                    compression=compression, log_fn=log_fn)
        start_step = 0
        ckpt = None
        if ckpt_dir:
            ckpt = AsyncCheckpointer(ckpt_dir)
            if restore_from:
                t0 = time.perf_counter()
                out = restore(state, ckpt_dir, log_fn=log_fn)
                if out is not None:
                    state, start_step = out
                    event = {"event": "restore", "step": start_step,
                             "bytes": tree_bytes(state),
                             "seconds": time.perf_counter() - t0}
                    log_fn(f"[restore] resumed from step {start_step}")
                    log_fn(f"[ckpt] restored {event['bytes'] / 1e9:.3f} GB "
                           f"in {event['seconds']:.2f} s")
                    if on_ckpt is not None:
                        on_ckpt(event)
        data = make_train_iterator(cfg, shape, num_hosts=num_hosts,
                                   host_id=host_id, seed=seed,
                                   start_step=start_step)
        hb = HeartbeatMonitor(
            os.path.join(ckpt_dir, "hb") if ckpt_dir
            else os.path.join(tempfile.gettempdir(), "repro_torch_hb"),
            num_hosts=num_hosts)
        mon = StepTimeMonitor()
        pol = StragglerPolicy()
        # disabled, the recorder's interval is exactly the two clock reads
        # a step's timing needs; with --obs it keeps the steps as spans
        rec = Recorder(enabled=obs)
        losses = []
        M.reset_traffic()
        reset_ep_calls()
        t_train0 = rec.clock()
        try:
            for i in range(start_step, steps):
                host_batch = next(data)
                dev_batch = {k: torch.as_tensor(v, device=dev)
                             for k, v in host_batch.items()}
                events = None
                if dev.type == "cuda":
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                    events[0].record()
                state, metrics, loss, dt = run_timed_step(
                    step_fn, state, dev_batch, rec, f"train_step{i}",
                    role="step", step=i)
                mon.record(host_id, dt)
                hb.beat(host_id, i)
                verdicts = pol.assess(mon)
                record = {"loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]), "host_ms": 1e3 * dt,
                          "device_ms": None,
                          "straggler": verdicts.get(host_id)}
                if events is not None:
                    events[1].record()
                    events[1].synchronize()
                    record["device_ms"] = events[0].elapsed_time(events[1])
                record.update({k: float(metrics[k]) for k in ("ce", "aux")})
                losses.append(loss)
                if on_step is not None:
                    on_step(i, record)
                if (i + 1) % log_every == 0 or i == start_step:
                    log_fn(
                        f"[step {i + 1:5d}] loss={loss:.4f} "
                        f"gnorm={record['grad_norm']:.3f} "
                        f"lr={record['lr']:.2e} {record['host_ms']:.0f}ms "
                        f"{batch * seq / dt:,.0f} tok/s"
                    )
                if ckpt and (i + 1) % ckpt_every == 0:
                    _save(ckpt, state, i + 1, log_fn)
                if verdicts.get(host_id) == "evict":
                    log_fn(f"[straggler] host {host_id} flagged for "
                           "eviction")
        finally:
            data.close()
        if ckpt:
            _save(ckpt, state, steps, log_fn)
            ckpt.wait()
            event = dict(ckpt.last, event="save", path=os.path.join(
                ckpt_dir, f"step_{steps:08d}"))
            log_fn(f"[ckpt] step {steps} written in {event['write_s']:.2f} "
                   f"s (background) to {event['path']}")
            if on_ckpt is not None:
                on_ckpt(event)
    wall = rec.clock() - t_train0
    ran = steps - start_step
    if plan is not None and ran > 0:
        moved = M.TRAFFIC.get("ppermute", 0) / (ran * dp * grad_accum)
        want = plan.boundary_bytes_per_step(micro_bs, seq)
        log_fn(f"[pp-parity] executed hops moved {moved:.0f} bytes a "
               f"pipeline pass (twin {want:.0f})")
        if moved != want:
            raise AssertionError(f"executed boundary bytes {moved} != twin "
                                 f"{want}")
    if cfg.moe is not None:     # which path each MoE layer took
        log_fn(f"[moe] impl={cfg.moe.impl}: MoE calls by path over {ran} "
               f"steps of {cfg.num_layers} layers (forward and remat "
               f"recompute): {dict(sorted(EP_CALLS.items()))}")
    log_fn(f"[done] {ran} steps in {wall:.1f}s" + (
        f"; loss {losses[0]:.3f} -> {losses[-1]:.3f}" if losses else ""))
    if obs:
        report, counts = _obs_report(
            rec, cfg, plan, mesh, state.params, batch=batch, seq=seq, dp=dp,
            grad_accum=grad_accum, compression=compression,
            overlap_buckets=overlap_buckets, estimator=estimator,
            trace_out=trace_out, run_spec=run_spec, log_fn=log_fn,
        )
        if on_obs is not None:
            on_obs(report, counts)
    return state, losses


def main(argv=None) -> None:
    from repro_torch.launch import spec as runspec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the shared launch surface lives in launch/spec.py (one declaration,
    # every driver); only the launcher's own knobs are declared here
    runspec.add_args(ap, "model", "train", "obs")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ranks", type=int, default=0,
                    help="logical ranks of the mesh (default: one per "
                         "visible CUDA device, or 1); data = ranks / pp")
    ap.add_argument("--moe-impl", dest="moe_impl",
                    choices=["einsum", "ep_a2a"], default=None,
                    help="MoE execution strategy (ep_a2a = explicit "
                         "all-to-all expert parallelism over the data "
                         "ranks, repro_torch.dist.ep_a2a)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override num_layers")
    ap.add_argument("--d-model", dest="d_model", type=int, default=0,
                    help="override d_model (head_dim follows: d_model / "
                         "num_heads)")
    ap.add_argument("--ckpt-dir", dest="ckpt_dir", default=None,
                    help="checkpoint directory: restore the newest valid "
                         "checkpoint there, save every 50 steps and at "
                         "the end")
    ap.add_argument("--no-restore", dest="no_restore", action="store_true",
                    help="with --ckpt-dir: start from step 0")
    args = ap.parse_args(argv)
    spec = runspec.from_args(args)

    cfg = get_config(spec.arch)
    if spec.smoke:
        cfg = smoke_variant(cfg)
    if args.moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=args.moe_impl))
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model,
                                  head_dim=args.d_model // cfg.num_heads)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    pipeline_on = spec.pp > 1 or spec.vstages > 1
    if pipeline_on:
        pipeline_plan_report(
            cfg, pp=spec.pp, schedule=spec.pp_schedule,
            vstages=spec.vstages,
            microbatches=spec.microbatches or max(spec.pp, 1),
            batch=spec.batch, seq=spec.seq,
            netprof_db=spec.netprof_db or None)
    train(cfg, steps=spec.steps, seq=spec.seq, batch=spec.batch, lr=args.lr,
          grad_accum=spec.grad_accum, compression=spec.compression,
          pp=spec.pp if pipeline_on else 0, pp_schedule=spec.pp_schedule,
          vstages=spec.vstages, microbatches=spec.microbatches,
          overlap_buckets=spec.overlap_buckets, ranks=args.ranks or None,
          ckpt_dir=args.ckpt_dir, restore_from=not args.no_restore,
          netprof_db=spec.netprof_db or None,
          analyze=spec.analyze, obs=spec.obs, trace_out=spec.trace_out,
          run_spec=spec, seed=spec.seed, device=args.device)


if __name__ == "__main__":
    main()
