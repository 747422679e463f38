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

Not ported yet, and refused with the ROADMAP.md item that brings them:
``--ckpt-dir`` (checkpointing) and ``--obs`` (telemetry replay).  Every
family trains unpipelined; ``--pp`` takes the ``dense`` and ``moe``
families, as the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ShapeConfig, get_config, smoke_variant
from repro_torch.data import make_train_iterator
from repro_torch.device import resolve_device
from repro_torch.dist import mesh as M
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

_NOT_PORTED = {
    "ckpt_dir": "checkpointing (ROADMAP.md, 'Also later: ckpt/')",
    "obs": "the telemetry replay (ROADMAP.md, '--obs')",
}


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


def pipeline_plan_report(cfg, *, pp: int, schedule: str, vstages: int,
                         microbatches: int, batch: int, seq: int,
                         estimator=None, platform=None, log_fn=print):
    """Simulate the requested pipeline schedule for this config and log it
    (marked simulated): the same step table the executor runs, priced by
    the DES through ``Autotuner.evaluate``; bubble, comm share and the
    scheduled boundary traffic.  Logs instead of failing when the config
    cannot realize the schedule."""
    from repro_torch.core.autotuner import Autotuner
    from repro_torch.core.strategy import Strategy
    from repro_torch.models.pipeline import model_layer_cost

    strategy = Strategy(pp=pp, microbatches=microbatches, schedule=schedule,
                        vstages=vstages)
    kw = {}
    if estimator is not None:
        kw = {"estimator": estimator, "platform": platform}
    tuner = Autotuner(cfg, chips=pp, global_batch=max(batch, microbatches),
                      seq=seq, **kw)
    try:
        result = tuner.evaluate(strategy)
    except (ValueError, AssertionError, ZeroDivisionError) as e:
        log_fn(f"[pp-plan] {strategy.describe()} not realizable: {e}")
        return None
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
                           log_fn=print) -> dict:
    """Model-derived simulated bytes against the executor's twins; raises
    on drift.

    The simulator's collective-permute nodes over
    ``core.strategy.model_pipeline_graph`` must sum to exactly the
    scheduled boundary traffic the executor moves
    (``PipelinePlan.boundary_bytes_per_step``), and with ``dp > 1`` each
    stage's gradient all-reduce node to exactly
    ``compressed_psum_bytes`` of that stage's parameter tree.  Returns the
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
    return out


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
    obs: bool = False,
    log_every: int = 10,
    seed: int = 0,
    device="cuda",
    on_step: Optional[Callable[[int, dict], None]] = None,
    log_fn=print,
):
    """Train ``steps`` steps; returns ``(state, losses)``.

    ``on_step(i, record)`` is called after each step with its loss, the
    model's ``ce`` and ``aux``, grad norm, learning rate, host milliseconds
    and (on the card) device milliseconds.
    """
    asked = {"ckpt_dir": bool(ckpt_dir), "obs": obs}
    for key, on in asked.items():
        if on:
            raise NotImplementedError(f"{key}: {_NOT_PORTED[key]} is not "
                                      "ported yet")
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
                               compression=compression, log_fn=log_fn)
    # init and the steps under the sharding context: ep_a2a MoE layers
    # run expert-parallel over the mesh (models.moe)
    with use_sharding(ctx):
        state = init_state(model,
                           torch.Generator(device=dev).manual_seed(seed),
                           opt, compression=compression, dp=dp)
        comm_report(cfg, mesh, state.params, batch=batch, seq=seq,
                    compression=compression, log_fn=log_fn)
        data = make_train_iterator(cfg, shape, seed=seed)
        rec = Recorder(enabled=False)
        losses = []
        M.reset_traffic()
        reset_ep_calls()
        t_train0 = rec.clock()
        try:
            for i in range(steps):
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
                record = {"loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]), "host_ms": 1e3 * dt,
                          "device_ms": None}
                if events is not None:
                    events[1].record()
                    events[1].synchronize()
                    record["device_ms"] = events[0].elapsed_time(events[1])
                record.update({k: float(metrics[k]) for k in ("ce", "aux")})
                losses.append(loss)
                if on_step is not None:
                    on_step(i, record)
                if (i + 1) % log_every == 0 or i == 0:
                    log_fn(
                        f"[step {i + 1:5d}] loss={loss:.4f} "
                        f"gnorm={record['grad_norm']:.3f} "
                        f"lr={record['lr']:.2e} {record['host_ms']:.0f}ms "
                        f"{batch * seq / dt:,.0f} tok/s"
                    )
        finally:
            data.close()
    wall = rec.clock() - t_train0
    if plan is not None:
        moved = M.TRAFFIC.get("ppermute", 0) / (steps * dp * grad_accum)
        want = plan.boundary_bytes_per_step(micro_bs, seq)
        log_fn(f"[pp-parity] executed hops moved {moved:.0f} bytes a "
               f"pipeline pass (twin {want:.0f})")
        if moved != want:
            raise AssertionError(f"executed boundary bytes {moved} != twin "
                                 f"{want}")
    if cfg.moe is not None:     # which path each MoE layer took
        log_fn(f"[moe] impl={cfg.moe.impl}: MoE calls by path over {steps} "
               f"steps of {cfg.num_layers} layers (forward and remat "
               f"recompute): {dict(sorted(EP_CALLS.items()))}")
    log_fn(f"[done] {steps} steps in {wall:.1f}s; "
           f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return state, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b",
                    help="an architecture of configs/ (every family "
                         "trains)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-sized)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--grad-accum", dest="grad_accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ranks", type=int, default=0,
                    help="logical ranks of the mesh (default: one per "
                         "visible CUDA device, or 1); data = ranks / pp")
    ap.add_argument("--compression", choices=["none", "int8"],
                    default="none",
                    help="compressed data-parallel gradients: int8 payloads "
                         "with error-feedback residuals in "
                         "TrainState.comp_state (repro_torch.dist.compress)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: simulate the schedule AND run the "
                         "real model through the scheduled pipeline "
                         "executor on a (data, stage) mesh")
    ap.add_argument("--pp-schedule", dest="pp_schedule",
                    choices=["gpipe", "1f1b", "interleaved_1f1b"],
                    default="1f1b")
    ap.add_argument("--vstages", type=int, default=1,
                    help="virtual stages per rank (interleaved_1f1b)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pipeline microbatches (default: --pp)")
    ap.add_argument("--overlap-buckets", dest="overlap_buckets", type=int,
                    default=0,
                    help=">= 2: reduce the gradients in this many "
                         "reverse-order buckets (bit-exact)")
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
    # refused until ported (see _NOT_PORTED)
    ap.add_argument("--ckpt-dir", dest="ckpt_dir", default=None)
    ap.add_argument("--obs", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=args.moe_impl))
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model,
                                  head_dim=args.d_model // cfg.num_heads)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    pipeline_on = args.pp > 1 or args.vstages > 1
    if pipeline_on:
        pipeline_plan_report(
            cfg, pp=args.pp, schedule=args.pp_schedule,
            vstages=args.vstages,
            microbatches=args.microbatches or max(args.pp, 1),
            batch=args.batch, seq=args.seq)
    train(cfg, steps=args.steps, seq=args.seq, batch=args.batch, lr=args.lr,
          grad_accum=args.grad_accum, compression=args.compression,
          pp=args.pp if pipeline_on else 0, pp_schedule=args.pp_schedule,
          vstages=args.vstages, microbatches=args.microbatches,
          overlap_buckets=args.overlap_buckets, ranks=args.ranks or None,
          ckpt_dir=args.ckpt_dir, obs=args.obs, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
