"""Serving launcher: continuous-batching engine + its DES twin on one trace.

Runs on the CUDA card unless ``--device cpu`` is given.  Modes
(composable), with the JAX launcher's flag names:

    # real engine over a Poisson trace, latency percentiles
    python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --trace poisson --requests 8 --rate 50

    # measure the real serve steps into a shareable DB (platform key: the
    # card's spec name, e.g. h100_sxm; cpu_host with --device cpu)
    ... --calibrate --db serve_db.json

    # engine + replay twin + priced sim, one parity verdict
    ... --parity --db serve_db.json --report SERVE_parity.json

    # DES twin only — price the trace from a DB, never building the model;
    # --synthetic-db prices from the deterministic linear grid; the
    # simulated timeline is audited (T codes) and an error-level finding
    # exits 1
    ... --trace-file benchmarks/traces/serve_acceptance.json \\
        --simulate --synthetic-db

    # static gate: replay the KV-block ledger symbolically and audit
    # ProfileDB coverage (A005+), aborting before the model is built on an
    # error-level finding
    ... --analyze --synthetic-db \\
        --trace-file benchmarks/traces/serve_acceptance.json

    # re-check a serialized (possibly tampered) step plan on its own
    ... --analyze-plan SERVE_plan.json

    # telemetry: re-price the twin on the engine's measured step durations,
    # attribute the sim-vs-real gap by node uid (O codes) and write the
    # overlay (and <stem>_report.json beside it)
    ... --obs --trace-out serve_overlay.json

``--shard`` slot-shards the decode batch over ``--ranks`` logical ranks
(``repro_torch.dist.mesh``; default one per visible CUDA device, or 1):
the port's counterpart of the JAX launcher's ``--force-host-devices N
--shard``, which forces N XLA host devices.  The ranks of one card run one
after another.  Weights are random, drawn from a ``torch.Generator``
seeded with ``--seed``.  The shared flags are declared in ``launch/spec.py``,
as the reference's.
"""
from __future__ import annotations

import argparse
import os
import sys


def _parse(argv=None) -> argparse.Namespace:
    from repro_torch.launch import spec as runspec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # shared launch surface (launch/spec.py): --arch/--smoke/--seed, the
    # engine shape --slots/--max-len/--block-size/--chunk, and the
    # telemetry flags --obs/--trace-out (repro_torch.obs)
    runspec.add_args(ap, "model", "serve", "obs")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="EOS token id for engine early exit (-1: none; "
                         "parity runs must leave this unset — the twin "
                         "cannot predict token values)")
    # workload
    ap.add_argument("--trace", choices=["poisson", "bursty", "none"],
                    default="none",
                    help="generate an open-loop arrival trace (default: "
                         "all requests arrive at t=0)")
    ap.add_argument("--trace-file", default="",
                    help="load the trace from a JSON file (overrides "
                         "--trace); with --save-trace, write it instead")
    ap.add_argument("--save-trace", action="store_true",
                    help="write the generated trace to --trace-file and exit")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="poisson arrival rate (requests/s)")
    ap.add_argument("--burst-size", type=int, default=4)
    ap.add_argument("--burst-gap", type=float, default=0.2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    # modes
    ap.add_argument("--simulate", action="store_true",
                    help="DES twin only: price the trace, no model runs")
    ap.add_argument("--parity", action="store_true",
                    help="run engine AND twin, emit the serve parity report")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure the serve steps into --db and exit")
    ap.add_argument("--analyze", action="store_true",
                    help="statically verify the serve plan (R codes + "
                         "A005+ coverage when a DB is supplied) before the "
                         "model is built; abort on any error-level finding")
    ap.add_argument("--analyze-plan", default="",
                    help="check a serialized ServePlan JSON (no trace "
                         "replay: verifies the plan file as-is) and exit")
    ap.add_argument("--analyze-report", default="",
                    help="write the --analyze/--analyze-plan report JSON "
                         "here")
    ap.add_argument("--db", default="",
                    help="ProfileDB path for serve pricing / calibration")
    ap.add_argument("--synthetic-db", action="store_true",
                    help="price from the deterministic synthetic serve grid "
                         "instead of --db (bit-stable across hosts)")
    ap.add_argument("--tol-rel", type=float, default=0.5,
                    help="parity latency tolerance (relative)")
    ap.add_argument("--report", default="",
                    help="write the parity/latency report JSON here")
    # placement
    ap.add_argument("--ranks", type=int, default=0,
                    help="logical ranks of the --shard mesh (default: one "
                         "per visible CUDA device, or 1)")
    ap.add_argument("--shard", action="store_true",
                    help="slot-shard the decode batch over --ranks ranks")
    return ap.parse_args(argv)


def _build_trace(args):
    from repro_torch.serve.trace import (
        TraceRequest, bursty_trace, load_trace, poisson_trace, save_trace,
    )

    if args.trace_file and not args.save_trace:
        return load_trace(args.trace_file)
    if args.trace == "poisson":
        trace = poisson_trace(args.requests, args.rate, seed=args.seed)
    elif args.trace == "bursty":
        n_bursts = -(-args.requests // args.burst_size)
        trace = bursty_trace(
            n_bursts, args.burst_size, args.burst_gap, seed=args.seed
        )[: args.requests]
    else:
        trace = [
            TraceRequest(rid=r, arrival_s=0.0, prompt_len=args.prompt_len,
                         max_new_tokens=args.new_tokens, seed=args.seed)
            for r in range(args.requests)
        ]
    if args.save_trace:
        if not args.trace_file:
            raise SystemExit("--save-trace requires --trace-file")
        save_trace(args.trace_file, trace)
        print(f"[serve] wrote {len(trace)} requests to {args.trace_file}")
        return None
    return trace


def _serve_db(args, cfg, scfg, platform_name: str):
    from repro_torch.core.database import ProfileDB
    from repro_torch.serve.cost import synthetic_serve_calibration

    if args.synthetic_db:
        db = ProfileDB()
        synthetic_serve_calibration(
            db, cfg.name, platform_name, views=(scfg.view_len,),
            slot_grid=(1, 2, scfg.slots, 2 * scfg.slots),
        )
        return db
    if args.db:
        return ProfileDB.load_or_empty(args.db)
    return None


def _init_params(model, seed: int, device):
    import torch

    return model.init(torch.Generator(device=device).manual_seed(seed))


def _mesh(args, device):
    """The ("serve",) mesh of ``--ranks`` logical ranks under ``--shard``."""
    if not args.shard:
        return None
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.launch.train import default_ranks

    n = args.ranks or default_ranks(device)
    if args.slots % n:
        raise SystemExit(
            f"--shard needs slots ({args.slots}) divisible by device "
            f"count ({n})"
        )
    return make_mesh((n,), ("serve",), device)


def _run_engine(args, cfg, model, params, trace, device, mesh=None,
                recorder=None):
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.trace import prompt_tokens

    engine = ServeEngine(
        model, params, slots=args.slots, max_len=args.max_len,
        eos_id=None if args.eos_id < 0 else args.eos_id,
        block_size=args.block_size, chunk=args.chunk, device=device,
        mesh=mesh, recorder=recorder,
    )
    # keep first-call costs out of the measured step durations — the
    # parity gate compares them against offline-profiled predictions
    engine.warmup()
    for t in trace:
        engine.submit(
            Request(
                rid=t.rid, prompt=prompt_tokens(t, cfg.vocab_size),
                max_new_tokens=t.max_new_tokens, arrival_s=t.arrival_s,
            )
        )
    engine.run_until_done()
    return engine


def _print_report(report, args, spec) -> None:
    from repro_torch.launch import spec as runspec

    runspec.attach(report, spec)
    for line in report.summary_lines():
        print(f"[analyze] {line}")
    if args.analyze_report:
        report.to_json(args.analyze_report)
        print(f"[analyze] report written to {args.analyze_report}")
    report.raise_on_errors()


def main(argv=None) -> int:
    args = _parse(argv)

    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core.profiler import platform_of
    from repro_torch.device import resolve_device
    from repro_torch.launch import spec as runspec
    from repro_torch.models import build_model
    from repro_torch.serve.policy import ServeConfig

    device = resolve_device(args.device)
    spec = runspec.from_args(args)
    cfg = get_config(spec.arch)
    if spec.smoke:
        cfg = smoke_variant(cfg)
    scfg = ServeConfig(
        slots=spec.slots, max_len=spec.max_len,
        block_size=spec.block_size, chunk=spec.chunk,
    )
    platform = platform_of(device)
    print(f"[serve] {cfg.name} on {device} (platform {platform.name})")

    if args.analyze_plan:
        from repro_torch.analysis.serve_checks import (
            ServePlan, check_serve_plan,
        )

        plan = ServePlan.load(args.analyze_plan)
        _print_report(
            check_serve_plan(plan, name=f"plan:{args.analyze_plan}"),
            args, spec,
        )
        return 0

    if args.calibrate:
        from repro_torch.core.database import ProfileDB
        from repro_torch.serve.cost import calibrate_serve

        if not args.db:
            raise SystemExit("--calibrate requires --db")
        mesh = _mesh(args, device)
        db = ProfileDB.load_or_empty(args.db)
        model = build_model(cfg)
        params = _init_params(model, spec.seed, device)
        n = calibrate_serve(db, model, params, scfg, platform.name,
                            device=device, mesh=mesh)
        db.save(args.db)
        sharded = (f" (slot-sharded over {mesh.n_ranks} ranks)"
                   if mesh is not None else "")
        print(f"[serve] calibrated {n} serve entries for {cfg.name} "
              f"into {args.db}{sharded}")
        return 0

    trace = _build_trace(args)
    if trace is None:
        return 0

    if args.analyze:
        # statically reject leaks / double-frees / over-reservations and
        # name every pricing query that would miss the DB — before the
        # model is built
        from repro_torch.analysis.analyzer import analyze_serve_trace

        _print_report(
            analyze_serve_trace(
                trace, cfg.name, scfg,
                db=_serve_db(args, cfg, scfg, platform.name),
                platform=platform.name,
                db_path=args.db or "<synthetic>",
            ),
            args, spec,
        )
        if not (args.simulate or args.parity):
            return 0

    def _show(tag, latency):
        print(f"[serve] {tag}: {latency['requests']} requests, "
              f"{latency['total_tokens']} tokens, "
              f"goodput {latency['goodput_tok_per_s']:.1f} tok/s, "
              f"ttft p50 {latency['ttft_p50_s'] * 1e3:.2f}ms, "
              f"per-token p50/p99 {latency['per_token_p50_s'] * 1e3:.3f}/"
              f"{latency['per_token_p99_s'] * 1e3:.3f}ms")

    sim_res = None
    if args.simulate or args.parity or args.obs:
        from repro_torch.analysis import audit_serve_timeline
        from repro_torch.core.estimator import OpTimeEstimator
        from repro_torch.netprof.pricing import graph_provenance
        from repro_torch.serve.sim import simulate_serve

        db = _serve_db(args, cfg, scfg, platform.name)
        if db is None:
            if not (args.simulate or args.parity):
                # --obs alone: the overlay needs *a* priced twin; fall back
                # to the deterministic synthetic grid rather than refusing
                print("[obs] no --db/--synthetic-db: pricing the sim side "
                      "from the synthetic serve grid")
                args.synthetic_db = True
                db = _serve_db(args, cfg, scfg, platform.name)
            else:
                raise SystemExit(
                    "--simulate/--parity need --db or --synthetic-db"
                )
        est = OpTimeEstimator(platform, db=db, use_learned=False)
        sim_res = simulate_serve(trace, cfg, scfg, est,
                                 name=f"serve-{cfg.name}")
        _show("sim", sim_res.latency)
        audit = audit_serve_timeline(sim_res.timeline, sim_res.graph)
        prov = graph_provenance(sim_res.graph)
        print(f"[serve] sim provenance: {prov}")
        if not audit.ok:
            for d in audit.errors:
                print(f"[serve] AUDIT {d.code}: {d.message}")
            return 1
        if args.simulate and not (args.parity or args.obs):
            if args.report:
                from repro_torch.serve.report import save_report

                save_report(args.report, {"sim_latency": sim_res.latency,
                                          "provenance": prov,
                                          "run_spec": spec.to_dict()})
                print(f"[serve] wrote {args.report}")
            return 0

    from repro_torch.serve.report import (
        latency_report, records_from_requests, render_parity,
        save_report, serve_parity_report,
    )

    recorder = None
    if args.obs:
        from repro_torch.obs import Recorder

        recorder = Recorder(enabled=True)
    model = build_model(cfg)
    params = _init_params(model, spec.seed, device)
    engine = _run_engine(args, cfg, model, params, trace, device,
                         mesh=_mesh(args, device), recorder=recorder)
    records = records_from_requests(engine.finished)
    makespan = max(
        (t for r in engine.finished for t in r.token_times_s), default=0.0
    )
    eng_latency = latency_report(records, makespan)
    _show("engine", eng_latency)

    if args.obs:
        from repro_torch.obs import divergence_report, overlay_chrome_trace

        # re-price the twin in replay mode: the scheduler clock follows the
        # engine's measured step durations, so the compositions (and node
        # uids) are identical to what the recorder just observed, and the
        # divergence join measures pure pricing error instead of
        # admission-timing drift
        obs_sim = simulate_serve(
            trace, cfg, scfg, est, name=f"serve-{cfg.name}",
            step_durations=engine.step_durations,
        )
        obs_report = divergence_report(
            recorder, obs_sim.timeline, obs_sim.graph, name="serve-obs"
        )
        obs_report.metrics["obs_engine_step_s"] = float(
            sum(engine.step_durations)
        )
        runspec.attach(obs_report, spec)
        for line in obs_report.summary_lines():
            print(f"[obs] {line}")
        if spec.trace_out:
            overlay_chrome_trace(
                obs_sim.timeline, recorder, spec.trace_out,
                graph=obs_sim.graph,
            )
            print(f"[obs] overlay trace written to {spec.trace_out}")
            rpath = os.path.splitext(spec.trace_out)[0] + "_report.json"
            obs_report.to_json(rpath)
            print(f"[obs] divergence report written to {rpath}")

    if not args.parity:
        if args.report:
            save_report(args.report, {"engine_latency": eng_latency,
                                      "run_spec": spec.to_dict()})
            print(f"[serve] wrote {args.report}")
        return 0

    from repro_torch.serve.sim import replay_schedule

    twin = replay_schedule(trace, scfg, engine.step_durations)
    report = serve_parity_report(
        engine.step_log, twin.step_log,
        engine_latency=eng_latency,
        sim_latency=sim_res.latency if sim_res else None,
        tol_rel=args.tol_rel,
    )
    report["run_spec"] = spec.to_dict()
    print(render_parity(report))
    if args.report:
        save_report(args.report, report)
        print(f"[serve] wrote {args.report}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
