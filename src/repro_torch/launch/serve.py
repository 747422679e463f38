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
    # --synthetic-db prices from the deterministic linear grid
    ... --trace-file benchmarks/traces/serve_acceptance.json \\
        --simulate --synthetic-db

Weights are random, drawn from a ``torch.Generator`` seeded with ``--seed``.
Not ported yet: ``--analyze``, ``--analyze-plan``, ``--obs``, ``--shard``
and ``--force-host-devices``.
"""
from __future__ import annotations

import argparse
import sys


def _parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-sized)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", dest="max_len", type=int, default=128)
    ap.add_argument("--block-size", dest="block_size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=32)
    # workload
    ap.add_argument("--trace", choices=["poisson", "none"], default="none",
                    help="generate an open-loop arrival trace (default: "
                         "all requests arrive at t=0)")
    ap.add_argument("--trace-file", default="",
                    help="load the trace from a JSON file (overrides --trace)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="poisson arrival rate (requests/s)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    # modes
    ap.add_argument("--simulate", action="store_true",
                    help="DES twin only: price the trace, no model runs")
    ap.add_argument("--parity", action="store_true",
                    help="run engine AND twin, emit the serve parity report")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure the serve steps into --db and exit")
    ap.add_argument("--db", default="",
                    help="ProfileDB path for serve pricing / calibration")
    ap.add_argument("--synthetic-db", action="store_true",
                    help="price from the deterministic synthetic serve grid "
                         "instead of --db (bit-stable across hosts)")
    ap.add_argument("--tol-rel", type=float, default=0.5,
                    help="parity latency tolerance (relative)")
    ap.add_argument("--report", default="",
                    help="write the parity/latency report JSON here")
    return ap.parse_args(argv)


def _build_trace(args):
    from repro_torch.serve.trace import TraceRequest, load_trace, poisson_trace

    if args.trace_file:
        return load_trace(args.trace_file)
    if args.trace == "poisson":
        return poisson_trace(args.requests, args.rate, seed=args.seed)
    return [
        TraceRequest(rid=r, arrival_s=0.0, prompt_len=args.prompt_len,
                     max_new_tokens=args.new_tokens, seed=args.seed)
        for r in range(args.requests)
    ]


def _platform_for(device):
    """The PlatformSpec the DB is keyed by: the card's, or the CPU host's."""
    import torch

    from repro_torch.core.hardware import CPU_HOST, platform_for_device

    if device.type == "cuda":
        return platform_for_device(torch.cuda.get_device_name(device))
    return CPU_HOST


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


def _run_engine(args, cfg, model, params, trace, device):
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.trace import prompt_tokens

    engine = ServeEngine(
        model, params, slots=args.slots, max_len=args.max_len,
        block_size=args.block_size, chunk=args.chunk, device=device,
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


def main(argv=None) -> int:
    args = _parse(argv)

    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve.policy import ServeConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    scfg = ServeConfig(
        slots=args.slots, max_len=args.max_len,
        block_size=args.block_size, chunk=args.chunk,
    )
    platform = _platform_for(device)
    print(f"[serve] {cfg.name} on {device} (platform {platform.name})")

    if args.calibrate:
        from repro_torch.core.database import ProfileDB
        from repro_torch.serve.cost import calibrate_serve

        if not args.db:
            raise SystemExit("--calibrate requires --db")
        db = ProfileDB.load_or_empty(args.db)
        model = build_model(cfg)
        params = _init_params(model, args.seed, device)
        n = calibrate_serve(db, model, params, scfg, platform.name,
                            device=device)
        db.save(args.db)
        print(f"[serve] calibrated {n} serve entries for {cfg.name} "
              f"into {args.db}")
        return 0

    trace = _build_trace(args)

    def _show(tag, latency):
        print(f"[serve] {tag}: {latency['requests']} requests, "
              f"{latency['total_tokens']} tokens, "
              f"goodput {latency['goodput_tok_per_s']:.1f} tok/s, "
              f"ttft p50 {latency['ttft_p50_s'] * 1e3:.2f}ms, "
              f"per-token p50/p99 {latency['per_token_p50_s'] * 1e3:.3f}/"
              f"{latency['per_token_p99_s'] * 1e3:.3f}ms")

    sim_res = None
    if args.simulate or args.parity:
        from repro_torch.core.estimator import OpTimeEstimator
        from repro_torch.netprof.pricing import graph_provenance
        from repro_torch.serve.sim import simulate_serve

        db = _serve_db(args, cfg, scfg, platform.name)
        if db is None:
            raise SystemExit("--simulate/--parity need --db or --synthetic-db")
        est = OpTimeEstimator(platform, db=db, use_learned=False)
        sim_res = simulate_serve(trace, cfg, scfg, est, name=f"serve-{cfg.name}")
        _show("sim", sim_res.latency)
        prov = graph_provenance(sim_res.graph)
        print(f"[serve] sim provenance: {prov}")
        if args.simulate and not args.parity:
            if args.report:
                from repro_torch.serve.report import save_report

                save_report(args.report, {"sim_latency": sim_res.latency,
                                          "provenance": prov})
                print(f"[serve] wrote {args.report}")
            return 0

    from repro_torch.serve.report import (
        latency_report, records_from_requests, render_parity,
        save_report, serve_parity_report,
    )

    model = build_model(cfg)
    params = _init_params(model, args.seed, device)
    engine = _run_engine(args, cfg, model, params, trace, device)
    records = records_from_requests(engine.finished)
    makespan = max(
        (t for r in engine.finished for t in r.token_times_s), default=0.0
    )
    eng_latency = latency_report(records, makespan)
    _show("engine", eng_latency)

    if not args.parity:
        if args.report:
            save_report(args.report, {"engine_latency": eng_latency})
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
    print(render_parity(report))
    if args.report:
        save_report(args.report, report)
        print(f"[serve] wrote {args.report}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
