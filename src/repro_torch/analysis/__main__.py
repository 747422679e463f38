"""CLI: sweep the static analyzer over every registered config.

    PYTHONPATH=src python -m repro_torch.analysis [--json report.json] \
        [--pp 4] [--microbatches 8] [--seq 512] [--netprof-db db.json] \
        [--no-sim] [--serve-trace trace.json] [--serve-json serve.json]

Exit status 0 when every analyzed plan is free of error-level findings,
1 otherwise — the ``scripts/check.sh analyze`` CI gate.  With
``--serve-trace`` the sweep also replays the trace's KV-block ledger
(R codes) and audits ProfileDB coverage for every arch's serve grid
(A005+); ``--serve-json`` writes that half — findings plus the per-arch
coverage documents — as its own artifact.

A copy of the JAX package's ``analysis/__main__.py``; ``--netprof-db``
prices through the train launcher's ``netprof_estimator``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.analyzer import analyze_all_configs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="statically verify pipeline plans for every config",
    )
    ap.add_argument("--json", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--micro-batch", type=int, default=1,
                    help="sequences per microbatch for the cost model")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--no-sim", action="store_true",
                    help="skip the DES run + timeline audit (static only)")
    ap.add_argument("--netprof-db", default=None,
                    help="calibrated ProfileDB: audit collective pricing "
                         "provenance (A003 on silent ring fallback)")
    ap.add_argument("--serve-trace", default=None,
                    help="serve request trace (JSON): replay the KV-block "
                         "ledger (R codes) and audit serve ProfileDB "
                         "coverage (A005+) for every arch")
    ap.add_argument("--serve-json", default=None,
                    help="write the serve-sweep report (findings + "
                         "coverage documents) here")
    args = ap.parse_args(argv)

    estimator = None
    if args.netprof_db:
        from repro_torch.launch.train import netprof_estimator

        estimator, _ = netprof_estimator(args.netprof_db)

    serve_report = None
    if args.serve_trace:
        from repro_torch.analysis.analyzer import analyze_serve_sweep
        from repro_torch.serve.trace import load_trace

        serve_report = analyze_serve_sweep(
            load_trace(args.serve_trace), log_fn=print
        )

    report = analyze_all_configs(
        pp=args.pp,
        microbatches=args.microbatches,
        micro_batch=args.micro_batch,
        seq=args.seq,
        estimator=estimator,
        run_sim=not args.no_sim,
        log_fn=print,
    )
    if serve_report is not None:
        if args.serve_json:
            serve_report.to_json(args.serve_json)
            print(f"[analyze] serve report written to {args.serve_json}")
        report.extend(serve_report)
    for line in report.summary_lines():
        print(line)
    if args.json:
        report.to_json(args.json)
        print(f"[analyze] report written to {args.json}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
