"""Find a serve cell's knee: the highest arrival rate the engine sustains.

    python3 portbench/sweep.py --workload <cell> --rates 4,6,8,10,12,14 \\
        [--seconds 30] [--seed 7] [--out sweep.json]

One process on the card: the weights are made once from ``--seed``, and
each rate gets a fresh engine (warmed up) and one window of the cell's
traffic at that rate.  Per rate it prints the requests due, those finished
inside the window, the queue waiting for a slot every ``sample`` seconds
and at the close, TTFT and token-gap percentiles (wall clock from the due
time, as the benchmark's; a request unfinished at the close counts its
missing tokens there) and the tokens served a second in the window.  Above the
knee the queue grows all through the window.  The benchmark's own runs do
not run this; ``PERF.md`` keeps its readings and the rate chosen from them.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench.lib import device as D  # noqa: E402
from portbench.lib import discover  # noqa: E402

D.cache_env(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--sample", type=float, default=5.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from portbench.kinds import serve
    from portbench.lib import stats, traffic
    from portbench.run import Context

    w = discover.workload(args.workload)
    config = discover.config(w["config"])
    D.require_cards(int(w.get("chips", 1)))
    dev = torch.device("cuda", 0)
    ctx = Context(args.workload, w, config, args.seed, args.seconds, False,
                  dev)
    cfg, weights, engine = serve.build(ctx)
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        engine = serve.engine_of(cfg, weights, config, dev)
        reqs = traffic.make_requests(w["traffic"], args.seed, args.seconds,
                                     rate=rate)
        want = {r.rid: engine.serve_cfg.effective_max_tokens(
            r.prompt_len, r.max_new_tokens) for r in reqs}
        queue = []

        def sample(now, t0, eng=engine):
            if not queue or now - t0 >= args.sample * len(queue):
                queue.append(len(eng.sched.queue))

        win = serve.serve_window(engine, reqs, cfg.vocab_size, args.seconds,
                                 drain=0.0, on_step=sample)
        close = win["t0"] + args.seconds
        lat = serve.latencies(reqs, win, want)
        done = [r for r in reqs if r.rid in win["finished"]]
        tokens = sum(t <= close for ts in win["times"].values() for t in ts)
        row = {"rate": rate, "due": len(reqs), "finished": len(done),
               "queue_samples": queue, "queue_at_close": len(engine.sched.queue),
               "ttft_p50_ms": 1e3 * stats.percentile(lat["ttft"], 50),
               "ttft_p95_ms": 1e3 * stats.percentile(lat["ttft"], 95),
               "tpot_p50_ms": 1e3 * stats.percentile(lat["gaps"], 50),
               "tpot_p95_ms": 1e3 * stats.percentile(lat["gaps"], 95),
               "tokens_per_s": tokens / args.seconds,
               "steps": len(win["steps"]),
               "window_end_s": win["end"] - close}
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"workload": args.workload, "seconds": args.seconds,
              "seed": args.seed, "card": D.card(0), "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result["card"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
