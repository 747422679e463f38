"""The readings a hybrid serve cell's rate and limit are set from, on the card.

    python3 portbench/tune_hybrid.py knee --workload <cell> \\
        --rates 2,3,4,5 [--seconds 30] [--seed 7] [--out knee.json]
    python3 portbench/tune_hybrid.py limits --workload <cell> \\
        --seeds 1,2,3 --control-seeds 1,2 [--seconds 20] [--out lim.json]

``knee`` is ``portbench/sweep.py`` over ``kinds/serve_hybrid.py``'s build:
the weights made once, a fresh warmed-up engine and one window of the
cell's traffic a rate; per rate the requests due and finished, the queue
waiting for a slot and the slots live (sampled every ``--sample`` seconds),
TTFT and token-gap percentiles, the tokens served a second over the window
and over its second half beside the demand (the rate times the mean tokens
a request asks for).  A rate is sustained where the second half serves its
demand with no queue left: give the window three request lifetimes or more.  ``limits`` is ``portbench/calibrate.py``'s serve readings over the
same build: per seed the program's gaps below the float32 reference
(``reference/granite_hybrid.py``); per control seed two controls put in
the program's place over the same served sequences, each read as the gap
of the token it puts first: the reference in float8
(``common.Precision("fp8")``) and the reference with each Mamba layer's
state zeroed at every multiple of the scan's chunk (``reset_every``).

The benchmark's own runs do not run this; ``PERF.md`` keeps its readings
and what was chosen from them.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench.lib import device as D  # noqa: E402
from portbench.lib import discover  # noqa: E402

D.cache_env(ROOT)


def _free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def knee(ctx, rates: list[float], sample_s: float) -> list[dict]:
    import torch  # noqa: F401

    from portbench.kinds import serve, serve_hybrid
    from portbench.lib import stats, traffic

    w = ctx.workload
    cfg, weights, engine = serve_hybrid.build(ctx)
    rows = []
    for rate in rates:
        del engine
        _free()
        engine = serve.engine_of(cfg, weights, ctx.config, ctx.device)
        reqs = traffic.make_requests(w["traffic"], ctx.seed, ctx.seconds,
                                     rate=rate)
        want = {r.rid: engine.serve_cfg.effective_max_tokens(
            r.prompt_len, r.max_new_tokens) for r in reqs}
        queue, live = [], []

        def sample(now, t0, eng=engine):
            if not queue or now - t0 >= sample_s * len(queue):
                queue.append(len(eng.sched.queue))
                live.append(sum(s is not None for s in eng.sched.slots))

        win = serve.serve_window(engine, reqs, cfg.vocab_size, ctx.seconds,
                                 drain=0.0, on_step=sample)
        close = win["t0"] + ctx.seconds
        half = win["t0"] + ctx.seconds / 2
        lat = serve.latencies(reqs, win, want)
        tokens = sum(t <= close for ts in win["times"].values() for t in ts)
        late = sum(half < t <= close for ts in win["times"].values()
                   for t in ts)
        row = {"rate": rate, "due": len(reqs),
               "finished": len([r for r in reqs
                                if r.rid in win["finished"]]),
               "queue_samples": queue,
               "live_samples": live,
               "live_late_mean": sum(live[len(live) // 2:])
               / max(1, len(live) - len(live) // 2),
               "demand_tokens_per_s": rate * sum(want.values())
               / max(1, len(want)),
               "late_tokens_per_s": late / (ctx.seconds / 2),
               "queue_at_close": len(engine.sched.queue),
               "ttft_p50_ms": 1e3 * stats.percentile(lat["ttft"], 50),
               "ttft_p95_ms": 1e3 * stats.percentile(lat["ttft"], 95),
               "tpot_p50_ms": 1e3 * stats.percentile(lat["gaps"], 50),
               "tpot_p95_ms": 1e3 * stats.percentile(lat["gaps"], 95),
               "tokens_per_s": tokens / ctx.seconds,
               "steps": len(win["steps"])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def limits(ctx, control: bool) -> dict:
    """The program's gaps for one seed, over a window at the cell's load;
    with ``control`` the two controls' beside them."""
    import torch

    from portbench.calibrate import gap_stats
    from portbench.kinds import serve, serve_hybrid

    got = serve_hybrid.serve_cell(ctx)
    weights, served = got["weights"], got["served"]
    d = serve_hybrid.dims(got["cfg"])
    prog = serve_hybrid.served_gaps(weights, served, d, ctx.device)
    out = {"program": dict(gap_stats(prog), requests=len(served),
                           due=len(got["reqs"]),
                           finished=len(got["win"]["finished"]),
                           peak_gb=got["peak"] / 1e9)}
    if control:
        for name, kw in (("control_fp8", {"precision": "fp8"}),
                         ("control_state_reset",
                          {"reset_every": d["chunk"]})):
            gaps = []
            for prompt, toks in served:
                ref = serve_hybrid.reference_logits(weights, prompt, toks,
                                                    d, ctx.device)
                low = serve_hybrid.reference_logits(weights, prompt, toks,
                                                    d, ctx.device, **kw)
                rows = slice(len(prompt) - 1, len(prompt) - 1 + len(toks))
                gaps.append(serve.gaps_of(ref, len(prompt),
                                          low[rows].argmax(-1).tolist()))
            out[name] = gap_stats(torch.cat(gaps))
    del weights
    _free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("knee", "limits"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="7")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--sample", type=float, default=5.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from portbench.run import Context

    w = discover.workload(args.workload)
    config = discover.config(w["config"])
    D.require_cards(int(w.get("chips", 1)))
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    if args.mode == "knee":
        ctx = Context(args.workload, w, config, seeds[0], args.seconds,
                      False, dev)
        rows = knee(ctx, [float(r) for r in args.rates.split(",")],
                    args.sample)
    else:
        for seed in seeds + sorted(ctrl - set(seeds)):
            t = time.perf_counter()
            ctx = Context(args.workload, w, config, seed, args.seconds,
                          False, dev)
            row = dict(seed=seed, **limits(ctx, seed in ctrl))
            row["seconds"] = time.perf_counter() - t
            rows.append(row)
            print(json.dumps(row, default=float), flush=True)
    result = {"workload": args.workload, "mode": args.mode,
              "card": D.card(0), "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, default=float,
                                             indent=1))
    print(json.dumps(result["card"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
