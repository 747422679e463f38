"""The readings a latent-attention serve cell's rate and limit are set from,
on the card.

    python3 portbench/tune_mla.py knee --workload <cell> \\
        --rates 0.4,0.6,0.8 [--seconds 60] [--seed 7] [--out knee.json]
    python3 portbench/tune_mla.py limits --workload <cell> \\
        --seeds 1,2 --control-seeds 1 [--seconds 30] [--out lim.json]

``knee`` is ``tune_hybrid.py``'s sweep over ``kinds/serve_mla.py``'s build
(the weights made once, a fresh warmed-up engine and one window of the
cell's traffic a rate).  ``limits``: per seed the program's gaps below the
float32 reference (``reference/kimi_mla.py``); per control seed the
reference in float8 (``common.Precision("fp8")``, both operands of every
product rounded) put in the program's place over the same served
sequences, read as the gap of the token it puts first.

The benchmark's own runs do not run this; ``PERF.md`` keeps its readings
and what was chosen from them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import tune_hybrid  # noqa: E402
from portbench.lib import device as D  # noqa: E402
from portbench.lib import discover  # noqa: E402


def limits(ctx, control: bool) -> dict:
    import torch

    from portbench.calibrate import gap_stats
    from portbench.kinds import serve, serve_mla

    got = serve_mla.serve_cell(ctx)
    weights, served = got["weights"], got["served"]
    d = serve_mla.dims(got["cfg"])
    t = time.perf_counter()
    prog = serve_mla.served_gaps(weights, served, d, ctx.device)
    out = {"program": dict(gap_stats(prog), requests=len(served),
                           due=len(got["reqs"]),
                           finished=len(got["win"]["finished"]),
                           check_s=time.perf_counter() - t,
                           peak_gb=got["peak"] / 1e9, **got["counts"])}
    if control:
        gaps = []
        for prompt, toks in served:
            ref = serve_mla.reference_logits(weights, prompt, toks, d,
                                             ctx.device)
            low = serve_mla.reference_logits(weights, prompt, toks, d,
                                             ctx.device, "fp8")
            gaps.append(serve.gaps_of(ref, 1, low.argmax(-1).tolist()))
        out["control_fp8"] = gap_stats(torch.cat(gaps))
    del weights
    tune_hybrid._free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("knee", "limits"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="7")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--sample", type=float, default=5.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from portbench.kinds import serve_hybrid, serve_mla
    from portbench.run import Context

    w = discover.workload(args.workload)
    config = discover.config(w["config"])
    D.require_cards(int(w.get("chips", 1)))
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    if args.mode == "knee":
        # the sweep builds through serve_hybrid.build: this cell's build
        serve_hybrid.build = serve_mla.build
        ctx = Context(args.workload, w, config, seeds[0], args.seconds,
                      False, dev)
        rows = tune_hybrid.knee(ctx, [float(r) for r in
                                      args.rates.split(",")], args.sample)
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
