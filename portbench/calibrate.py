"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 12] [--out readings.json]

For every seed of ``--seeds`` it runs the program's side of a run and the
plain reference and prints the numbers compared (the lower readings: sound
runs of the program).  For every seed of ``--control-seeds`` it also reads
the control: the reference computed in float8 put in the program's place
(``reference.common.Precision("fp8")``), against the float32 reference.  A
training cell adds the fault of half the batch left out (planted in the
reference, the mean taken over the rest); a state left unchanged reads 1
by the change's measure and needs no run.  A serve cell's control reads, at
each served position, the gap of the token the float8 reference puts first;
both sides' gaps are printed as several statistics (``gap_stats``).

The benchmark's own runs do not run this; ``PERF.md`` keeps its readings
beside the limits set from them.
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


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_readings(ctx, control: bool) -> dict:
    """The program's readings for one seed; with ``control`` the float8
    reference's and the half-batch fault's beside them."""
    from portbench.kinds import train

    prog = train.Program(ctx)
    prog.free()
    ref = train.reference_readings(ctx, prog.layout, prog.dims)
    _free(ctx.device)
    out = {"program": train.readings(ref, prog.losses, prog.first_grad,
                                     prog.change, prog.names)}
    if control:
        for name, kw in (("control_fp8", {"precision": "fp8"}),
                         ("fault_half_batch", {"rows_keep": ctx.workload[
                             "traffic"]["batch"] // 2})):
            got = train.reference_readings(ctx, prog.layout, prog.dims, **kw)
            _free(ctx.device)
            out[name] = train.readings(ref, got["losses"], got["first_grad"],
                                       got["change"], prog.names)
    return out


def serve_readings(ctx, control: bool) -> dict:
    """The program's gaps for one seed, over a short window at the cell's
    load; with ``control`` the float8 reference's beside them."""
    import numpy as np
    import torch

    from portbench.kinds import serve
    from portbench.reference import moe_lm
    from portbench.reference.common import Precision, strict_fp32

    got = serve.serve_cell(ctx)
    cfg, weights, served = got["cfg"], got["weights"], got["served"]
    d = serve.dims(cfg)
    prog = serve.served_gaps(weights, served, d, ctx.device)
    reqs = got["reqs"]
    out = {"program": dict(gap_stats(prog), requests=len(served),
                           due=len(reqs), failed=len(reqs) - len(
                               got["win"]["finished"] & {r.rid for r in reqs}))}
    if control:
        strict_fp32()
        ctrl = []
        for prompt, toks in served:
            seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                                  device=ctx.device, dtype=torch.int64)
            ref = moe_lm.logits(weights, seq, d, Precision("fp32"))
            low = moe_lm.logits(weights, seq, d, Precision("fp8"))
            rows = slice(len(prompt) - 1, len(prompt) - 1 + len(toks))
            first = low[rows].argmax(dim=-1).tolist()
            ctrl.append(serve.gaps_of(ref, len(prompt), first))
        out["control_fp8"] = gap_stats(torch.cat(ctrl))
    del weights
    _free(ctx.device)
    return out


def gap_stats(gaps) -> dict:
    """Statistics of the served tokens' gaps below the reference's best."""
    g = gaps.float().sort().values
    n = g.numel()
    return {"tokens": n, "widest": float(g[-1]), "mean": float(g.mean()),
            "share_off": float((g > 0).float().mean()),
            "p90": float(g[int(0.9 * (n - 1))]),
            "p99": float(g[int(0.99 * (n - 1))])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from portbench.run import Context

    workload = discover.workload(args.workload)
    config = discover.config(workload["config"])
    D.require_cards(int(workload.get("chips", 1)))
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    read = {"train": train_readings, "serve": serve_readings}[
        workload["kind"]]
    rows = []
    for seed in seeds + sorted(ctrl - set(seeds)):
        t = time.perf_counter()
        ctx = Context(args.workload, workload, config, seed, args.seconds,
                      False, dev)
        row = dict(seed=seed, **read(ctx, seed in ctrl))
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row, default=float), flush=True)
    result = {"workload": args.workload, "card": D.card(0), "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, default=float,
                                             indent=1))
    print(json.dumps(result["card"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
