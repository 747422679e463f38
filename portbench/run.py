"""Run one cell of the port's benchmark on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell's file (``portbench/workloads/``)
names its configuration and kind; the kind's runner (``portbench/kinds/``)
sets up the program (``src/repro_torch``) from the seed, measures for
``--seconds`` and checks what the timed path produced against the plain
reference (``portbench/reference/``).  With ``--trace 0`` the result holds
the cell's end-to-end metrics; with ``--trace 1`` its per-layer ones, each
read by its file under ``portbench/metrics/``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (the card's name, power
limit and clocks beside the peak memory; with ``--trace 1`` the device's
busy seconds and the traced window), ``breakdown`` with ``--trace 1``, and
last ``checks``: each number compared with its limit, which also end the
standard error.  Without a card, or with fewer than the cell asks for, it
prints no result and exits 2; if a module of JAX or of the JAX package is
loaded once the window has closed, it exits 3.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench.lib import device as D  # noqa: E402
from portbench.lib import discover  # noqa: E402

D.cache_env(ROOT)


@dataclass
class Context:
    """What a runner is given."""
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float = T_PROCESS


def _num(v) -> float:
    """A JSON number: a reading that is not finite (a request that never
    came, a gap with no tokens) is printed as the largest float."""
    v = float(v)
    return v if math.isfinite(v) else 1.7976931348623157e308


def result_line(run, names: list[str], trace: bool, device_info: dict,
                units: dict) -> dict:
    """The result's JSON object (``checks`` last)."""
    metrics = {}
    if trace:
        for name in names:
            v = discover.reader(name)(run)
            if v is not None:
                metrics[name] = {"value": _num(v), "unit": units[name]}
    else:
        for name in names:
            metrics[name] = {"value": _num(run.e2e[name]),
                             "unit": units[name]}
    dev = dict(device_info, platform="gpu", count=1,
               memory_peak_bytes=int(run.memory_peak_bytes))
    out = {"correct": all(c.ok for c in run.checks) and run.failed == 0
           and bool(run.checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.idle_gaps(10)}
    out["checks"] = {c.name: {"value": _num(c.value), "limit": c.limit}
                     for c in run.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    workload = discover.workload(args.workload)
    config = discover.config(workload["config"])
    try:
        D.require_cards(int(workload.get("chips", 1)))
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    import torch

    dev = torch.device("cuda", 0)
    before = D.card(0)
    ctx = Context(args.workload, workload, config, args.seed, args.seconds,
                  bool(args.trace), dev)
    run = discover.kind(workload["kind"]).run(ctx)
    bad = D.forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    after = D.card(0)
    info = dict(after, **{f"{k}.before": v for k, v in before.items()
                          if k != "kind"})
    bench = discover.benchmark()
    names = discover.metric_names(args.workload, bool(args.trace), bench)
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    out = result_line(run, names, bool(args.trace), info, units)
    out["log"] = run.log
    out["checks"] = out.pop("checks")
    print(json.dumps(run.log, default=str), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out, default=float))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
