"""The result line: its keys, ``checks`` last, every number a plain JSON
number, the per-layer metrics of a traced toy run that find something to
read on the CPU."""
import json

from portbench.kinds import serve
from portbench.lib import discover
from portbench.run import result_line
from portbench.tests import tiny


def test_result_line_of_a_traced_toy_run():
    ctx = tiny.context("serve", 12, seconds=2.0, trace=True, exact=True)
    run = serve.run(ctx)
    bench = discover.benchmark()
    names = discover.metric_names(ctx.name, True, bench)
    units = {m["name"]: m["unit"] for m in bench["per_layer"]}
    out = result_line(run, names, True, {"kind": "cpu"}, units)
    line = json.loads(json.dumps(out, allow_nan=False))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    rate = ctx.workload["traffic"]["arrivals"]["rate"]
    assert line["attempted"] == round(rate * ctx.seconds)
    assert line["failed"] == 0
    # the host-side readers find their steps; the device's need the card
    assert {"decode_step_ms.p50", "prefill_step_ms.p50",
            "host_gap_ms.serve", "mfu.decode"} <= set(line["metrics"])
    assert set(line["metrics"]) <= set(names)
    assert {"device_ops", "idle_gaps"} == set(line["breakdown"])
    assert line["checks"]["mean_logit_gap"]["limit"] == \
        ctx.workload["limits"]["mean_logit_gap"]


def test_a_missing_reading_is_a_finite_number():
    from portbench.run import _num

    assert _num(float("inf")) > 1e300
    assert _num(2.5) == 2.5
