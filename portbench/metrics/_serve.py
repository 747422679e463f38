"""What the serve readers share: the window's un-profiled steps by kind, and
the profiled steps matched to the paged forward's device ranges."""


def window_steps(run, chunk=None):
    """Un-profiled steps of the window: with a prefill chunk (``chunk``
    True), decode only (False), or all (None)."""
    steps = [s for s in run.extra["steps"] if not s["profiled"]]
    if chunk is None:
        return steps
    if chunk:
        return [s for s in steps if s["prefill"] is not None]
    return [s for s in steps if s["prefill"] is None and s["decode"]]


def matched(run, name: str):
    """[(step, device ops)] of the profiled steps that called the paged
    forward's ``name`` (``prefill`` or ``decode``), in order, each with the
    device operations inside its call's range; None where the trace's ranges
    do not match the steps one for one."""
    t = run.trace
    if run.kind != "serve" or t is None:
        return None
    key = "prefill" if name == "prefill" else "decode"
    steps = [s for s in run.extra["steps"] if s["profiled"] and (
        s["prefill"] is not None if key == "prefill" else s["decode"])]
    spans = t.spans(f"portbench.{name}")
    if not steps or len(spans) != len(steps):
        return None
    ops = sorted(t.kernels(), key=lambda o: o[1])
    out, i = [], 0
    for step, (s, e) in zip(steps, spans):
        while i < len(ops) and ops[i][1] < s:
            i += 1
        inside = []
        j = i
        while j < len(ops) and ops[j][1] <= e:
            if ops[j][2] <= e:
                inside.append(ops[j])
            j += 1
        out.append((step, inside))
    return out
