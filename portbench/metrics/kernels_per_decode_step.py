"""kernels_per_decode_step: device kernels launched by a profiled engine step
that carries no prefill chunk (inside the harness's ``portbench.step``
range, with no ``portbench.prefill`` range in it)."""
import bisect


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None:
        return None
    pre = t.spans("portbench.prefill")
    steps = [(s, e) for s, e in t.spans("portbench.step")
             if not any(s <= ps and pe <= e for ps, pe in pre)]
    if not steps:
        return None
    ops = sorted((s, e) for _, s, e in t.kernels())
    starts = [s for s, _ in ops]
    n = 0
    for a, b in steps:
        i = bisect.bisect_left(starts, a)
        while i < len(ops) and ops[i][0] <= b:
            n += ops[i][1] <= b
            i += 1
    return n / len(steps) if n else None
