"""idle_pct.serve: the share of the profiled stretch of the serve window in
which no operation ran on the device."""


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
