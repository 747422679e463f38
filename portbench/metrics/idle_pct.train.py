"""idle_pct.train: the share of the profiled train steps' wall time in which
no operation ran on the device (1 - union of their intervals / wall)."""


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
