"""attn_vjp_ms.train: device milliseconds a train step of the operations
inside the program's ``repro_torch::flash_attention.backward`` range (the
attention's plain VJP)."""

RANGE = "repro_torch::flash_attention.backward"


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not t.spans(RANGE):
        return None
    ops = t.within(RANGE)
    return 1e-3 * sum(e - s for _, s, e in ops) / run.extra["profiled_steps"]
