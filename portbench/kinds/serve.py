"""The serving runner: open-loop traffic through the port's ``ServeEngine``.

Set-up makes the weights from the seed on the device (in the dtype they are
served in), builds the engine with the configuration's ``serve`` settings
and runs ``ServeEngine.warmup()``, which calls every prefill bucket and the
decode batch once.  The window then submits each request of the cell's
traffic (``lib.traffic.make_requests``) once its due time on the host's
wall clock has passed, and steps the engine while it has work.  Requests
due in the window that finish after it still count; the engine runs on for
at most ``drain_seconds`` past the window's close.

Latency is the host's wall clock from a request's due time: its first token
(``ttft``) and every gap between consecutive tokens (``tpot``) are stamped
when the engine step that produced them returns (the step's argmax readback
has synchronised the card).  A request that never finishes counts as
missing: its ttft, and a gap, as the time from its due time to the end of
the drain.  The end-to-end metric is the 95th percentile of the gaps; the
TTFT percentiles are printed in the result's log only, since they swing by
a fifth from run to run of one seed (``PERF.md``).

With ``--trace 1`` the last ``profile_seconds`` of the window run under
``torch.profiler``, the harness marking each engine step
(``portbench.step``) and each call into the paged forward
(``portbench.prefill``, ``portbench.decode``).  Step times for the
per-layer metrics come from the steps before it.

``correct``: a sample of finished requests drawn from the seed, the longest
among them, until ``check_tokens`` served tokens.  The plain reference
(``reference/moe_lm.py``) runs once over each prompt and its served tokens,
and the number compared is the mean, over those tokens, of the gap by which
a served token's logit lies below the reference's best logit at its
position (0 where the program served the reference's choice).  The widest
gap is printed beside it: in bfloat16 it is set by tokens whose top-8
experts flip on a near tie, and the float8 control reads no wider (see
``PERF.md``), so the mean is what tells the two apart.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.kinds.common import (
    Check, Run, arch_config, dims, reset_peak,
)
from portbench.lib import devtrace, stats, traffic
from portbench.lib.weights import make_weights


def engine_of(cfg, weights, config: dict, device):
    """A warmed-up ``ServeEngine`` over ``weights`` with the configuration's
    ``serve`` settings."""
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    engine = ServeEngine(build_model(cfg), weights, device=device,
                         **config["serve"])
    engine.warmup()
    return engine


def build(ctx):
    """(cfg, weights, engine) of the cell, the engine warmed up."""
    from repro_torch.models import build_model

    cfg = arch_config(ctx.config)
    layout, _ = build_model(cfg).abstract_params()
    weights = make_weights(layout, ctx.seed, ctx.device)
    return cfg, weights, engine_of(cfg, weights, ctx.config, ctx.device)


class _Profiled:
    """A ``torch.profiler`` run over a stretch of the window, with the
    paged forward's calls under named ranges and the stretch under
    ``devtrace.WINDOW_RANGE``."""

    def __init__(self, prof):
        from repro_torch.serve import paged

        self.prof, self.paged = prof, paged
        self.orig = {"prefill_chunk": paged.prefill_chunk,
                     "decode_batch": paged.decode_batch}
        self.window = torch.profiler.record_function(devtrace.WINDOW_RANGE)

    def __enter__(self):
        def marked(name, fn):
            def call(*a, **k):
                with torch.profiler.record_function(f"portbench.{name}"):
                    return fn(*a, **k)
            return call

        self.prof.__enter__()
        self.paged.prefill_chunk = marked("prefill", self.orig["prefill_chunk"])
        self.paged.decode_batch = marked("decode", self.orig["decode_batch"])
        self.window.__enter__()
        return self

    def __exit__(self, *exc):
        self.window.__exit__(None, None, None)
        for k, fn in self.orig.items():
            setattr(self.paged, k, fn)
        self.prof.__exit__(None, None, None)


def serve_window(engine, reqs, vocab: int, seconds: float, drain: float,
                 clock=time.perf_counter, profile_from: float | None = None,
                 profiler=None, on_step=None) -> dict:
    """Run the open loop; returns per-request token times, the steps (start,
    end, composition, decode lane lengths) and the profiler where one ran.

    ``profile_from``: seconds into the window at which ``profiler`` (a
    ``torch.profiler.profile``) starts; it stops when the window closes.
    ``on_step(now, t0)`` is called once a turn of the loop."""
    from repro_torch.serve.engine import Request

    t0 = clock()
    due = [t0 + r.arrival_s for r in reqs]
    times: dict[int, list[float]] = {r.rid: [] for r in reqs}
    live: dict[int, object] = {}
    steps, nxt = [], 0
    profiled, done_profiling = None, profile_from is None
    deadline, close = t0 + seconds + drain, t0 + seconds
    sched = engine.sched
    while True:
        now = clock()
        if not done_profiling and profiled is None and \
                now >= t0 + profile_from:
            profiled = _Profiled(profiler).__enter__()
        if profiled is not None and now >= close:
            profiled.__exit__()
            profiled, done_profiling = None, True
        while nxt < len(reqs) and due[nxt] <= now:
            r = reqs[nxt]
            req = Request(rid=r.rid, prompt=traffic.prompt_tokens(r, vocab),
                          max_new_tokens=r.max_new_tokens, arrival_s=0.0)
            engine.submit(req)
            live[r.rid] = req
            nxt += 1
        if on_step is not None:
            on_step(now, t0)
        if sched.outstanding():
            lengths = [s.length if s is not None and s.phase == "decode"
                       else None for s in sched.slots]
            if profiled is not None:
                with torch.profiler.record_function("portbench.step"):
                    ts = clock()
                    engine.step()
                    te = clock()
            else:
                ts = clock()
                engine.step()
                te = clock()
            sig = engine.step_log[-1]
            steps.append({"start": ts, "end": te,
                          "prefill": sig[2], "decode": list(sig[3]),
                          "lengths": [lengths[s] for s in sig[3]],
                          "dur": engine.step_durations[-1],
                          "profiled": profiled is not None,
                          "pending_after": sched.outstanding()})
            for rid in list(live):
                req = live[rid]
                got = times[rid]
                while len(got) < len(req.output):
                    got.append(te)
                if req.done:
                    del live[rid]
        elif nxt < len(reqs):
            time.sleep(max(0.0, min(due[nxt] - clock(), 0.05)))
        else:
            break
        if clock() > deadline:
            break
    if profiled is not None:
        profiled.__exit__()
    return {"t0": t0, "end": clock(), "due": due, "times": times,
            "steps": steps, "submitted": nxt,
            "finished": {r.rid for r in engine.finished}}


def latencies(reqs, win: dict, want: dict) -> dict:
    """TTFT and token gaps (seconds) of every request due in the window; a
    request that did not finish counts its missing tokens at the end of the
    run."""
    ttft, gaps, failed = [], [], 0
    end = win["end"]
    for r, due in zip(reqs, win["due"]):
        t = win["times"][r.rid]
        full = r.rid in win["finished"] and len(t) == want[r.rid]
        if not full:
            failed += 1
            t = t + [end] * max(1, want[r.rid] - len(t))
        ttft.append(t[0] - due)
        gaps.extend(b - a for a, b in zip(t, t[1:]))
    return {"ttft": ttft, "gaps": gaps, "failed": failed}


def serve_cell(ctx, profile_from: float | None = None, profiler=None) -> dict:
    """Set up, run the window and drain, read the peak memory, draw the
    check's sample and free the engine (the weights stay for the
    reference).  Returns what a run and the calibration read."""
    w_spec, device = ctx.workload, ctx.device
    reset_peak(device)
    cfg, weights, engine = build(ctx)
    reqs = traffic.make_requests(w_spec["traffic"], ctx.seed, ctx.seconds)
    want = {r.rid: engine.serve_cfg.effective_max_tokens(
        r.prompt_len, r.max_new_tokens) for r in reqs}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx.t_process
    win = serve_window(engine, reqs, cfg.vocab_size, ctx.seconds,
                       w_spec["drain_seconds"], profile_from=profile_from,
                       profiler=profiler)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    sample = check_sample(reqs, win, want, ctx.seed, w_spec["check_tokens"])
    served = [(traffic.prompt_tokens(r, cfg.vocab_size),
               engine.requests[r.rid].output) for r in sample]
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"cfg": cfg, "weights": weights, "reqs": reqs, "want": want,
            "win": win, "served": served, "peak": peak, "setup_s": setup_s}


def run(ctx) -> Run:
    w_spec, device = ctx.workload, ctx.device
    prof_from, prof = None, None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof_from = max(0.0, ctx.seconds - w_spec["profile_seconds"])
        prof = profile(activities=acts)
    got = serve_cell(ctx, prof_from, prof)
    reqs, win, d = got["reqs"], got["win"], dims(got["cfg"])
    lat = latencies(reqs, win, got["want"])

    out = Run(kind="serve", dims=d, workload=w_spec)
    out.attempted, out.failed = len(reqs), lat["failed"]
    out.memory_peak_bytes = got["peak"]
    out.e2e = {"tpot_p95_ms": 1e3 * stats.percentile(lat["gaps"], 95),
               "peak_mem_gb": got["peak"] / 1e9, "setup_s": got["setup_s"]}
    out.extra = {"steps": [s for s in win["steps"]
                           if s["start"] < win["t0"] + ctx.seconds]}
    if prof is not None and prof.profiler is not None:
        out.trace = devtrace.from_profiler(prof)
    out.log = {"requests": len(reqs), "failed": lat["failed"],
               "steps": len(win["steps"]),
               "ttft_p50_ms": 1e3 * stats.percentile(lat["ttft"], 50),
               "ttft_p95_ms": 1e3 * stats.percentile(lat["ttft"], 95),
               "tpot_p50_ms": 1e3 * stats.percentile(lat["gaps"], 50),
               "drain_s": win["end"] - (win["t0"] + ctx.seconds),
               "gaps": len(lat["gaps"])}

    served = got["served"]
    gaps = served_gaps(got["weights"], served, d, device)
    mean = float("inf") if gaps is None else float(gaps.mean())
    out.log.update({"sampled": len(served),
                    "served_tokens": sum(len(o) for _, o in served),
                    "widest_gap": None if gaps is None
                    else float(gaps.max())})
    out.checks = [Check("mean_logit_gap", mean,
                        w_spec["limits"]["mean_logit_gap"])]
    return out


def check_sample(reqs, win, want, seed: int, tokens: int) -> list:
    """Finished requests due in the window, drawn from the seed: the one
    with the most tokens first, then others until ``tokens`` served
    tokens."""
    done = [r for r in reqs if r.rid in win["finished"]
            and len(win["times"][r.rid]) == want[r.rid]]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + want[r.rid], -r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(seed).permutation(len(rest))
    out, n = [longest], want[longest.rid]
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += want[rest[i].rid]
    return out


def gaps_of(logits: torch.Tensor, prompt_len: int, served) -> torch.Tensor:
    """How far each served token's logit lies below the best at its
    position: ``logits`` (S, vocab) over the prompt and the served tokens."""
    rows = logits[prompt_len - 1:prompt_len - 1 + len(served)]
    tok = torch.as_tensor(served, device=rows.device, dtype=torch.int64)
    return rows.max(dim=-1).values - rows.gather(1, tok[:, None])[:, 0]


def served_gaps(weights, served, d: dict, device,
                precision: str = "fp32"):
    """Every served token's gap below the reference's best logit, over the
    (prompt, tokens) pairs of ``served``; None where a request has no
    token."""
    from portbench.reference import moe_lm
    from portbench.reference.common import Precision, strict_fp32

    strict_fp32()
    pr = Precision(precision)
    out = []
    for prompt, toks in served:
        if not toks:
            return None
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              device=device, dtype=torch.int64)
        out.append(gaps_of(moe_lm.logits(weights, seq, d, pr), len(prompt),
                           toks))
    return torch.cat(out) if out else None
