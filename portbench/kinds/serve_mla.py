"""The serving runner of a latent-attention (MLA) MoE configuration
(Kimi-K2, DeepSeek-V3's equations).

As ``kinds/serve.py`` in every step: the same open loop, latencies, sample,
profiled stretch and result (``Run(kind="serve")``, so the engine-level
readers apply).  Three things differ, each because the configuration needs
it:

* the weights are ``lib.weights``'s, with the router's selection bias
  (``e_score_correction_bias``, not published) drawn from the seed at
  :data:`BIAS_STD`;
* ``correct`` is decided by ``reference/kimi_mla.py``, the plain float32
  forward pass in the published, expanded form, over each sampled prompt
  and its served tokens (the mean gap below the reference's best logit, as
  in ``kinds/serve.py``), at the served positions alone;
* ``dims`` carries the latent attention's numbers, and the log the MLA
  kernel's launches and the share of routed choices that landed on the
  experts this card holds, counted by the reference over the checked
  requests (``kimi_mla.CHOICES``: the program's routing is not counted, so
  the measured window runs no counting).

The parent of the change that added this runner has no latent attention: its
configuration fields are missing, so :func:`build` fails at once there.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.kinds import serve
from portbench.kinds.common import (
    Check, Run, arch_config, reset_peak, sub_seed,
)
from portbench.lib import devtrace, stats, traffic
from portbench.lib.weights import make_weights

# the router's selection bias: N(0, BIAS_STD^2), an assumption (the trained
# values are not published); a tenth of the sigmoid scores' spread near the
# top-8, so it reorders near ties as a trained bias does
BIAS_STD = 0.02


def dims(cfg) -> dict:
    from portbench.reference.kimi_mla import dims as ref_dims

    return ref_dims(cfg)


def build(ctx):
    """(cfg, weights, engine) of the cell, the engine warmed up."""
    from repro_torch.models import build_model

    cfg = arch_config(ctx.config)
    layout, _ = build_model(cfg).abstract_params()
    weights = make_weights(layout, ctx.seed, ctx.device)
    bias = weights["blocks"]["moe"]["router_bias"]
    gen = torch.Generator(device=ctx.device).manual_seed(sub_seed(ctx.seed, 2))
    bias.normal_(generator=gen).mul_(BIAS_STD)
    return cfg, weights, serve.engine_of(cfg, weights, ctx.config, ctx.device)


def serve_cell(ctx, profile_from: float | None = None, profiler=None) -> dict:
    """``kinds/serve.py::serve_cell`` over :func:`build`."""
    from repro_torch.kernels.mla_attention import ops as mla_ops
    from repro_torch.models import moe

    w_spec, device = ctx.workload, ctx.device
    reset_peak(device)
    cfg, weights, engine = build(ctx)
    reqs = traffic.make_requests(w_spec["traffic"], ctx.seed, ctx.seconds)
    want = {r.rid: engine.serve_cfg.effective_max_tokens(
        r.prompt_len, r.max_new_tokens) for r in reqs}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx.t_process
    moe.reset_ep_calls()
    mla_ops.LAUNCHES.reset()
    win = serve.serve_window(engine, reqs, cfg.vocab_size, ctx.seconds,
                             w_spec["drain_seconds"],
                             profile_from=profile_from, profiler=profiler)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    counts = {"mla_launches": mla_ops.LAUNCHES.count,
              "dropless_calls": moe.EP_CALLS.get("dropless", 0)}
    sample = serve.check_sample(reqs, win, want, ctx.seed,
                                w_spec["check_tokens"])
    served = [(traffic.prompt_tokens(r, cfg.vocab_size),
               engine.requests[r.rid].output) for r in sample]
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"cfg": cfg, "weights": weights, "reqs": reqs, "want": want,
            "win": win, "served": served, "peak": peak, "setup_s": setup_s,
            "counts": counts}


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
    lat = serve.latencies(reqs, win, got["want"])

    out = Run(kind="serve", dims=d, workload=w_spec)
    out.attempted, out.failed = len(reqs), lat["failed"]
    out.memory_peak_bytes = got["peak"]
    out.e2e = {"tpot_p95_ms": 1e3 * stats.percentile(lat["gaps"], 95),
               "peak_mem_gb": got["peak"] / 1e9, "setup_s": got["setup_s"]}
    out.extra = {"steps": [s for s in win["steps"]
                           if s["start"] < win["t0"] + ctx.seconds],
                 "serve": dict(ctx.config["serve"])}
    if prof is not None and prof.profiler is not None:
        out.trace = devtrace.from_profiler(prof)
    c = got["counts"]
    in_win = out.extra["steps"]
    out.log = {"requests": len(reqs), "failed": lat["failed"],
               "steps": len(win["steps"]),
               "ttft_p50_ms": 1e3 * stats.percentile(lat["ttft"], 50),
               "ttft_p95_ms": 1e3 * stats.percentile(lat["ttft"], 95),
               "tpot_p50_ms": 1e3 * stats.percentile(lat["gaps"], 50),
               "drain_s": win["end"] - (win["t0"] + ctx.seconds),
               "gaps": len(lat["gaps"]), **c,
               # lanes decoded a step and steps with no chunk, in the window
               "decode_lanes_mean": float(np.mean(
                   [len(st["decode"]) for st in in_win])) if in_win else 0.0,
               "decode_only_steps": sum(st["prefill"] is None
                                        for st in in_win)}

    from portbench.reference.kimi_mla import CHOICES

    t0 = time.perf_counter()
    served = got["served"]
    CHOICES.update(routed=0, held=0)
    gaps = served_gaps(got["weights"], served, d, device)
    mean = float("inf") if gaps is None else float(gaps.mean())
    out.log.update({"routed_choices": CHOICES["routed"],
                    "held_choices": CHOICES["held"],
                    "held_share": CHOICES["held"]
                    / max(1, CHOICES["routed"]),
                    "sampled": len(served),
                    "served_tokens": sum(len(o) for _, o in served),
                    "widest_gap": None if gaps is None
                    else float(gaps.max()),
                    "check_s": time.perf_counter() - t0})
    out.checks = [Check("mean_logit_gap", mean,
                        w_spec["limits"]["mean_logit_gap"])]
    return out


def reference_logits(weights, prompt, toks, d: dict, device,
                     precision: str = "fp32"):
    """The reference's logits at the positions that chose ``toks``: over
    the prompt and the served tokens but the last."""
    from portbench.reference import kimi_mla
    from portbench.reference.common import Precision, strict_fp32

    strict_fp32()
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                          device=device, dtype=torch.int64)
    at = torch.arange(len(prompt) - 1, len(seq), device=device)
    return kimi_mla.logits(weights, seq, d, Precision(precision), at)


def served_gaps(weights, served, d: dict, device):
    """Every served token's gap below the float32 reference's best logit,
    over the (prompt, tokens) pairs of ``served``; None where a request has
    no token."""
    out = []
    for prompt, toks in served:
        if not toks:
            return None
        out.append(serve.gaps_of(
            reference_logits(weights, prompt, toks, d, device), 1, toks))
    return torch.cat(out) if out else None
