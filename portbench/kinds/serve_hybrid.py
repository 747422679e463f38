"""The serving runner of a hybrid Mamba-2 / attention / MoE configuration.

As ``kinds/serve.py`` in every step: the same open loop, latencies, sample,
profiled stretch and result (``Run(kind="serve")``, so the engine-level
readers apply).  Three things differ, each because the hybrid stack needs
it:

* the weights come from ``lib.hybrid_weights`` (the Mamba-2 mixer's
  per-head vectors by their published initialisation, the embedding over
  its multiplier);
* ``correct`` is decided by ``reference/granite_hybrid.py``, the plain
  float32 forward pass of the configuration's ``reference`` key, over each
  sampled prompt and its served tokens (the mean gap below the reference's
  best logit, as in ``kinds/serve.py``);
* ``dims`` carries the Mamba-2 mixer's numbers and the scalings.

:func:`served_gaps` takes a ``precision`` and a ``reset_every`` for the
controls that set the cell's limit (``portbench/tune_hybrid.py``).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.kinds import serve
from portbench.kinds.common import Check, Run, arch_config, reset_peak
from portbench.lib import devtrace, stats, traffic
from portbench.lib.hybrid_weights import make_weights


def dims(cfg) -> dict:
    from portbench.reference.granite_hybrid import dims as ref_dims

    return ref_dims(cfg)


def check_pattern(config: dict, cfg) -> None:
    """The file's ``layer_types`` over the layers run are the port's: its
    attention layers where the file says attention."""
    from repro_torch.serve.paged import attention_layers

    want = [i for i, t in enumerate(config["layer_types"][:cfg.num_layers])
            if t == "attention"]
    if want != attention_layers(cfg):
        raise ValueError(f"{config['name']}: layer_types put attention at "
                         f"{want}, the port at {attention_layers(cfg)}")


def build(ctx):
    """(cfg, weights, engine) of the cell, the engine warmed up."""
    from repro_torch.models import build_model

    cfg = arch_config(ctx.config)
    check_pattern(ctx.config, cfg)
    layout, _ = build_model(cfg).abstract_params()
    weights = make_weights(layout, ctx.seed, ctx.device,
                           cfg.embedding_multiplier)
    return cfg, weights, serve.engine_of(cfg, weights, ctx.config,
                                         ctx.device)


def serve_cell(ctx, profile_from: float | None = None, profiler=None) -> dict:
    """``kinds/serve.py::serve_cell`` over :func:`build`."""
    w_spec, device = ctx.workload, ctx.device
    reset_peak(device)
    cfg, weights, engine = build(ctx)
    reqs = traffic.make_requests(w_spec["traffic"], ctx.seed, ctx.seconds)
    want = {r.rid: engine.serve_cfg.effective_max_tokens(
        r.prompt_len, r.max_new_tokens) for r in reqs}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx.t_process
    win = serve.serve_window(engine, reqs, cfg.vocab_size, ctx.seconds,
                             w_spec["drain_seconds"],
                             profile_from=profile_from, profiler=profiler)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    sample = serve.check_sample(reqs, win, want, ctx.seed,
                                w_spec["check_tokens"])
    served = [(traffic.prompt_tokens(r, cfg.vocab_size),
               engine.requests[r.rid].output) for r in sample]
    resets = engine.state_resets
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"cfg": cfg, "weights": weights, "reqs": reqs, "want": want,
            "win": win, "served": served, "peak": peak, "setup_s": setup_s,
            "state_resets": resets}


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
    out.log = {"requests": len(reqs), "failed": lat["failed"],
               "steps": len(win["steps"]),
               "state_resets": got["state_resets"],
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


def reference_logits(weights, prompt, toks, d: dict, device,
                     precision: str = "fp32", reset_every: int = 0):
    """The reference's logits over a prompt and its served tokens but the
    last."""
    from portbench.reference import granite_hybrid
    from portbench.reference.common import Precision, strict_fp32

    strict_fp32()
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                          device=device, dtype=torch.int64)
    return granite_hybrid.logits(weights, seq, d, Precision(precision),
                                 reset_every)


def served_gaps(weights, served, d: dict, device):
    """Every served token's gap below the float32 reference's best logit,
    over the (prompt, tokens) pairs of ``served``; None where a request has
    no token."""
    out = []
    for prompt, toks in served:
        if not toks:
            return None
        out.append(serve.gaps_of(
            reference_logits(weights, prompt, toks, d, device),
            len(prompt), toks))
    return torch.cat(out) if out else None
