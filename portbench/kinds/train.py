"""The training runner: a closed loop of the port's train step.

Set-up makes the weights from the seed on the device, builds one
``TrainState`` and one ``make_train_step`` step around them, and drives
that step through its first ``check_steps`` steps on the window's own feed
(these build the kernels and warm every shape up).  The window then runs the
same step on further batches until ``--seconds`` have passed; every batch
is drawn on the device from the seed and the step's index, so all rows
differ.  ``train_tokens_per_s`` is the target tokens of every step run
over the time from the window's start to the end of its last step.

With ``--trace 1`` two more steps run under ``torch.profiler``.

``correct``: the plain reference (``reference/encdec.py``) follows the
first ``check_steps`` steps from the same weights and batches once the
program's state is freed.  Compared: each step's loss, the first gradient as
the optimizer got it (AdamW's first moment after one step over 1 - b1) and
each leaf's change after the check steps, both by the worst leaf: the gap
between the program's norm and the reference's against the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change (they move by round-off alone).
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench.kinds.common import (
    Check, Run, arch_config, dims, reset_peak, sub_seed,
)
from portbench.lib import devtrace, work
from portbench.lib.weights import flatten, make_weights

PROFILED_STEPS = 2


def feed(cfg, job: dict, seed: int, step: int, device) -> dict:
    """Batch ``step`` of the run (``job``: the traffic file): tokens,
    next-token labels and frames, drawn on the device from the seed and the
    step's index."""
    b, s = job["batch"], job["seq"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1, step))
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)
    out = {"tokens": toks[:, :-1].contiguous(),
           "labels": toks[:, 1:].contiguous()}
    if cfg.family == "audio":
        out["frames"] = torch.randn(
            (b, job["frames"], cfg.frontend_dim), generator=gen,
            device=device, dtype=torch.float32).to(torch.bfloat16)
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _leaf_gap(prog: dict, ref: dict, names: list) -> tuple[float, str]:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in ref)
    worst, at = 0.0, ""
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if g > worst:
            worst, at = g, n
    return worst, at


class Program:
    """The program's side of a run: the weights from the seed, one
    ``TrainState`` and one ``make_train_step`` step, driven through the
    check steps.  Holds their losses, the first gradient by leaf (from
    AdamW's first moment) and each leaf's change over them."""

    def __init__(self, ctx):
        from repro_torch.models import build_model
        from repro_torch.optim.optimizers import adamw
        from repro_torch.optim.schedules import cosine_with_warmup
        from repro_torch.train.step import TrainState, make_train_step

        self.ctx, self.device = ctx, ctx.device
        self.job = job = ctx.workload["traffic"]
        opt_spec = job["optimizer"]
        self.cfg = arch_config(ctx.config)
        self.dims = dims(self.cfg)
        model = build_model(self.cfg)
        self.layout, _ = model.abstract_params()
        reset_peak(self.device)
        params = make_weights(self.layout, ctx.seed, self.device)
        self.names = [n for n, _ in flatten(params)]
        for _, p in flatten(params):
            p.requires_grad_(True)
        opt = adamw(b1=opt_spec["b1"], b2=opt_spec["b2"], eps=opt_spec["eps"],
                    weight_decay=opt_spec["weight_decay"])
        self.state = TrainState(
            torch.zeros((), dtype=torch.int32, device=self.device), params,
            opt.init(params), None)
        self.step_fn = make_train_step(
            model, opt, cosine_with_warmup(opt_spec["lr"], opt_spec["warmup"],
                                           opt_spec["total_steps"]),
            grad_accum=job["grad_accum"], max_grad_norm=opt_spec["clip"])

        self.losses = []
        for i in range(ctx.workload["check_steps"]):
            self.losses.append(self.step(i))
            if i == 0:
                m = dict(flatten(self.state.opt_state["m"]))
                self.first_grad = {n: float(m[n].norm()) / (1 - opt_spec["b1"])
                                   for n in self.names}
                del m
        start = dict(flatten(make_weights(self.layout, ctx.seed, self.device)))
        now = dict(flatten(self.state.params))
        self.change = {n: float((now[n].detach() - start[n]).norm())
                       for n in self.names}
        del start, now
        _sync(self.device)

    def step(self, i: int) -> float:
        """Step ``i`` of the run on its batch; its loss."""
        self.state, metrics = self.step_fn(
            self.state, feed(self.cfg, self.job, self.ctx.seed, i,
                             self.device))
        return float(metrics["loss"])

    def free(self) -> None:
        self.state = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(ctx) -> Run:
    device = ctx.device
    prog = Program(ctx)
    job = prog.job

    # the window
    tokens = job["batch"] * job["seq"]
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    ends, i = [], ctx.workload["check_steps"]
    while time.perf_counter() < t0 + ctx.seconds:
        loss = prog.step(i)
        _sync(device)
        ends.append(time.perf_counter())
        i += 1
        if loss != loss:
            raise FloatingPointError(f"step {i}: the loss is NaN")
    wall = ends[-1] - t0

    trace = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW_RANGE):
                for _ in range(PROFILED_STEPS):
                    prog.step(i)
                    i += 1
                _sync(device)
        trace = devtrace.from_profiler(prof)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    d = prog.dims
    out = Run(kind="train", dims=d, workload=ctx.workload)
    out.attempted = len(ends)
    out.memory_peak_bytes = peak
    out.e2e = {"train_tokens_per_s": len(ends) * tokens / wall,
               "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    rows = job["batch"] // job["grad_accum"]
    passes = 1 if prog.cfg.remat_policy == "none" else 2
    out.extra = {
        "step_s": wall / len(ends),
        "step_flops": work.encdec_train_flops(d, job["batch"], job["frames"],
                                              job["seq"]),
        "flash_calls": (work.flash_train_calls(d, rows, job["frames"],
                                               job["seq"])
                        * passes * job["grad_accum"]),
        "profiled_steps": PROFILED_STEPS if ctx.trace else 0,
    }
    out.trace = trace
    out.log = {"steps_in_window": len(ends), "check_losses": prog.losses,
               "step_s": [b - a for a, b in zip([t0] + ends, ends)]}

    # the program's state goes before the reference runs
    prog.free()
    ref = reference_readings(ctx, prog.layout, d)
    r = readings(ref, prog.losses, prog.first_grad, prog.change, prog.names)
    lim = ctx.workload["limits"]
    out.log.update({"reference_losses": ref["losses"],
                    "grad_at": r["grad_at"], "change_at": r["change_at"],
                    "left_out": r["left_out"]})
    out.checks = [Check(k, r[k], lim[k])
                  for k in ("loss_gap", "grad_gap", "change_gap")]
    return out


def reference_readings(ctx, layout, d, precision: str = "fp32",
                       rows_keep: int | None = None) -> dict:
    """The reference's check steps from the seed's weights and batches;
    ``rows_keep`` keeps that many rows of every batch (a planted fault)."""
    from portbench.reference import encdec
    from portbench.reference.common import Precision, strict_fp32

    cfg = arch_config(ctx.config)
    strict_fp32()
    w_spec, job = ctx.workload, ctx.workload["traffic"]
    weights = make_weights(layout, ctx.seed, ctx.device)
    batches = []
    for i in range(w_spec["check_steps"]):
        b = feed(cfg, job, ctx.seed, i, ctx.device)
        if rows_keep is not None:
            b = {k: v[:rows_keep] for k, v in b.items()}
        batches.append(b)
    return encdec.train_steps(weights, batches, d, job["optimizer"],
                              Precision(precision),
                              rows_per_block=w_spec["reference_rows"])


def readings(ref: dict, losses: list, first_grad: dict, change: dict,
             names: list) -> dict:
    """The numbers compared, each with the leaf it was read on."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    grad_gap, grad_at = _leaf_gap(first_grad, ref["first_grad"], names)
    med = statistics.median(ref["first_grad"].values())
    moved = [n for n in names if ref["first_grad"][n] >= 1e-3 * med]
    change_gap, change_at = _leaf_gap(change, ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "grad_at": grad_at,
            "change_gap": change_gap, "change_at": change_at,
            "left_out": sorted(set(names) - set(moved))}
