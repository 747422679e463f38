"""Training launcher, one device: config -> model -> data -> train step.

The torch counterpart of the JAX package's ``launch/train.py`` for a single
device.  Runs on the CUDA card unless ``--device cpu`` is given; weights are
random, drawn from a ``torch.Generator`` seeded with ``--seed``; tokens come
from the synthetic pipeline (``repro_torch.data``), bit-equal to the JAX
package's batches.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --device cpu --steps 3 --seq 64 --batch 4

Each step is timed twice: on the host, up to the loss's host sync (as the
JAX launcher does, ``run_timed_step``), and on the card, between two CUDA
events around the step.

Not ported yet, and refused with the ROADMAP.md item that brings them:
``--pp`` and ``--compression`` (distributed), ``--ckpt-dir`` (checkpointing)
and ``--obs`` (telemetry replay).  The ``dense``, ``moe``, ``vlm`` and
``ssm`` families train; ``hybrid`` (the jamba superblock) and ``audio``
(encdec) raise with their ROADMAP.md items.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ShapeConfig, get_config, smoke_variant
from repro_torch.data import make_train_iterator
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.obs.record import Recorder
from repro_torch.optim import cosine_with_warmup, make_optimizer
from repro_torch.train.step import init_state, make_train_step, run_timed_step

_NOT_PORTED = {
    "pp": "pipeline parallelism (ROADMAP.md, 'Distributed')",
    "compression": "compressed data parallelism (ROADMAP.md, 'Distributed')",
    "ckpt_dir": "checkpointing (ROADMAP.md, 'Also later: ckpt/')",
    "obs": "the telemetry replay (ROADMAP.md, '--obs')",
}


def train(
    cfg,
    *,
    steps: int,
    seq: int,
    batch: int,
    lr: float = 3e-4,
    warmup: int = 20,
    grad_accum: int = 1,
    compression: str = "none",
    pp: int = 0,
    ckpt_dir: Optional[str] = None,
    obs: bool = False,
    log_every: int = 10,
    seed: int = 0,
    device="cuda",
    on_step: Optional[Callable[[int, dict], None]] = None,
    log_fn=print,
):
    """Train ``steps`` steps; returns ``(state, losses)``.

    ``on_step(i, record)`` is called after each step with its loss, the
    model's ``ce`` and ``aux``, grad norm, learning rate, host milliseconds
    and (on the card) device milliseconds.
    """
    asked = {"pp": pp > 1, "compression": compression not in ("", "none"),
             "ckpt_dir": bool(ckpt_dir), "obs": obs}
    for key, on in asked.items():
        if on:
            raise NotImplementedError(f"{key}: {_NOT_PORTED[key]} is not "
                                      "ported yet")
    dev = resolve_device(device)
    shape = ShapeConfig("train_launch", seq, batch, "train")
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    sched = cosine_with_warmup(lr, warmup, max(steps, warmup + 1))
    step_fn = make_train_step(model, opt, sched, grad_accum=grad_accum)
    state = init_state(model, torch.Generator(device=dev).manual_seed(seed),
                       opt)
    data = make_train_iterator(cfg, shape, seed=seed)
    rec = Recorder(enabled=False)
    losses = []
    t_train0 = rec.clock()
    try:
        for i in range(steps):
            host_batch = next(data)
            dev_batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in host_batch.items()}
            events = None
            if dev.type == "cuda":
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record()
            state, metrics, loss, dt = run_timed_step(
                step_fn, state, dev_batch, rec, f"train_step{i}",
                role="step", step=i)
            record = {"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                      "lr": float(metrics["lr"]), "host_ms": 1e3 * dt,
                      "device_ms": None}
            if events is not None:
                events[1].record()
                events[1].synchronize()
                record["device_ms"] = events[0].elapsed_time(events[1])
            record.update({k: float(metrics[k]) for k in ("ce", "aux")})
            losses.append(loss)
            if on_step is not None:
                on_step(i, record)
            if (i + 1) % log_every == 0 or i == 0:
                log_fn(
                    f"[step {i + 1:5d}] loss={loss:.4f} "
                    f"gnorm={record['grad_norm']:.3f} "
                    f"lr={record['lr']:.2e} {record['host_ms']:.0f}ms "
                    f"{batch * seq / dt:,.0f} tok/s"
                )
    finally:
        data.close()
    wall = rec.clock() - t_train0
    log_fn(f"[done] {steps} steps in {wall:.1f}s; "
           f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return state, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b",
                    help="a dense, moe, vlm or ssm architecture (the "
                         "families that train)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-sized)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--grad-accum", dest="grad_accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    # refused until ported (see _NOT_PORTED)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--compression", default="none")
    ap.add_argument("--ckpt-dir", dest="ckpt_dir", default=None)
    ap.add_argument("--obs", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    train(cfg, steps=args.steps, seq=args.seq, batch=args.batch, lr=args.lr,
          grad_accum=args.grad_accum, compression=args.compression,
          pp=args.pp, ckpt_dir=args.ckpt_dir, obs=args.obs, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
