"""What the runners share: the configuration as the program runs it, the
numbers the references and work counts read, and a run's record.

A configuration's file (``portbench/configs/<name>.json``) holds its
published keys with the values as run, and under ``program`` the port's
registered configuration (``arch``) and which field each key sets
(``fields``; ``moe.x`` sets a field of the MoE settings, a literal under
``set`` sets a field the source has no key for).  :func:`arch_config`
applies them and checks that the result reads back the file's values, so
the program runs the configuration as the file states it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


def _assign(cfg, path: str, value):
    if "." in path:
        head, rest = path.split(".", 1)
        return dataclasses.replace(
            cfg, **{head: _assign(getattr(cfg, head), rest, value)})
    cur = getattr(cfg, path)
    if isinstance(cur, float) and isinstance(value, int):
        value = float(value)
    return dataclasses.replace(cfg, **{path: value})


def _read(cfg, path: str):
    for part in path.split("."):
        cfg = getattr(cfg, part)
    return cfg


def arch_config(config: dict):
    """The port's ``ArchConfig`` for a configuration's file."""
    from repro_torch.configs.base import get_config

    prog = config["program"]
    cfg = get_config(prog["arch"])
    pairs = [(f, config[k]) for k, f in prog["fields"].items()]
    pairs += list(prog.get("set", {}).items())
    for f, v in pairs:
        cfg = _assign(cfg, f, v)
    for f, v in pairs:
        if _read(cfg, f) != v:
            raise ValueError(f"{config['name']}: {f} reads {_read(cfg, f)}, "
                             f"the file states {v}")
    return cfg


def dims(cfg) -> dict:
    """The plain numbers of an ``ArchConfig`` that the references and the
    work counts read."""
    moe = cfg.moe
    return {
        "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers,
        "frontend_dim": cfg.frontend_dim, "norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta,
        "experts": moe.num_experts if moe else 0,
        "top_k": moe.top_k if moe else 0,
        "d_ff_expert": moe.d_ff_expert if moe else 0,
    }


def reset_peak(device) -> None:
    """Start the card's peak-memory counter afresh (the CUDA context made
    first: a process that has not touched the card yet cannot reset it)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    s = int(seed) % (1 << 63)
    for p in parts:
        s = (s * 1_000_003 + int(p) + 1) % (1 << 63)
    return s


@dataclass
class Check:
    """One number compared, with its limit; ``ok`` when within it."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    """What a runner hands back: the end-to-end metrics it took, and what
    the per-layer readers read."""
    kind: str
    dims: dict
    workload: dict
    e2e: dict = field(default_factory=dict)          # name -> value
    checks: list = field(default_factory=list)        # Check
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: Optional[Any] = None                        # lib.devtrace
    extra: dict = field(default_factory=dict)          # for the readers
    log: dict = field(default_factory=dict)            # printed, not read
