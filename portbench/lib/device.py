"""The card a run uses, the caches it writes, and the import rule.

A run never falls back to the CPU: :func:`require_cards` refuses a host with
fewer cards than the cell asks for.  :func:`card` reads the card's name,
power limit and clocks (``nvidia-smi``) to print beside every number.
:func:`cache_env` keeps every build and kernel cache inside the checkout, at
fixed paths, so a cell's later runs there find its kernels built.
:func:`forbidden_modules` is the import rule: no module whose top-level name
is JAX's, flax's or the JAX package's may be loaded.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

# top-level module names, compared whole: the port (``repro_torch``) passes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.mem",
              "clocks.max.sm", "temperature.gpu")


def cache_env(root: Path) -> None:
    """Point the build and kernel caches at fixed directories under the
    checkout's ``build/`` (the port's kernels already build into
    ``build/kernels``)."""
    build = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    # a library that would load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_cards(n: int) -> None:
    """Raise unless ``n`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA card is visible; the benchmark "
                         "runs only on the card")
    have = torch.cuda.device_count()
    if have < n:
        raise SystemExit(f"portbench: the cell needs {n} cards, {have} "
                         "visible")


def card(index: int = 0) -> dict:
    """The card's name and its ``nvidia-smi`` readings (power limit, draw,
    clocks, temperature) now; readings ``nvidia-smi`` cannot give are left
    out."""
    import torch

    out = {"kind": torch.cuda.get_device_name(index)}
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=" + ",".join(SMI_FIELDS),
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True)
        vals = [v.strip() for v in res.stdout.strip().split(",")]
        for k, v in zip(SMI_FIELDS[1:], vals[1:]):
            try:
                out[k] = float(v)
            except ValueError:
                pass
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
