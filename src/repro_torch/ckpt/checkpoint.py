"""Checkpointing with atomic manifests and an async writer.

The torch counterpart of the JAX package's ``ckpt/checkpoint.py``, in its
format 2 byte for byte, so either package restores the other's checkpoints.

Layout:  <dir>/step_<N>/
            manifest.json      {"format": 2, "step": N,
                                "leaves": {path: file}, "complete": true}
            <leaf>.npy         one file per pytree leaf, named by its path
                               with ``/`` spelled ``__``

Leaf paths are :func:`repro_torch.tree.flatten_with_path`'s: dict keys,
sequence indices and NamedTuple field names (``step``, ``params/...``,
``opt_state/...``, ``comp_state/...``), so the port's ``TrainState``
flattens to exactly the reference's leaf keys.

Format history: v1 had no ``"format"`` key and spelled NamedTuple fields
``.step`` / ``.params``; ``restore`` migrates those keys.  Missing
``comp_state`` leaves (error-feedback residuals of compressed data-parallel
training) are zero-initialised for any format: a dense checkpoint resumes
compressed training from zero residuals, which is exact.

Crash safety: leaves are written into ``step_<N>.tmp`` first, the manifest
last, and the directory is renamed into place, so a reader only trusts a
directory with a complete manifest.  ``restore`` walks the steps newest
first and skips a corrupt or incomplete one, logging the step and the
reason.

Where the port differs from the reference:

* **The snapshot is a completed host copy.**  ``AsyncCheckpointer.save``
  copies every leaf to the host before it returns (a blocking device-to-host
  copy, ordered after the step's kernels on the card).  The port's train
  step updates parameters and moments in place, so a view read later by the
  writer thread would hold a later step; the writer thread never touches a
  CUDA tensor.
* **bf16 leaves without ``ml_dtypes``.**  numpy has no bfloat16.  A bf16
  leaf is written as its 2-byte words under the type description ``<V2``,
  the file numpy writes for the JAX package's bf16 arrays; a 2-byte void
  leaf is read back as bf16 bits.  The JAX package cannot restore such a
  leaf (ROADMAP.md, C16: its ``astype`` has no cast from void and its
  ``restore`` skips the step); the port restores them, its own and the
  JAX package's.
* **Restore places each leaf on its like-leaf's device and dtype** and keeps
  its ``requires_grad``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, map_with_path

CKPT_FORMAT = 2

# leaf keys that may be missing from any manifest and are zero-initialized
# on restore: dense checkpoints (v1 always, v2 when compression was off)
# carry no error-feedback residuals, and zero residuals resume compressed
# training exactly
_ZERO_INIT_PREFIXES = ("comp_state",)

# the .npy type description of a bf16 leaf: what numpy writes for the JAX
# package's (ml_dtypes) bfloat16 arrays
_BF16_DESCR = "<V2"


def _key(path: tuple) -> str:
    return "/".join(path)


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def snapshot(tree) -> Any:
    """The tree with every leaf copied to host memory, detached: its own
    storage, complete when this returns."""
    return map_with_path(
        lambda _, leaf: _as_tensor(leaf).to("cpu", copy=True), tree)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in (_as_tensor(x) for _, x in flatten_with_path(tree)))


def _write_leaf(path: str, t: torch.Tensor) -> None:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False,
                    "shape": tuple(int(n) for n in t.shape)})
            t.view(torch.int16).numpy().tofile(f)
    else:
        np.save(path, t.numpy())


def _migrate_v1_keys(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Normalize v1 key spellings to v2: strip the ``str(GetAttrKey)`` dot
    prefix from every path segment (``.params/w`` -> ``params/w``)."""
    return {
        "/".join(seg.lstrip(".") for seg in key.split("/")): arr
        for key, arr in flat.items()
    }


def _to_like(key: str, arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(
            f"leaf {key}: checkpoint shape {arr.shape} != expected "
            f"{tuple(like.shape)}")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bf16 words
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device=like.device, dtype=like.dtype, copy=True)
    return t.requires_grad_() if like.requires_grad else t


def _unflatten(tree_like, flat: dict[str, np.ndarray],
               zero_init_prefixes: tuple[str, ...] = ()):
    def leaf(path, like):
        key = _key(path)
        if key not in flat:
            if key.startswith(zero_init_prefixes or ("\0",)):
                return torch.zeros(tuple(like.shape), dtype=like.dtype,
                                   device=like.device)
            raise KeyError(f"checkpoint missing leaf {key}")
        return _to_like(key, flat[key], like)

    return map_with_path(leaf, tree_like)


def save(tree, directory: str, step: int, keep: int = 3) -> str:
    """Blocking save (leaves copied to the host first). Returns the
    checkpoint path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = {}
    for path, leaf in flatten_with_path(tree):
        key = _key(path)
        fname = key.replace("/", "__") + ".npy"
        _write_leaf(os.path.join(tmp, fname), _as_tensor(leaf).cpu())
        leaves[key] = fname
    manifest = {
        "format": CKPT_FORMAT,
        "step": step,
        "leaves": leaves,
        "complete": True,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory, keep)
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _gc(directory: str, keep: int):
    steps = _steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _try_load(directory: str, step: int, tree_like):
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if not manifest.get("complete"):
        raise ValueError("incomplete manifest")
    fmt = int(manifest.get("format", 1))
    if fmt > CKPT_FORMAT:
        raise ValueError(f"checkpoint format {fmt} > supported {CKPT_FORMAT}")
    flat = {}
    for key, fname in manifest["leaves"].items():
        flat[key] = np.load(os.path.join(path, fname))
    if fmt < 2:
        flat = _migrate_v1_keys(flat)
    return (
        _unflatten(tree_like, flat, zero_init_prefixes=_ZERO_INIT_PREFIXES),
        manifest["step"],
    )


def restore(tree_like, directory: str,
            log_fn: Callable[[str], None] = print
            ) -> Optional[tuple[Any, int]]:
    """Restore the newest valid checkpoint into ``tree_like``'s structure,
    devices and dtypes; skip corrupt or incomplete ones, logging each with
    its reason.  None if none is valid."""
    for step in reversed(_steps(directory)):
        try:
            return _try_load(directory, step, tree_like)
        except (OSError, EOFError, ValueError, KeyError) as e:
            log_fn(f"[restore] skipped step {step} in {directory}: "
                   f"{type(e).__name__}: {e}")
    return None


class AsyncCheckpointer:
    """Saves on a writer thread; at most one in flight.

    ``save`` copies the tree to host memory before it returns (the blocking
    part) and writes the files in the background, so the train loop only
    ever blocks on the snapshot.  ``last`` holds the latest save's step,
    bytes and seconds (``snapshot_s``; ``write_s`` once written).
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.last: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, tree, step: int) -> None:
        self.wait()
        t0 = time.perf_counter()
        host = snapshot(tree)
        info = {"step": step, "bytes": tree_bytes(host),
                "snapshot_s": time.perf_counter() - t0}
        self.last = info

        def run():
            t1 = time.perf_counter()
            try:
                save(host, self.directory, step, keep=self.keep)
                info["write_s"] = time.perf_counter() - t1
            except Exception as e:      # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
