"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel package keeps its CUDA C++ source under ``<name>/csrc/``.  The
source exposes a plain C interface (no PyTorch headers), so one ``nvcc`` call
per package builds a shared library in seconds::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so <name>/csrc/*.cu

Libraries are built at first use into ``build/kernels/`` at the repository
root and cached by a hash of the sources and flags, so a second process (or
a second call) loads the library without compiling.  :func:`build_all`
starts one ``nvcc`` per package at once.  A build that fails raises; there
is no fallback to the plain version.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Kernel launches made by one wrapper (plain launches on the CPU path
    do not count)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def _sources(name: str) -> list[Path]:
    csrc = KERNELS_DIR / name / "csrc"
    srcs = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    if not any(s.suffix == ".cu" for s in srcs):
        raise FileNotFoundError(f"no CUDA sources under {csrc}")
    return srcs


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch build only where the CUDA toolkit is installed"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cus = [str(s) for s in _sources(name) if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), *cus]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build_all(names: list[str]) -> dict[str, str]:
    """Build every named package at once; returns nvcc's output per package
    (empty for a cached library).  Raises if any build fails."""
    started = {n: _start_build(n) for n in names}
    logs: dict[str, str] = {}
    failed = []
    for n, job in started.items():
        if job is None:
            logs[n] = ""
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of one kernel package (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
