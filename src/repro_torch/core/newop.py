"""New-op profiler (paper §2): online fallback for ops missing from the DB.

"In case the graph has new ops not in the profiling database, we fall back to
online profiling with the new op profiler and add the result to the
database."

The torch counterpart of the JAX package's ``core/newop.py``.  Given a graph
node whose signature has no profile, it times a callable on the profiler's
device and inserts the measurement, so the *next* simulation is a pure DB
hit: the node's real contraction when ``meta["dot"]`` gives it (in the
node's dtype), the real kernel op when ``meta["call"]`` gives it (a
``custom-call`` node of ``core/fx_graph.py``, on zero inputs of the recorded
shapes, strides and dtypes), else a surrogate of matching volume.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.database import ProfileDB, ProfileEntry
from repro_torch.core.graph import OpNode
from repro_torch.core.profiler import time_callable
from repro_torch.device import resolve_device


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class NewOpProfiler:
    def __init__(self, db: ProfileDB, platform: str, repeats: int = 5,
                 device="cuda"):
        self.db = db
        self.platform = platform
        self.repeats = repeats
        self.device = resolve_device(device)
        self.profiled: list[str] = []

    def _zeros(self, shape, dtype=torch.float32, stride=None):
        if stride is None:
            return torch.zeros(tuple(shape), dtype=dtype, device=self.device)
        return torch.empty_strided(tuple(shape), tuple(stride), dtype=dtype,
                                   device=self.device).zero_()

    def _kernel_call(self, call: dict):
        """The recorded kernel op on zero inputs (every decay exp(0) = 1,
        nothing overflows; the kernels' work does not depend on values)."""
        args = []
        for a in call["args"]:
            if isinstance(a, dict) and "shape" in a:
                args.append(self._zeros(a["shape"], _dtype(a["dtype"]),
                                        a["stride"]))
            elif isinstance(a, dict) and "torch_dtype" in a:
                args.append(_dtype(a["torch_dtype"]))
            else:
                args.append(a)
        ns, name = call["op"].split("::")
        op = getattr(getattr(torch.ops, ns), name)
        return lambda: op(*args)

    def _synthesize(self, node: OpNode):
        """Build a callable with ~node.flops flops and ~node.bytes traffic.

        The surrogate is chosen by arithmetic intensity so the measurement
        lands in the same hardware regime: matmul for compute-bound nodes,
        an exp-chain for transcendental-heavy nodes, a streaming multiply-add
        for bandwidth-bound nodes.
        """
        dot = node.meta.get("dot")
        if dot:
            # the paper's online profiling proper: run the actual contraction
            dt = _dtype(dot.get("dtype", "float32"))
            lhs = self._zeros(dot["lhs"], dt)
            rhs = self._zeros(dot["rhs"], dt)
            dims = ((tuple(dot["lc"]), tuple(dot["rc"])),
                    (tuple(dot["lb"]), tuple(dot["rb"])))
            return lambda: _dot_general(lhs, rhs, dims)
        call = node.meta.get("call")
        if call:
            return self._kernel_call(call)
        nbytes = max(int(node.bytes_accessed), 64)
        intensity = node.flops / nbytes if nbytes else 0.0
        if node.kind in ("dot", "convolution") or intensity > 8.0:
            n = max(int(round((node.flops / 2.0) ** (1.0 / 3.0))), 8)
            a = self._zeros((n, n))
            return lambda: a @ a
        if intensity > 1.5 and node.flops > 0:
            # transcendental-weighted node: exp chain of matching flops
            s = max(int(node.flops // 14), 16)  # 2 exps ~= 14 "flops"
            x = self._zeros((s,)) + 0.5
            return lambda: torch.exp(-torch.exp(-x))
        s = max(nbytes // 8, 16)  # two f32 streams
        x = self._zeros((s,))
        return lambda: x * 1.0009 + 1.0

    def try_profile(self, node: OpNode) -> Optional[float]:
        key = {"flops": int(node.flops), "bytes": int(node.bytes_accessed)}
        hit = self.db.lookup(self.platform, node.kind, key)
        if hit is not None:
            return hit.mean_s
        try:
            fn = self._synthesize(node)
            sync = self.device if self.device.type == "cuda" else None
            mean, std = time_callable(fn, repeats=self.repeats, warmup=2,
                                      device=sync)
        except Exception:
            return None
        self.db.add(
            self.platform,
            node.kind,
            ProfileEntry(
                args=key, mean_s=mean, std_s=std, n=self.repeats,
                flops=node.flops, bytes=node.bytes_accessed,
            ),
        )
        self.profiled.append(node.kind)
        return mean


def _dot_general(lhs, rhs, dims):
    """``lax.dot_general`` for the contractions a traced graph holds: batch
    dims first, then lhs free, then rhs free (XLA's output order)."""
    (lc, rc), (lb, rb) = dims
    lf = [d for d in range(lhs.ndim) if d not in lc and d not in lb]
    rf = [d for d in range(rhs.ndim) if d not in rc and d not in rb]
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    ls = [""] * lhs.ndim
    rs = [""] * rhs.ndim
    for l_, r_ in zip(lb, rb):
        ls[l_] = rs[r_] = next(letters)
    for l_, r_ in zip(lc, rc):
        ls[l_] = rs[r_] = next(letters)
    for d in lf:
        ls[d] = next(letters)
    for d in rf:
        rs[d] = next(letters)
    out = ([ls[d] for d in lb] + [ls[d] for d in lf] + [rs[d] for d in rf])
    return torch.einsum(f"{''.join(ls)},{''.join(rs)}->{''.join(out)}",
                        lhs, rhs)
