"""The SSD scan's least work and its kernels' names, frozen from
``src/repro_torch/kernels/ssd_scan/ops.py`` (``cost``, ``KERNELS``; commit
35298300dbbf), so a later change to the program does not move the
yardstick.

``cost`` takes the call's shapes as numbers: x (b, s, h, p) in
``in_bytes``, B and C (b, s, g, n) broadcast over the heads (read once), dt
(b, s, h) and A (h,) in float32, y written in ``out_bytes`` and the final
state (b, h, n, p) in float32.  Per chunk of Q tokens and head: the lower
triangle of C B^T and its product with x dt (Q(Q+1)/2 pairs, n and p
long), C times the entering state and the chunk's state input (Q n p each),
two operations per multiply-add.
"""
from __future__ import annotations

# the bf16 call's three kernels and the fp32 body
KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
           "ssd_chunk_out_kernel", "ssd_scan_f32_kernel")
# the kernel each call launches first (one a call in bf16 and in fp32)
FIRST = ("ssd_chunk_state_kernel", "ssd_scan_f32_kernel")


def cost(b: int, s: int, h: int, p: int, n: int, g: int, chunk: int,
         in_bytes: int = 2, out_bytes: int = 4) -> tuple[float, float]:
    """(operations, bytes) of one call."""
    q = chunk
    pairs = q * (q + 1) // 2
    ops = b * h * (s // q) * (2 * pairs * (n + p) + 4 * q * n * p)
    nbytes = (b * s * h * p * in_bytes + 2 * b * s * g * n * in_bytes
              + b * s * h * 4 + h * 4
              + b * s * h * p * out_bytes + b * h * n * p * 4)
    return float(ops), float(nbytes)


def padded_len(width: int, serve_chunk: int, chunk: int) -> int:
    """The sequence a prefill chunk of ``width`` real tokens hands the
    scan: its power-of-two bucket (at most ``serve_chunk``) padded up to a
    multiple of the scan's ``chunk``."""
    bucket = min(1 << max(0, width - 1).bit_length(), serve_chunk)
    return -(-bucket // chunk) * chunk
