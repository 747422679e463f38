"""Deterministic synthetic data pipeline, host-sharded, double-buffered.

A copy of the JAX package's ``data/pipeline.py`` (numpy only): the same
Philox streams, so the port's batches are bit-equal to the JAX package's.

Production shape: every host deterministically derives its shard of each
global batch from (step, host_id) with a counter-based RNG (Philox), so a
restarted or re-meshed job regenerates identical data without coordination —
the property the fault-tolerance layer relies on.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class SyntheticTokens:
    """Zipf-ish synthetic LM tokens + next-token labels (+ modality stubs)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    # modality stubs
    num_patches: int = 0
    vision_dim: int = 0
    frontend_dim: int = 0
    frames_len: int = 0

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        self.host_batch = self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[step, self.host_id, 0, 0])
        )
        b, s = self.host_batch, self.seq_len
        # zipf-like marginal over the vocab (clipped)
        raw = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        toks = (raw % (self.vocab_size - 2)) + 1
        out = {
            "tokens": toks[:, :s].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.num_patches:
            out["patches"] = rng.standard_normal(
                (b, self.num_patches, self.vision_dim), dtype=np.float32
            )
        if self.frontend_dim:
            out["frames"] = rng.standard_normal(
                (b, self.frames_len or s, self.frontend_dim), dtype=np.float32
            )
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except BaseException as e:  # surfaced on next()
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def make_train_iterator(cfg, shape, num_hosts: int = 1, host_id: int = 0,
                        seed: int = 0, start_step: int = 0, prefetch: int = 2):
    """cfg: ArchConfig; shape: ShapeConfig -> prefetching host iterator."""
    text_len = shape.seq_len - cfg.num_patches if cfg.num_patches else shape.seq_len
    src = SyntheticTokens(
        vocab_size=cfg.vocab_size,
        seq_len=text_len,
        global_batch=shape.global_batch,
        num_hosts=num_hosts,
        host_id=host_id,
        seed=seed,
        num_patches=cfg.num_patches,
        vision_dim=cfg.vision_dim,
        frontend_dim=cfg.frontend_dim if cfg.family == "audio" else 0,
        frames_len=shape.seq_len,
    )

    def from_step():
        step = start_step
        while True:
            yield src.batch_at(step)
            step += 1

    return Prefetcher(from_step(), depth=prefetch)
