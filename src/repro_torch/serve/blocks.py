"""Paged-KV block accounting: fixed-size block pool + per-request tables.

The serving engine stores every request's KV cache as a list of fixed-size
*blocks* drawn from one shared pool, so mixed-length requests pack densely
instead of each padding to the engine-wide ``max_len`` (the vLLM paged-KV
idea, host-side half).  This module is pure Python bookkeeping — the device
arrays live in ``repro_torch.serve.paged`` — and is shared verbatim by the real
engine and the DES twin (``repro_torch.serve.sim``), which is what makes their
admission decisions bit-identical (the house parity convention).

Invariants (property-tested in tests/test_serve_blocks.py):

* a block is owned by at most one live request at any time;
* every block allocated to a request is returned when it is freed;
* allocation fails if and only if the pool has too few free blocks.
"""
from __future__ import annotations

from typing import Hashable


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Number of blocks covering ``n_tokens`` cache positions."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // block_size)


class OutOfBlocksError(RuntimeError):
    """Allocation request exceeds the free pool."""


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size KV blocks.

    Blocks are handed out lowest-id-first (deterministic: the engine and
    the sim twin must assign the *same* block ids for the same request
    sequence) and tagged with an owner so double-free and cross-request
    sharing are structurally impossible.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks} x {block_size}"
            )
        self.num_blocks = num_blocks
        self.block_size = block_size
        # sorted free list: deterministic lowest-first allocation order
        self._free: list[int] = list(range(num_blocks))
        self._owner: dict[int, Hashable] = {}

    # -- queries --------------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def owner_of(self, block: int) -> Hashable | None:
        return self._owner.get(block)

    def blocks_of(self, owner: Hashable) -> list[int]:
        return sorted(b for b, o in self._owner.items() if o == owner)

    # -- mutation -------------------------------------------------------------

    def alloc(self, n: int, owner: Hashable) -> list[int]:
        """Allocate ``n`` blocks for ``owner`` (lowest ids first)."""
        if n < 0:
            raise ValueError(f"request {owner!r}: cannot allocate {n} blocks")
        if n > len(self._free):
            raise OutOfBlocksError(
                f"request {owner!r}: requested {n} blocks, "
                f"{len(self._free)} free (pool {self.num_blocks}) — "
                f"statically detectable as R003"
            )
        got, self._free = self._free[:n], self._free[n:]
        for b in got:
            self._owner[b] = owner
        return got

    def free(self, blocks: list[int], owner: Hashable | None = None) -> None:
        """Return blocks to the pool; freeing an unowned block raises.

        ``owner`` (when given) names the request in the error — the dynamic
        counterpart of the static double-free check (R002).
        """
        who = "" if owner is None else f"request {owner!r}: "
        for b in blocks:
            if b not in self._owner:
                raise ValueError(
                    f"{who}block {b} is not allocated — double-free or "
                    f"free of a never-owned block (statically detectable "
                    f"as R002)"
                )
        for b in blocks:
            del self._owner[b]
        self._free = sorted(self._free + list(blocks))

    def free_owner(self, owner: Hashable) -> list[int]:
        """Free every block of ``owner``; returns the freed ids."""
        blocks = self.blocks_of(owner)
        self.free(blocks, owner=owner)
        return blocks


class BlockTable:
    """One request's logical-position -> (block, offset) mapping."""

    def __init__(self, blocks: list[int], block_size: int):
        self.blocks = list(blocks)
        self.block_size = block_size

    @property
    def capacity(self) -> int:
        return len(self.blocks) * self.block_size

    def locate(self, position: int) -> tuple[int, int]:
        """(block id, in-block offset) of cache position ``position``."""
        if not 0 <= position < self.capacity:
            raise IndexError(
                f"position {position} outside table capacity {self.capacity}"
            )
        return self.blocks[position // self.block_size], (
            position % self.block_size
        )
