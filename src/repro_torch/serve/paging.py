"""Host-side KV block allocator for the paged serving engine (a copy of
`blocks_needed` and `BlockAllocator` from `repro/serve/paging.py`).

The paged engine keeps one shared pool of fixed-size KV blocks
(`models.transformer.init_pool`: per segment `{"k", "v": [layers,
num_blocks + 1, block_size, KV, hd]}`); this module owns the host half of it: a free
list of block ids and the accounting both admission policies rest on.
Block id 0 is the null block: unallocated table entries point at it,
masked writes land in it, and no live row ever attends to it, so the
allocator hands out ids 1..num_blocks.

  * "recompute" (default): optimistic admission against the blocks free
    right now (`can_allocate`, with a watermark); when a per-step alloc
    would fail, the engine preempts the newest request and frees its
    blocks (`free_partial`).
  * "reserve": admission needs `available >= worst case`; the rest of
    the worst case is `reserve()`d, and each later per-step alloc draws
    on that earmark (`alloc(1, reserved=True)`), so it cannot fail.
"""
from __future__ import annotations

from typing import List


def blocks_needed(num_tokens: int, block_size: int) -> int:
    """Blocks required to hold `num_tokens` cache entries."""
    return -(-max(int(num_tokens), 0) // int(block_size))


class BlockAllocator:
    """Free-list allocator over block ids 1..num_blocks (0 = null block).

    `available` subtracts outstanding reservations from the free count,
    so "reserve"-mode admission against it guarantees every later
    reserved alloc succeeds.  "recompute" mode never reserves and
    queries `can_allocate` / `free_count` directly.
    """

    def __init__(self, num_blocks: int):
        assert num_blocks >= 1, num_blocks
        self.num_blocks = int(num_blocks)
        # sorted free list: lowest ids first (maintained by release())
        # keeps tables reproducible across finish/preempt schedules; the
        # mirror set makes the double-free guard O(1) per block
        self._free: List[int] = list(range(1, self.num_blocks + 1))
        self._free_set = set(self._free)
        self._reserved = 0
        self._peak_in_use = 0

    @property
    def free_count(self) -> int:
        """Blocks on the free list (including reserved-but-unallocated)."""
        return len(self._free)

    @property
    def available(self) -> int:
        """Blocks admissible right now: free minus outstanding reserves."""
        return len(self._free) - self._reserved

    @property
    def in_use(self) -> int:
        """Blocks currently allocated to live requests."""
        return self.num_blocks - len(self._free)

    @property
    def peak_in_use(self) -> int:
        """High-water mark of `in_use` (pool-pressure observability:
        how close the workload actually came to exhausting the pool)."""
        return self._peak_in_use

    def can_allocate(self, n: int, *, watermark: int = 0) -> bool:
        """True when `n` blocks can be popped off the free list while
        leaving at least `watermark` blocks still free.  This is the
        optimistic-admission query: reservations are ignored (the
        "recompute" policy never takes any)."""
        return len(self._free) - int(watermark) >= n

    def reserve(self, n: int) -> None:
        """Earmark `n` free blocks for future reserved allocs."""
        assert n >= 0 and self._reserved + n <= len(self._free), (
            n, self._reserved, len(self._free))
        self._reserved += n

    def unreserve(self, n: int) -> None:
        """Drop `n` earmarks (request finished under its worst case)."""
        assert 0 <= n <= self._reserved, (n, self._reserved)
        self._reserved -= n

    def alloc(self, n: int, *, reserved: bool = False) -> List[int]:
        """Pop `n` block ids off the free list.

        reserved=True consumes an earlier `reserve()` earmark (the
        "reserve"-mode lazy decode-step path); reserved=False is the
        admission path — and every "recompute"-mode alloc — and must
        leave any earmarked blocks untouched."""
        if reserved:
            assert n <= self._reserved, (n, self._reserved)
            self._reserved -= n
        else:
            assert n <= self.available, (n, self.available, self._reserved)
        out = self._free[:n]
        del self._free[:n]
        self._free_set.difference_update(out)
        self._peak_in_use = max(self._peak_in_use, self.in_use)
        return out

    def release(self, blocks) -> None:
        """Return block ids to the free list (finish/preempt path).

        The free list is re-sorted so allocation order stays "lowest ids
        first" no matter what order requests finish or are preempted in
        — block tables are then a function of the admission schedule
        alone, not of which table row handed its blocks back first."""
        for b in blocks:
            b = int(b)
            assert 1 <= b <= self.num_blocks, b
            assert b not in self._free_set, f"double free of block {b}"
            self._free.append(b)
            self._free_set.add(b)
        self._free.sort()

    def free_partial(self, blocks) -> int:
        """Release the allocated (nonzero) ids out of a block-table row,
        skipping null-block entries; returns how many were freed.  The
        finish and preempt paths both hand the slot's whole table row
        here — trailing entries still point at block 0."""
        live = [int(b) for b in blocks if int(b) != 0]
        self.release(live)
        return len(live)
