"""Power-of-two length bucketing for serving (a copy of `bucket_length`,
`num_buckets`, `chunks_needed` and `table_width` from
`repro/serve/bucketing.py`).

Rounding prompt lengths and cache capacities up to powers of two bounds
the number of distinct shapes at O(log max_len): the reference compiles
once per shape, and the port keeps the same buckets so both engines pad
the same prompts to the same lengths. Prompt padding is inert for pure
attention stacks with full-capacity rings (pads are causally invisible
and masked out of decode by the per-slot validity length).
"""
from __future__ import annotations

from repro_torch.serve.paging import blocks_needed


def bucket_length(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def num_buckets(max_len: int, floor: int = 1) -> int:
    """How many distinct buckets lengths in [1, max_len] can map to."""
    return len({bucket_length(n, floor) for n in range(1, max_len + 1)})


def chunks_needed(n: int, chunk: int) -> int:
    """Fixed-size prefill chunks covering `n` tokens (the paged engine's
    prefill launches per admission, recompute re-prefills included)."""
    return blocks_needed(n, chunk)


def table_width(num_tokens: int, block_size: int, num_blocks: int,
                window: int = 0) -> int:
    """Pow2-bucketed block-table width covering `num_tokens` positions,
    at most `num_blocks`.

    The decode step sees the tables sliced to this width, so its work
    tracks the live maximum rather than the pool. window > 0 (ring-paged
    sliding window): a slot never holds more than ceil(window /
    block_size) blocks, so the width saturates there whatever
    num_tokens is; the pow2 bucket may round above the ring, and the
    extra entries stay on the null block, masked.
    """
    if window:
        num_tokens = min(int(num_tokens), int(window))
    return min(bucket_length(blocks_needed(num_tokens, block_size)),
               num_blocks)
