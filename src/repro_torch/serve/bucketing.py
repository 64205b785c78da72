"""Power-of-two length bucketing for serving (a copy of `bucket_length`
and `num_buckets` from `repro/serve/bucketing.py`).

Rounding prompt lengths and cache capacities up to powers of two bounds
the number of distinct shapes at O(log max_len): the reference compiles
once per shape, and the port keeps the same buckets so both engines pad
the same prompts to the same lengths. Prompt padding is inert for pure
attention stacks with full-capacity rings (pads are causally invisible
and masked out of decode by the per-slot validity length).
"""
from __future__ import annotations


def bucket_length(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def num_buckets(max_len: int, floor: int = 1) -> int:
    """How many distinct buckets lengths in [1, max_len] can map to."""
    return len({bucket_length(n, floor) for n in range(1, max_len + 1)})
