"""Hot-path marker (a copy of `repro/utils/hotpath.py`).

`hot_loop` is a zero-cost identity decorator that marks a function as a
latency-critical host loop: the serving engine's per-step path. It
changes nothing at runtime; the repo's `host-sync-in-hot-loop` lint rule
matches the decorator by its last name, so device->host syncs inside a
marked function (`np.asarray`, `.item()`, `float()`) are flagged unless a
`# repro-lint: disable=host-sync-in-hot-loop -- <reason>` pragma accounts
for them.
"""
from __future__ import annotations


def hot_loop(fn):
    """Mark `fn` as a hot host loop (lint marker; identity at runtime)."""
    fn.__hot_loop__ = True
    return fn
