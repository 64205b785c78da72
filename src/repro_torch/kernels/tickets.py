"""Ticket counters shared by the kernels that finish a split in the last
block to arrive (the decode, paged and ring kernels, and the chunked WKV
body): one zeroed int32 counter per unit of work, per device. Each kernel
leaves its counters 0, so one pool serves them all; two launches on
different streams at once would share it."""
from __future__ import annotations

import torch

TICKETS = {}                # device -> int32 ticket counters, all 0


def ticket_counters(device, n):
    """At least n zeroed int32 counters on `device`, allocated once and
    grown (zeroed anew) when a launch needs more."""
    t = TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        TICKETS[device] = t
    return t
