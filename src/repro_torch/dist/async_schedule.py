"""Deterministic schedules for the true-async API-BCD runtime (a copy of
`repro/dist/async_schedule.py`: pure Python and numpy, so every event,
cursor and walk equals the reference's exactly).

The async trainer (`repro_torch.dist.async_trainer`) lets every process
advance its token walks at its own rate — no global barrier — yet a
seeded run must be digest-reproducible and cross-process-verifiable
(the reference's `launch/serve_mesh.py` discipline).  The trick is the
same one that mesh serving driver uses, lifted from lockstep to
*bounded asynchrony*:
every process deterministically computes the SAME global order of sync
events, and block updates are applied to the shared-estimate replica in
that order, so nondeterministic wall-clock timing can never change the
numerics — only how long things take.

Two deterministic artifacts are built identically on every process from
the run config alone:

  * the **virtual-time event schedule** — a discrete-event simulation
    of the run: process p's round r costs `local_steps_p * speed_p`
    virtual units plus a communication charge, and the
    **bounded-staleness gate** (`max_delay`) is folded into the virtual
    start times (a process may not begin a round that would put it more
    than `max_delay` rounds ahead of the slowest peer).  Sorting the
    sync events by virtual completion time yields the global
    application order, and per-event staleness/gating telemetry.
    `max_delay=0` degenerates to the synchronous lockstep superstep
    (BSP); `max_delay=None` removes the gate entirely.

  * the per-process **walk sequence** — which (agent, walk) pair each
    local update activates.  With one process this reproduces
    `repro_torch.core.driver.run_serial`'s round-robin exactly; with P
    processes, each process runs the same pattern over its contiguous
    agent shard.

**Adaptive update rates** (straggler-resilient asynchrony, arXiv
2306.06559 / 2307.07652): per-round local-walk counts scale with
declared process speed so every process syncs at a common cadence —
between two global syncs a fast process takes proportionally more
local walks, and a straggler syncs after proportionally fewer instead
of stalling the fleet; the staleness gate then stays open and each
process contributes updates at its native rate.

**Mid-round ingestion points** (DIGEST-style early application of
stale information, arXiv 2307.07652 / 2305.xxxx): each event carries
``ingest_cursors`` — for every local step j, the global-order prefix
bound a worker may apply *before* executing step j.  The bound is pure
virtual time: events completed by the step's virtual start, capped at
the first event of the worker's *current* round (a round-r worker may
see everything through round r-1, never same-round peers — which is
what makes ``max_delay=0`` + mid-round exactly textbook BSP, every
round computed against the complete previous round).  Because bounds
are computed from the schedule alone, every process ingests the same
prefix at the same points: staleness shrinks, digests don't move.

**Measured-speed buckets**: `quantize_speed` / `bucket_speeds` turn an
EMA of *observed* per-update wall time into a small integer bucket on
a geometric grid.  Raw timings never cross the determinism boundary —
each process publishes only its bucket index, every process reads the
same agreed bucket vector at a rate-sync barrier, and the next epoch's
schedule is rebuilt identically everywhere from those integers.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SyncEvent:
    """One process finishing one round and exchanging block updates."""

    index: int          # position in the global application order
    proc: int           # process that produced the update
    round: int          # 1-indexed round on that process
    num_updates: int    # local walk updates folded into this delta
    t_virtual: float    # virtual completion time (determines the order)
    staleness: int      # rounds ahead of the slowest peer at round start
    gated: bool         # True if the staleness gate delayed the start
    # per-local-step mid-round ingestion: before executing step j the
    # worker may apply global events [0, ingest_cursors[j]); view_lags[j]
    # is the view's age in rounds at that point (<= max_delay, proven by
    # the gate — see build_schedule)
    ingest_cursors: Tuple[int, ...] = ()
    view_lags: Tuple[int, ...] = ()


def agent_shard(num_agents: int, num_procs: int, proc: int) -> Tuple[int, int]:
    """Contiguous [lo, hi) agent range owned by ``proc``.

    Mirrors `np.array_split`: the first `num_agents % num_procs` shards
    get one extra agent.
    """
    base, extra = divmod(num_agents, num_procs)
    lo = proc * base + min(proc, extra)
    return lo, lo + base + (1 if proc < extra else 0)


def local_steps(base: int, speed: float, adaptive: bool) -> int:
    """Walk updates per round for a process with cost multiplier ``speed``.

    ``speed`` is the declared per-update cost multiplier (1.0 = nominal,
    3.0 = a 3x straggler).  Adaptive mode equalizes sync cadence:
    rounds take ~`base` nominal-units of work everywhere, so a straggler
    batches fewer updates per sync and a fast process more.
    """
    if not adaptive:
        return max(1, int(base))
    return max(1, int(round(base / max(speed, 1e-9))))


def build_schedule(
    num_procs: int,
    rounds: int,
    base_local_steps: int,
    speeds: Sequence[float],
    max_delay: Optional[int],
    adaptive: bool = False,
    comm_cost: float = 1.0,
) -> List[SyncEvent]:
    """Discrete-event simulation of the gated async run.

    Returns every process's sync events sorted by
    ``(t_virtual, proc)`` — the global order in which block updates are
    applied to the shared-estimate replica.  The bounded-staleness gate
    is enforced *in virtual time*: process p may start round r only
    once every peer has completed round ``r - 1 - max_delay`` (so no
    process runs more than ``max_delay`` rounds ahead of the slowest);
    the real runtime then realizes exactly this dependency structure by
    blocking on earlier-ordered updates.
    """
    assert len(speeds) == num_procs, (len(speeds), num_procs)
    assert rounds >= 1 and base_local_steps >= 1
    if max_delay is not None:
        assert max_delay >= 0, max_delay
    steps = [local_steps(base_local_steps, s, adaptive) for s in speeds]

    # t_end[p][r] = virtual completion time of process p's round r
    # (1-indexed; round 0 is the common start at t=0).
    t_end = [[0.0] * (rounds + 1) for _ in range(num_procs)]
    t_begin = [[0.0] * (rounds + 1) for _ in range(num_procs)]
    gated = [[False] * (rounds + 1) for _ in range(num_procs)]
    for r in range(1, rounds + 1):
        for p in range(num_procs):
            t_start = t_end[p][r - 1]
            if max_delay is not None:
                need = r - 1 - max_delay   # peers must have completed this
                if need >= 1 and num_procs > 1:
                    gate = max(t_end[q][need]
                               for q in range(num_procs) if q != p)
                    if gate > t_start:
                        t_start, gated[p][r] = gate, True
            t_begin[p][r] = t_start
            t_end[p][r] = t_start + steps[p] * speeds[p] + comm_cost

    # Per-event staleness: rounds completed by p minus rounds completed
    # by the slowest peer at p's (post-gate) round start.
    def clock(q: int, t: float) -> int:
        ends = t_end[q]
        k = 0
        while k + 1 <= rounds and ends[k + 1] <= t:
            k += 1
        return k

    events = []
    for p in range(num_procs):
        for r in range(1, rounds + 1):
            start = t_begin[p][r]
            slowest = min(clock(q, start)
                          for q in range(num_procs) if q != p) \
                if num_procs > 1 else r - 1
            events.append((t_end[p][r], p, r, steps[p],
                           max(0, (r - 1) - slowest), gated[p][r]))
    events.sort(key=lambda e: (e[0], e[1]))

    # ---- mid-round ingestion points -------------------------------------
    # Before step j of (p, r) the worker may apply the global prefix
    # [0, bound_j): every event completed by the step's virtual start,
    # capped at the first event of round >= r.  The cap is what keeps
    # max_delay=0 exactly BSP (a round-r worker never sees same-round
    # peers mid-round); the SSP gate guarantees every peer's rounds
    # <= r-1-max_delay sort before any round-r event, so the capped
    # prefix still contains them and the view lag stays <= max_delay.
    ts = [e[0] for e in events]
    # first_ge[r]: first global index whose event is of round >= r
    first_ge = [len(events)] * (rounds + 2)
    for i, (_, _, r, _, _, _) in enumerate(events):
        first_ge[r] = min(first_ge[r], i)
    for r in range(rounds, 0, -1):
        first_ge[r] = min(first_ge[r], first_ge[r + 1])
    # cum[q][i]: how many of q's events sit in the global prefix [0, i)
    cum = [[0] * (len(events) + 1) for _ in range(num_procs)]
    for i, (_, p, _, _, _, _) in enumerate(events):
        for q in range(num_procs):
            cum[q][i + 1] = cum[q][i] + (1 if q == p else 0)
    index_of = {(p, r): i for i, (_, p, r, _, _, _) in enumerate(events)}

    out = []
    for i, (t, p, r, n, st, g) in enumerate(events):
        cursors, lags = [], []
        sync_cursor = index_of[(p, r - 1)] + 1 if r >= 2 else 0
        for j in range(n):
            t_j = t_begin[p][r] + j * speeds[p]
            bound = min(bisect.bisect_right(ts, t_j), first_ge[r])
            cursors.append(bound)
            prefix = max(bound, sync_cursor)
            if num_procs > 1:
                behind = min(cum[q][prefix]
                             for q in range(num_procs) if q != p)
                lags.append(max(0, (r - 1) - behind))
            else:
                lags.append(0)
        out.append(SyncEvent(
            index=i, proc=p, round=r, num_updates=n, t_virtual=t,
            staleness=st, gated=g, ingest_cursors=tuple(cursors),
            view_lags=tuple(lags)))
    return out


class WalkSequence:
    """Stateful (agent, walk) activation stream for one process.

    Walks round-robin (update j drives walk ``j % num_walks``), and each
    walk visits the process's agent shard in ring order from evenly
    spread start offsets — for ``num_procs == 1`` this is bit-for-bit
    the interleaving of `repro_torch.core.driver.run_serial` with
    `CyclicWalk`s.  ``kind="random"`` draws the next agent uniformly
    from the shard instead (seeded per (seed, proc): deterministic, but
    exercising irregular visit patterns).

    Statefulness matters for measured-speed runs: per-epoch step counts
    are only known once the fleet agrees on speed buckets, so the
    worker pulls activations incrementally with `take` — the stream is
    a pure function of (config, how many steps were taken), never of
    when they were taken.
    """

    def __init__(self, num_agents: int, num_procs: int, proc: int,
                 num_walks: int, kind: str = "cyclic", seed: int = 0):
        import numpy as np

        lo, hi = agent_shard(num_agents, num_procs, proc)
        self._lo, self._width = lo, hi - lo
        assert self._width >= 1, (
            f"process {proc} owns no agents "
            f"({num_agents} agents, {num_procs} procs)")
        assert kind in ("cyclic", "random"), kind
        self._kind = kind
        self._num_walks = num_walks
        self._rng = np.random.default_rng((seed, proc))
        self._pos = [lo + (w * self._width) // num_walks
                     for w in range(num_walks)]
        self._step = 0

    def take(self, n: int) -> List[Tuple[int, int]]:
        out = []
        for _ in range(n):
            w = self._step % self._num_walks
            agent = self._pos[w]
            if self._kind == "cyclic":
                self._pos[w] = self._lo + (
                    (self._pos[w] - self._lo + 1) % self._width)
            else:
                self._pos[w] = self._lo + int(
                    self._rng.integers(0, self._width))
            out.append((agent, w))
            self._step += 1
        return out


def walk_sequence(
    num_agents: int,
    num_procs: int,
    proc: int,
    num_walks: int,
    num_steps: int,
    kind: str = "cyclic",
    seed: int = 0,
) -> List[Tuple[int, int]]:
    """Fixed-length wrapper over `WalkSequence` (see its docstring)."""
    return WalkSequence(num_agents, num_procs, proc, num_walks,
                        kind=kind, seed=seed).take(num_steps)


# ---------------------------------------------------------------------------
# measured-speed buckets (the determinism boundary for wall-clock input)
# ---------------------------------------------------------------------------

def quantize_speed(ema_s: float, quantum_s: float = 1e-3,
                   base: float = 2.0 ** 0.5) -> int:
    """Quantize a measured per-update wall time onto a geometric grid.

    Returns the integer bucket index ``round(log_base(ema / quantum))``
    (floored at 0).  This is the ONLY thing a process may publish about
    its measured speed: raw wall times are noisy per repeat and
    per process, but a 3x straggler lands buckets apart from its peers
    on any run, so the agreed bucket vector — and therefore the rebuilt
    schedule and the digest — is stable across seeded repeats.
    """
    assert quantum_s > 0 and base > 1.0
    if ema_s <= quantum_s:
        return 0
    return max(0, int(round(math.log(ema_s / quantum_s) / math.log(base))))


def bucket_speeds(buckets: Sequence[int],
                  base: float = 2.0 ** 0.5) -> List[float]:
    """Fleet-relative speed multipliers from an agreed bucket vector.

    The slowest bucket maps to the largest multiplier and the fastest
    to 1.0: ``speed_p = base ** (bucket_p - min_q bucket_q)``.  Pure
    function of the integer vector — every process computes the same
    floats, so the per-epoch `build_schedule` inputs agree bitwise.
    """
    lo = min(buckets)
    return [float(base ** (b - lo)) for b in buckets]


def epoch_spans(rounds: int, rate_rounds: Optional[int]) -> List[Tuple[int, int]]:
    """Split ``rounds`` into rate-sync epochs of ``rate_rounds`` each.

    Returns ``(first_global_round - 1, num_rounds)`` offsets; a
    ``None``/0 ``rate_rounds`` (declared-speed mode) is one epoch.
    """
    if not rate_rounds or rate_rounds >= rounds:
        return [(0, rounds)]
    return [(r0, min(rate_rounds, rounds - r0))
            for r0 in range(0, rounds, rate_rounds)]
