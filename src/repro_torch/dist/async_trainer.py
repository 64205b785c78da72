"""True-async API-BCD: a multi-process asynchronous trainer (the port of
`repro/dist/async_trainer.py`, on an explicit device in float64).

`repro_torch.dist.trainer` runs the gAPI-BCD superstep as lockstep with
active-agent masking — it *simulates* asynchrony without exercising it,
as `repro_torch.core.simulator` does for the convex methods.  This
module is the real thing: each process owns a contiguous shard of
agents and advances its token walks at its *own* rate, with no global
barrier, exchanging token-block updates through a KV transport
(`repro_torch.dist.async_comm`) and applying `APIBCD.update` /
`update_fresh` against a possibly-stale replica of the shared token
estimate.

Execution model (per process):

  1. Run ``local_steps`` walk activations against the local token view
     (`MethodState.tokens` — the stale replica plus the process's own
     uncommunicated deltas).  Each activation is one Alg. 2 step
     (`repro_torch.core.methods`); a straggler-injection hook pads every
     update to ``min_update_s * speed``.  With ``mid_round=True``,
     *before each activation* the worker applies any peer deltas the
     deterministic schedule places earlier than that step
     (`SyncEvent.ingest_cursors`) — staleness shrinks between syncs
     without the digest moving, because every process ingests the same
     prefix at the same schedule-defined points.
  2. Publish the round's accumulated token delta (eq. 12b credits are
     additive, so lump deltas commute across processes) under
     ``delta/<proc>/<round>``.
  3. Apply every peer delta ordered before this sync in the
     deterministic global order (`repro_torch.dist.async_schedule`) to
     the local replica — **blocking until available**.  This realizes
     the bounded-staleness gate: the schedule places a process's round
     start no more than ``max_delay`` rounds ahead of the slowest peer,
     so a runner-ahead blocks here exactly when the gate requires.
     ``max_delay=0`` degenerates to the synchronous lockstep superstep
     — and, with ``mid_round=True``, to *textbook* BSP (every round
     computed against the complete previous round).
  4. Pull: reset the working view to the replica and continue.

The replica, the pulled view and the method state stay on the method's
device.  A fetched delta goes up with `torch.as_tensor`; the round's own
delta comes down once, to be published.  On the card an update returns
once its launches are queued, so the worker synchronises its own stream
after each update before it reads the clock: the straggler pad and the
measured-speed EMA time the update's work, not its dispatch.

**Measured-speed adaptation** (``measured_speeds=True``): the run is
split into epochs of ``rate_rounds`` rounds.  Each worker keeps an EMA
of its *observed* per-update wall time — measured over the update
segment only; mid-round KV waits are excluded via separate monotonic
segments, so transport latency can never poison the rate signal — and
at each epoch boundary publishes the `quantize_speed` bucket index of
that EMA.  Unlike the reference, an update padded to its straggler
floor counts as the floor, not as the floor plus the sleep's overshoot:
that is the host timer's, not this process's speed, and on a loaded
host it reaches milliseconds, enough to lift a 10 ms floor out of its
bucket on the default grid.  Every process blocks for the full
bucket vector, computes the same `bucket_speeds` multipliers, and
rebuilds the next epoch's schedule from them.  Raw wall times never
cross the determinism boundary — only agreed integer buckets do — so
cross-process digests stay bitwise equal and seeded repeats agree
whenever the (coarse, geometric) buckets reproduce.

Every process applies the same lump deltas in the same order, so the
shared-estimate replica — and therefore the run digest — is bitwise
identical across processes, and across repeats of a seeded run as far
as each update is bitwise reproducible on its device.
`repro_torch.launch.train_async` drives one worker per process.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import losses as L
from repro_torch.core.methods import IncrementalMethod
from repro_torch.dist.async_comm import decode as _dec_blob
from repro_torch.dist.async_comm import encode as _enc_blob
from repro_torch.dist.async_schedule import (
    WalkSequence, agent_shard, bucket_speeds, build_schedule, epoch_spans,
    quantize_speed)
from repro_torch.utils.hotpath import hot_loop


@dataclasses.dataclass(frozen=True)
class AsyncBCDConfig:
    """Run configuration — identical on every process (it seeds the
    deterministic schedule, so any divergence breaks the digest)."""

    num_procs: int
    num_agents: int
    num_walks: int
    rounds: int                      # sync rounds per process
    local_steps: int = 1             # walk updates per round (base)
    max_delay: Optional[int] = 0     # staleness bound; None = unbounded
    adaptive: bool = False           # speed-adapted per-round step counts
    speeds: Sequence[float] = ()     # per-process cost multipliers
    mid_round: bool = False          # apply peer deltas between local steps
    measured_speeds: bool = False    # schedule from measured buckets
    rate_rounds: int = 8             # rounds per measured-speed epoch
    speed_ema: float = 0.5           # EMA history weight for update times
    speed_quantum_s: float = 1e-3    # bucket grid unit (quantize_speed)
    speed_bucket_base: float = 2.0 ** 0.5   # bucket grid ratio
    rule: str = "walk"               # "walk" (Alg. 2) | "fresh" (Thm 2 view)
    walk_kind: str = "cyclic"        # "cyclic" | "random"
    min_update_s: float = 0.0        # per-update duration floor (nominal)
    seed: int = 0
    comm_timeout_s: float = 600.0

    def resolved_speeds(self) -> List[float]:
        s = list(self.speeds) or [1.0] * self.num_procs
        assert len(s) == self.num_procs, (s, self.num_procs)
        return [float(v) for v in s]

    def schedule_speeds(self) -> List[float]:
        """Speeds seeding the FIRST epoch's schedule.

        Measured mode starts blind (all 1.0 — real stragglers are
        discovered, not declared); declared mode uses ``speeds``."""
        if self.measured_speeds:
            return [1.0] * self.num_procs
        return self.resolved_speeds()


@dataclasses.dataclass
class AsyncResult:
    proc: int
    digest: str                  # shared-estimate digest (cross-process)
    trace: List[dict]            # per-sync telemetry + objective
    tokens: torch.Tensor         # final shared tokens [M, p] (all events)
    xs_local: torch.Tensor       # final local models [hi-lo, p]
    agent_range: tuple
    own_updates: int
    applied_updates: int
    comm_posts: int
    comm_fetches: int
    gate_wait_s: float
    wall_s: float
    max_staleness: int
    mid_round_ingested: int = 0  # peer events applied between local steps
    ingest_wait_s: float = 0.0   # KV wait inside mid-round ingestion
    max_view_lag: int = 0        # worst view age at any ingestion point
    update_ema_s: float = 0.0    # final per-update wall-time EMA
    speed_buckets: List[List[int]] = dataclasses.field(default_factory=list)
    rate_syncs: int = 0          # measured-speed agreement barriers hit
    num_epochs: int = 1


def consensus_estimate(tokens: torch.Tensor, rule: str) -> torch.Tensor:
    """Global model estimate from the shared tokens.

    Physical walk updates credit each delta to exactly one token, so
    ``sum_m z_m`` tracks ``mean_i x_i`` (eq. 12b invariant); the fresh
    logical view credits every token, so each token IS the estimate.
    """
    return tokens.sum(dim=0) if rule == "walk" else tokens.mean(dim=0)


class AsyncWorker:
    """One process's event loop.  ``kv`` is any `async_comm` transport."""

    def __init__(self, cfg: AsyncBCDConfig, method: IncrementalMethod,
                 proc: int, kv):
        assert method.num_walks == cfg.num_walks, (
            method.num_walks, cfg.num_walks)
        assert cfg.rule in ("walk", "fresh"), cfg.rule
        self.cfg = cfg
        self.method = method
        self.proc = proc
        self.kv = kv
        self.speeds = cfg.resolved_speeds()   # physical (pad injection)
        self.epochs = epoch_spans(
            cfg.rounds, cfg.rate_rounds if cfg.measured_speeds else None)
        # first epoch's schedule, exposed for introspection (callers read
        # my_events[0].num_updates for the starting local-step count)
        self.events = build_schedule(
            cfg.num_procs, self.epochs[0][1], cfg.local_steps,
            cfg.schedule_speeds(), cfg.max_delay, adaptive=cfg.adaptive)
        self.my_events = [e for e in self.events if e.proc == proc]

    # -- one local activation -------------------------------------------------

    def _apply_update(self, state, agent: int, walk: int):
        if self.cfg.rule == "walk":
            return self.method.update(state, agent, walk)
        return self.method.update_fresh(state, agent)

    def _delta_key(self, proc: int, rnd: int) -> str:
        return f"delta/{proc}/{rnd}"

    def _fetch(self, proc: int, rnd: int) -> torch.Tensor:
        """A peer's published delta, on this worker's device (blocking)."""
        blob = self.kv.get(self._delta_key(proc, rnd),
                           self.cfg.comm_timeout_s)
        return torch.as_tensor(_dec_blob(blob), device=self.method.device)

    # -- the event loop -------------------------------------------------------

    @hot_loop
    def run(self) -> AsyncResult:
        cfg = self.cfg
        speed = self.speeds[self.proc]
        floor_s = cfg.min_update_s * speed    # straggler-injection hook
        device = self.method.device
        # the stream this thread queues on (run_threaded gives each worker
        # its own): the update clock waits for it alone
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)

        state = self.method.init()
        # warm the solver before the start barrier so first-call costs
        # never pollute the wall-clock comparison (the result is
        # discarded; update() copies its input state)
        agent0, walk0 = WalkSequence(
            cfg.num_agents, cfg.num_procs, self.proc, cfg.num_walks,
            kind=cfg.walk_kind, seed=cfg.seed).take(1)[0]
        self._apply_update(state, agent0, walk0)

        z_rep = state.tokens.clone()      # applied global prefix (replica)
        pulled = state.tokens.clone()     # view at last pull
        sequence = WalkSequence(
            cfg.num_agents, cfg.num_procs, self.proc, cfg.num_walks,
            kind=cfg.walk_kind, seed=cfg.seed)
        sched_speeds = cfg.schedule_speeds()
        trace: List[dict] = []
        own_updates = applied_updates = 0
        comm_posts = comm_fetches = 0
        gate_wait_s = ingest_wait_s = 0.0
        max_staleness = max_view_lag = 0
        mid_round_ingested = 0
        update_ema_s = 0.0
        speed_buckets: List[List[int]] = []
        rate_syncs = 0

        if stream is not None:
            stream.synchronize()
        self.kv.barrier("async-bcd-start", cfg.num_procs, self.proc,
                        cfg.comm_timeout_s)
        t0 = time.monotonic()

        for ei, (r0, _) in enumerate(self.epochs):
            events = self.events if ei == 0 else build_schedule(
                cfg.num_procs, self.epochs[ei][1], cfg.local_steps,
                sched_speeds, cfg.max_delay, adaptive=cfg.adaptive)
            cursor = 0                    # next epoch event to apply

            for ev in events:
                if ev.proc != self.proc:
                    continue
                rnd_g = r0 + ev.round     # globally unique delta round
                steps = sequence.take(ev.num_updates)
                for j, (agent, walk) in enumerate(steps):
                    if cfg.mid_round:
                        # mid-round ingestion: apply the schedule's
                        # pre-step prefix.  The KV wait is its own
                        # monotonic segment — it must never count
                        # against update wall time (pad absorption) or
                        # leak into the measured-speed EMA.
                        t_ing = time.monotonic()
                        bound = ev.ingest_cursors[j]
                        while cursor < bound:
                            e = events[cursor]
                            assert e.proc != self.proc, (
                                "own events apply at own syncs")
                            d = self._fetch(e.proc, r0 + e.round)
                            comm_fetches += 1
                            z_rep = z_rep + d
                            pulled = pulled + d
                            state.tokens = state.tokens + d
                            applied_updates += e.num_updates
                            mid_round_ingested += 1
                            cursor += 1
                        ingest_wait_s += time.monotonic() - t_ing
                        max_view_lag = max(max_view_lag, ev.view_lags[j])
                    t_u = time.monotonic()
                    state = self._apply_update(state, agent, walk)
                    if stream is not None:
                        # the one deliberate wait of an update: the clock
                        # below must time the update's device work, not
                        # its dispatch (this worker's stream only)
                        stream.synchronize()
                    own_updates += 1
                    # the update's time is its own work or the injected
                    # floor, whichever is longer: the pad's oversleep is
                    # the host's timer, not this process's speed
                    dur = max(time.monotonic() - t_u, floor_s)
                    if floor_s > 0.0:
                        pad = floor_s - (time.monotonic() - t_u)
                        if pad > 0:
                            time.sleep(pad)
                    update_ema_s = dur if own_updates == 1 else (
                        cfg.speed_ema * update_ema_s
                        + (1.0 - cfg.speed_ema) * dur)

                # publish this round's block update (lump delta since pull)
                delta = state.tokens - pulled
                self.kv.set(self._delta_key(self.proc, rnd_g),
                            _enc(delta))
                comm_posts += 1

                # staleness gate: apply every update ordered before (and
                # including) this sync — blocking on stragglers as needed
                t_gate = time.monotonic()
                while cursor <= ev.index:
                    e = events[cursor]
                    if e.proc == self.proc:
                        d = delta if e.round == ev.round else None
                        assert d is not None, "own events apply in order"
                    else:
                        d = self._fetch(e.proc, r0 + e.round)
                        comm_fetches += 1
                    z_rep = z_rep + d
                    applied_updates += e.num_updates
                    cursor += 1
                gate_wait_s += time.monotonic() - t_gate
                max_staleness = max(max_staleness, ev.staleness)

                # pull: working view becomes the canonical replica
                state.tokens = z_rep.clone()
                pulled = z_rep.clone()

                trace.append({
                    "event": ev.index, "round": rnd_g, "epoch": ei,
                    "wall_s": time.monotonic() - t0,
                    "own_updates": own_updates,
                    "applied_updates": applied_updates,
                    "comm_events": comm_posts + comm_fetches,
                    "gate_wait_s": gate_wait_s,
                    "ingest_wait_s": ingest_wait_s,
                    "ingested": mid_round_ingested,
                    "staleness": ev.staleness,
                    "view_lag": max(ev.view_lags) if cfg.mid_round
                    else ev.staleness,
                    "gated": ev.gated,
                    "update_ema_s": update_ema_s,
                    "consensus": consensus_estimate(z_rep, cfg.rule),
                })

            # catch up on peers' trailing events so every process ends
            # the epoch with the identical full-prefix replica (the
            # digest bar; also the clean base the next epoch starts on)
            while cursor < len(events):
                e = events[cursor]
                d = self._fetch(e.proc, r0 + e.round)
                comm_fetches += 1
                z_rep = z_rep + d
                applied_updates += e.num_updates
                cursor += 1

            if ei + 1 < len(self.epochs):
                state.tokens = z_rep.clone()
                pulled = z_rep.clone()
                if cfg.measured_speeds:
                    # rate sync: publish the quantized bucket of the
                    # measured EMA, block for the full agreed vector,
                    # and rebuild the next epoch's schedule from it.
                    # Integers only — raw wall times stay process-local.
                    bucket = quantize_speed(
                        update_ema_s, cfg.speed_quantum_s,
                        cfg.speed_bucket_base)
                    self.kv.set(f"speed/{self.proc}/{ei}",
                                _enc_blob(int(bucket)))
                    comm_posts += 1
                    agreed = [int(_dec_blob(self.kv.get(
                        f"speed/{q}/{ei}", cfg.comm_timeout_s)))
                        for q in range(cfg.num_procs)]
                    comm_fetches += cfg.num_procs
                    sched_speeds = bucket_speeds(
                        agreed, cfg.speed_bucket_base)
                    speed_buckets.append(agreed)
                    rate_syncs += 1
        if stream is not None:
            stream.synchronize()
        wall_s = time.monotonic() - t0

        # objective evaluation is post-hoc, off the clock: consensus
        # snapshots were kept on the device per sync, evaluated here
        for rec in trace:
            # repro-lint: disable=host-sync-in-hot-loop -- post-hoc trace
            # evaluation after the timed loop ended (off the clock by design)
            rec["objective"] = float(L.global_objective(
                self.method.problem, rec.pop("consensus")))

        lo, hi = agent_shard(cfg.num_agents, cfg.num_procs, self.proc)
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(z_rep.cpu().numpy()).tobytes())
        h.update(f"{applied_updates}:{comm_posts}".encode())
        return AsyncResult(
            proc=self.proc, digest=h.hexdigest()[:16], trace=trace,
            tokens=z_rep, xs_local=state.xs[lo:hi].clone(),
            agent_range=(lo, hi), own_updates=own_updates,
            applied_updates=applied_updates, comm_posts=comm_posts,
            comm_fetches=comm_fetches, gate_wait_s=gate_wait_s,
            wall_s=wall_s, max_staleness=max_staleness,
            mid_round_ingested=mid_round_ingested,
            ingest_wait_s=ingest_wait_s, max_view_lag=max_view_lag,
            update_ema_s=update_ema_s, speed_buckets=speed_buckets,
            rate_syncs=rate_syncs, num_epochs=len(self.epochs))


def _enc(delta: torch.Tensor) -> bytes:
    """The wire bytes of a delta: its host copy, pickled as numpy."""
    return _enc_blob(np.ascontiguousarray(delta.cpu().numpy()))


def run_threaded(cfg: AsyncBCDConfig, methods: Sequence[IncrementalMethod],
                 kv=None) -> List[AsyncResult]:
    """Run all of a config's workers as threads in one process.

    Test/laptop harness: real multi-process runs go through
    `repro_torch.launch.train_async`; this drives the same event loops
    over a `DictKV`, preserving every ordering/digest property (the
    numerics never depend on which transport carries the deltas).  On
    the card each worker queues on a stream of its own, so the wait
    after each of its updates waits for its work alone.
    """
    import threading

    from repro_torch.dist.async_comm import DictKV

    kv = kv or DictKV()
    workers = [AsyncWorker(cfg, methods[p], p, kv)
               for p in range(cfg.num_procs)]
    streams = []
    for m in methods[:cfg.num_procs]:
        s = None
        if m.device.type == "cuda":
            # the worker's stream starts after the work queued so far
            # (the method's factors) on the caller's
            s = torch.cuda.Stream(m.device)
            s.wait_stream(torch.cuda.current_stream(m.device))
        streams.append(s)
    results: List[Optional[AsyncResult]] = [None] * cfg.num_procs
    errors: List[BaseException] = []

    def drive(p):
        try:
            with torch.cuda.stream(streams[p]):
                results[p] = workers[p].run()
        except BaseException as e:      # surface worker failures in the test
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(p,), daemon=True)
               for p in range(cfg.num_procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=cfg.comm_timeout_s + 60)
    if errors:
        raise errors[0]
    assert all(r is not None for r in results), "worker thread hung"
    return results
