"""The port's true-async API-BCD runtime (`repro_torch.dist.async_*`)
against the JAX package's (`repro.dist.async_*`), and the reference's
claims about that runtime held on the port alone, on the CPU.

Schedules, walk sequences, the speed-bucket helpers and the wire bytes
are copies and must equal the reference's exactly. A threaded run goes
through the solvers, so it matches the reference's integer trace columns
exactly and its tokens, local models and objectives within 1e-12 of the
largest |value| (measured: <= 1e-15). Digests hash the replica's bytes,
and the port's CPU updates are within 2.5e-15 of the reference's, not
bitwise (`tests/test_torch_core.py`), so digests are compared within the
port only: across workers, repeats and all four transports.
"""
import dataclasses
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors gain nothing from threads; one thread keeps the parallel
# test workers (and the runtime's worker threads) from oversubscribing
torch.set_num_threads(1)

from proptest import property_sweep  # noqa: E402
from repro.core import methods as RM  # noqa: E402
from repro.data import make_problem as ref_make_problem  # noqa: E402
from repro.dist import async_comm as RC  # noqa: E402
from repro.dist import async_schedule as RS  # noqa: E402
from repro.dist import async_trainer as RT  # noqa: E402
from repro_torch.core import APIBCD, GAPIBCD, ring_graph, run_serial  # noqa: E402
from repro_torch.data import make_problem  # noqa: E402
from repro_torch.dist import async_comm as PC  # noqa: E402
from repro_torch.dist import async_schedule as PS  # noqa: E402
from repro_torch.dist import async_trainer as PT  # noqa: E402

CPU = "cpu"
TOL = 1e-12           # threaded runs against the reference, of max |.|
INT_COLUMNS = ("event", "round", "epoch", "own_updates", "applied_updates",
               "comm_events", "ingested", "staleness", "view_lag", "gated")


def _apibcd(problem, m=2):
    return APIBCD(problem, tau=1.0, num_walks=m, device=CPU)


# ---------------------------------------------------------------------------
# schedules, walks, buckets, bytes: equal to the reference's
# ---------------------------------------------------------------------------


@property_sweep(num_cases=8)
def test_build_schedule_equals_reference(rng):
    """Every event of every fleet size, field for field (t_virtual,
    ingest_cursors and view_lags included), and the schedule's own
    bounds: staleness and every ingestion point's view lag within
    max_delay, prefixes monotone and never into the event's round."""
    rounds = int(rng.integers(1, 10))
    base = int(rng.integers(1, 6))
    delay = (0, 2, None)[int(rng.integers(0, 3))]
    adaptive = bool(rng.integers(0, 2))
    comm = float(rng.choice([0.0, 0.5, 1.0, 2.5]))
    for procs in range(1, 5):
        speeds = rng.uniform(0.5, 4.0, procs).tolist()
        args = (procs, rounds, base, speeds, delay)
        want = RS.build_schedule(*args, adaptive=adaptive, comm_cost=comm)
        got = PS.build_schedule(*args, adaptive=adaptive, comm_cost=comm)
        assert [dataclasses.astuple(e) for e in got] == [
            dataclasses.astuple(e) for e in want], args
        assert sorted((e.proc, e.round) for e in got) == sorted(
            (p, r) for p in range(procs) for r in range(1, rounds + 1))
        bound = rounds if delay is None else delay
        for e in got:
            assert e.staleness <= bound
            assert len(e.ingest_cursors) == e.num_updates == len(
                e.view_lags)
            assert list(e.ingest_cursors) == sorted(e.ingest_cursors)
            assert all(c <= e.index for c in e.ingest_cursors)
            assert all(got[i].round < e.round
                       for i in range(max(e.ingest_cursors)))
            assert all(lag <= bound for lag in e.view_lags)


@pytest.mark.parametrize("claim", ["zero_delay_lockstep", "unbounded",
                                   "adaptive_cadence",
                                   "zero_delay_ingestion"])
def test_schedule_claims(claim):
    """The reference's named schedule claims, on the port's copy."""
    if claim == "zero_delay_lockstep":
        ev = PS.build_schedule(3, 5, 1, [1.0, 4.0, 2.0], max_delay=0)
        assert len(ev) == 15 and all(e.staleness == 0 for e in ev)
        assert [e.round for e in ev] == sorted(e.round for e in ev)
    elif claim == "unbounded":
        ev = PS.build_schedule(2, 10, 1, [1.0, 10.0], max_delay=None)
        assert max(e.staleness for e in ev if e.proc == 0) >= 5
        assert not any(e.gated for e in ev)
        gated = PS.build_schedule(2, 10, 1, [1.0, 10.0], max_delay=2)
        assert max(e.staleness for e in gated) <= 2
        assert any(e.gated for e in gated if e.proc == 0)
    elif claim == "adaptive_cadence":
        assert PS.local_steps(6, 3.0, adaptive=True) == 2
        assert PS.local_steps(1, 8.0, adaptive=True) == 1
        ev = PS.build_schedule(2, 8, 6, [1.0, 3.0], max_delay=1,
                               adaptive=True)
        assert not any(e.gated for e in ev)
    else:
        ev = PS.build_schedule(3, 5, 4, [1.0, 3.0, 2.0], max_delay=0,
                               adaptive=True)
        first = {}
        for e in ev:
            first.setdefault(e.round, e.index)
        for e in ev:
            assert all(c == first[e.round] for c in e.ingest_cursors)
            assert all(lag == 0 for lag in e.view_lags)


@pytest.mark.parametrize("kind", ["cyclic", "random"])
def test_walk_sequence_equals_reference(kind):
    """`WalkSequence.take` in pieces, and `walk_sequence`, draw the
    reference's (agent, walk) pairs; the P=1 cyclic stream is
    run_serial's round-robin."""
    for n, procs, walks, seed in ((9, 2, 3, 6), (10, 3, 2, 4), (7, 1, 3, 0),
                                  (12, 4, 2, 11)):
        for proc in range(procs):
            mine = PS.WalkSequence(n, procs, proc, walks, kind=kind,
                                   seed=seed)
            ref = RS.WalkSequence(n, procs, proc, walks, kind=kind,
                                  seed=seed)
            for piece in (4, 1, 7, 3):
                assert mine.take(piece) == ref.take(piece)
            assert PS.walk_sequence(n, procs, proc, walks, 20, kind=kind,
                                    seed=seed) == RS.walk_sequence(
                n, procs, proc, walks, 20, kind=kind, seed=seed)
    if kind == "cyclic":
        pos = [(w * 7) // 3 for w in range(3)]
        for j, (agent, w) in enumerate(PS.walk_sequence(7, 1, 0, 3, 12)):
            assert (agent, w) == (pos[j % 3], j % 3)
            pos[w] = (pos[w] + 1) % 7
    else:
        lo, hi = PS.agent_shard(10, 3, 1)
        seq = PS.walk_sequence(10, 3, 1, 2, 50, kind="random", seed=4)
        assert all(lo <= a < hi for a, _ in seq)
        assert seq != PS.walk_sequence(10, 3, 1, 2, 50, kind="random",
                                       seed=5)


def test_speed_and_shard_helpers_equal_reference():
    rng = np.random.default_rng(0)
    for ema in [0.0, 1e-3, 4e-3, 16e-3, 10e-3, 30e-3,
                *rng.uniform(0, 0.1, 20)]:
        for quantum, base in ((1e-3, 2.0 ** 0.5), (1e-3, 2.0), (5e-4, 1.5)):
            assert PS.quantize_speed(ema, quantum, base) == \
                RS.quantize_speed(ema, quantum, base)
    for _ in range(10):
        b = rng.integers(0, 12, int(rng.integers(1, 6))).tolist()
        assert PS.bucket_speeds(b) == RS.bucket_speeds(b)
        assert PS.bucket_speeds(b, 2.0) == RS.bucket_speeds(b, 2.0)
    for rounds in (1, 10, 12, 23):
        for rate in (None, 0, 1, 4, 5, 12, 20):
            assert PS.epoch_spans(rounds, rate) == RS.epoch_spans(
                rounds, rate)
    for n in range(1, 20):
        for procs in range(1, min(n, 8) + 1):
            assert [PS.agent_shard(n, procs, p) for p in range(procs)] == [
                RS.agent_shard(n, procs, p) for p in range(procs)]
    for base in (1, 4, 6):
        for speed in (0.3, 1.0, 2.5, 3.0, 8.0):
            for adaptive in (False, True):
                assert PS.local_steps(base, speed, adaptive) == \
                    RS.local_steps(base, speed, adaptive)


def test_encode_gives_reference_bytes():
    """A delta's wire bytes (the worker's `_enc` of a tensor) equal the
    reference's of the same numpy values, and so do the other payloads."""
    rng = np.random.default_rng(1)
    delta = rng.standard_normal((2, 12))
    assert PT._enc(torch.from_numpy(delta)) == RT._enc(delta)
    # a strided view goes out contiguous, as the reference's
    assert PT._enc(torch.from_numpy(delta).T) == RT._enc(delta.T)
    for obj in (3, {"proc": 1, "trace": [{"objective": 0.5}]}, delta):
        assert PC.encode(obj) == RC.encode(obj)
        assert PC.decode(RC.encode(obj)).__repr__() == obj.__repr__()


# ---------------------------------------------------------------------------
# threaded runs against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair6():
    """cpusmall over 6 agents, 256 rows: the reference's and the port's."""
    return (ref_make_problem("cpusmall", 6, seed=7, subsample=256),
            make_problem("cpusmall", 6, seed=7, subsample=256))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("mid_round", [False, True], ids=["sync", "mid"])
@pytest.mark.parametrize("rule", ["walk", "fresh"])
@pytest.mark.parametrize("method", ["apibcd", "gapibcd"])
@pytest.mark.parametrize("procs", [2, 3])
def test_run_threaded_matches_reference(pair6, procs, method, rule,
                                        mid_round):
    rp, pp = pair6
    kw = dict(num_procs=procs, num_agents=6, num_walks=2, rounds=5,
              local_steps=3, max_delay=2, rule=rule, mid_round=mid_round,
              speeds=(1.0, 3.0, 1.5)[:procs])
    if method == "apibcd":
        ref = [RM.APIBCD(rp, tau=1.0, num_walks=2) for _ in range(procs)]
        port = [_apibcd(pp) for _ in range(procs)]
    else:
        ref = [RM.GAPIBCD(rp, tau=1.0, num_walks=2, rho=5.0)
               for _ in range(procs)]
        port = [GAPIBCD(pp, tau=1.0, num_walks=2, rho=5.0, device=CPU)
                for _ in range(procs)]
    want = RT.run_threaded(RT.AsyncBCDConfig(**kw), ref)
    got = PT.run_threaded(PT.AsyncBCDConfig(**kw), port)
    assert len({r.digest for r in got}) == 1
    if mid_round:
        assert sum(r.mid_round_ingested for r in got) > 0
    for g, w in zip(got, want):
        assert [[rec[c] for c in INT_COLUMNS] for rec in g.trace] == [
            [rec[c] for c in INT_COLUMNS] for rec in w.trace]
        assert (g.own_updates, g.applied_updates, g.comm_posts,
                g.comm_fetches, g.max_staleness, g.mid_round_ingested,
                g.max_view_lag, g.agent_range) == (
            w.own_updates, w.applied_updates, w.comm_posts,
            w.comm_fetches, w.max_staleness, w.mid_round_ingested,
            w.max_view_lag, w.agent_range)
        _close(g.tokens, w.tokens)
        _close(g.xs_local, w.xs_local)
        _close(np.array([rec["objective"] for rec in g.trace]),
               [rec["objective"] for rec in w.trace])


# ---------------------------------------------------------------------------
# the reference's claims, on the port alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_problem():
    return make_problem("cpusmall", 5, seed=3, subsample=256)


@pytest.mark.parametrize("mid_round", [False, True], ids=["sync", "mid"])
def test_single_process_matches_run_serial(small_problem, mid_round):
    """One worker at local_steps=1 IS the serial driver: final tokens
    and models are bitwise `run_serial`'s (CyclicWalks); with ingestion
    on there are no peers to ingest."""
    m, rounds = 2, 15
    cfg = PT.AsyncBCDConfig(num_procs=1, num_agents=5, num_walks=m,
                            rounds=rounds, mid_round=mid_round)
    res = PT.run_threaded(cfg, [_apibcd(small_problem, m)])[0]
    ser = run_serial(_apibcd(small_problem, m), ring_graph(5),
                     num_iterations=rounds)
    assert torch.equal(res.tokens, ser.tokens)
    assert torch.equal(res.xs_local, ser.xs)
    assert res.mid_round_ingested == 0


def _bsp_reference(cfg, methods):
    """Textbook BSP: round r's deltas all computed from the complete
    round r-1 replica, then applied in the schedule's global order."""
    events = PS.build_schedule(cfg.num_procs, cfg.rounds, cfg.local_steps,
                               cfg.schedule_speeds(), 0,
                               adaptive=cfg.adaptive)
    seqs = [PS.WalkSequence(cfg.num_agents, cfg.num_procs, p,
                            cfg.num_walks, kind=cfg.walk_kind, seed=cfg.seed)
            for p in range(cfg.num_procs)]
    states = [m.init() for m in methods]
    z = states[0].tokens.clone()
    by_round = {}
    for ev in events:
        by_round.setdefault(ev.round, []).append(ev)
    for rnd in sorted(by_round):
        deltas = []
        for ev in by_round[rnd]:
            st = states[ev.proc]
            st.tokens = z.clone()
            before = st.tokens.clone()
            for agent, walk in seqs[ev.proc].take(ev.num_updates):
                st = methods[ev.proc].update(st, agent, walk)
            states[ev.proc] = st
            deltas.append(st.tokens - before)
        for d in deltas:
            z = z + d
    return z


@property_sweep(num_cases=3)
def test_mid_round_zero_delay_is_bsp_bitwise(rng):
    procs = int(rng.integers(2, 4))
    prob = make_problem("cpusmall", 2 * procs,
                        seed=int(rng.integers(0, 100)), subsample=256)
    cfg = PT.AsyncBCDConfig(
        num_procs=procs, num_agents=2 * procs, num_walks=2,
        rounds=int(rng.integers(3, 7)),
        local_steps=int(rng.integers(1, 4)), max_delay=0,
        adaptive=bool(rng.integers(0, 2)),
        speeds=tuple(rng.uniform(0.5, 3.0, procs).tolist()),
        mid_round=True)
    res = PT.run_threaded(cfg, [_apibcd(prob) for _ in range(procs)])
    ref = _bsp_reference(cfg, [_apibcd(prob) for _ in range(procs)])
    assert len({r.digest for r in res}) == 1
    assert torch.equal(res[0].tokens, ref)
    assert all(r.max_view_lag == 0 for r in res)


@property_sweep(num_cases=4)
def test_mid_round_digest_and_lag_bound_sweep(rng):
    procs = int(rng.integers(2, 4))
    delay = int(rng.integers(0, 3))
    prob = make_problem("cpusmall", 2 * procs,
                        seed=int(rng.integers(0, 100)), subsample=256)
    cfg = PT.AsyncBCDConfig(
        num_procs=procs, num_agents=2 * procs, num_walks=2,
        rounds=int(rng.integers(3, 8)),
        local_steps=int(rng.integers(1, 4)), max_delay=delay,
        adaptive=True, speeds=tuple(rng.uniform(0.5, 3.0, procs)),
        seed=int(rng.integers(0, 50)), mid_round=True)

    def go():
        return PT.run_threaded(cfg, [_apibcd(prob) for _ in range(procs)])
    res, rep = go(), go()
    assert len({r.digest for r in res + rep}) == 1
    for r in res:
        assert r.max_view_lag <= delay and r.max_staleness <= delay


def _threaded(problem, rule="walk", **kw):
    cfg = PT.AsyncBCDConfig(num_procs=2, num_agents=5, num_walks=2,
                            rounds=10, rule=rule, **kw)
    return cfg, PT.run_threaded(cfg, [_apibcd(problem) for _ in range(2)])


@pytest.mark.parametrize("rule", ["walk", "fresh"])
def test_threaded_digest_identical_across_workers_and_repeats(
        small_problem, rule):
    kw = dict(local_steps=3, max_delay=2, adaptive=True, speeds=(1.0, 2.5))
    _, res = _threaded(small_problem, rule, **kw)
    assert res[0].digest == res[1].digest
    assert torch.equal(res[0].tokens, res[1].tokens)
    _, rep = _threaded(small_problem, rule, **kw)
    assert rep[0].digest == res[0].digest
    assert max(r.max_staleness for r in res) <= 2


def test_threaded_objective_decreases(small_problem):
    _, res = _threaded(small_problem, local_steps=4, max_delay=3,
                       adaptive=True, speeds=(1.0, 2.0))
    objs = [rec["objective"] for rec in res[0].trace]
    assert objs[-1] < objs[0], objs
    est = PT.consensus_estimate(res[0].tokens, "walk")
    assert est.shape == res[0].tokens.shape[1:]
    assert torch.equal(PT.consensus_estimate(res[0].tokens, "fresh"),
                       res[0].tokens.mean(dim=0))


def test_straggler_injection_pads_updates(small_problem):
    """The injection hook is a hard floor: a 3x straggler's wall time is
    at least own_updates * 3 * min_update_s, and the fast process spent
    real time blocked on it."""
    floor = 0.004
    cfg = PT.AsyncBCDConfig(num_procs=2, num_agents=5, num_walks=2,
                            rounds=6, local_steps=2, max_delay=2,
                            speeds=(1.0, 3.0), min_update_s=floor)
    res = PT.run_threaded(cfg, [_apibcd(small_problem) for _ in range(2)])
    slow = res[1]
    assert slow.wall_s >= slow.own_updates * 3.0 * floor * 0.95
    assert res[0].gate_wait_s > 0.0


def test_comm_counts_accounted(small_problem):
    cfg, res = _threaded(small_problem, local_steps=1, max_delay=0)
    for r in res:
        assert r.comm_posts == cfg.rounds
        assert r.comm_fetches == cfg.rounds * (cfg.num_procs - 1)
        assert r.applied_updates == sum(rr.own_updates for rr in res)


def test_mid_round_ingests_between_steps(small_problem):
    kw = dict(local_steps=3, max_delay=2, speeds=(1.0, 3.0))
    _, plain = _threaded(small_problem, **kw)
    _, mid = _threaded(small_problem, mid_round=True, **kw)
    assert plain[0].digest == plain[1].digest
    assert mid[0].digest == mid[1].digest
    assert sum(r.mid_round_ingested for r in mid) > 0
    assert all(r.mid_round_ingested == 0 for r in plain)
    assert max(r.max_view_lag for r in mid) \
        <= max(r.max_staleness for r in plain)


# ---------------------------------------------------------------------------
# measured speeds: on a clock that only the pad moves
# ---------------------------------------------------------------------------


class _PadClock:
    """Stands in for the trainer module's `time`: a monotonic clock per
    thread that only `sleep` moves. An update then takes no time and a
    padded one exactly its floor, so each worker's EMA is its floor and
    the buckets are exact whatever the load on the host."""

    def __init__(self):
        self._local = threading.local()

    def monotonic(self):
        return getattr(self._local, "t", 0.0)

    def sleep(self, s):
        self._local.t = self.monotonic() + s


def _measured_cfg(**kw):
    base = dict(num_procs=2, num_agents=5, num_walks=2, rounds=8,
                local_steps=4, max_delay=2, adaptive=True,
                speeds=(1.0, 4.0), min_update_s=0.004,
                measured_speeds=True, rate_rounds=4,
                speed_bucket_base=2.0)
    base.update(kw)
    return PT.AsyncBCDConfig(**base)


def test_measured_speeds_agree_and_reproduce(small_problem, monkeypatch):
    """The rate sync agrees on one bucket vector, the straggler lands in
    a strictly higher bucket (4 ms and 16 ms on a base-2 grid: buckets 2
    and 4), and digests match across workers AND repeats."""
    monkeypatch.setattr(PT, "time", _PadClock())
    cfg = _measured_cfg()

    def go():
        return PT.run_threaded(cfg, [_apibcd(small_problem)
                                     for _ in range(2)])
    res, rep = go(), go()
    assert len({r.digest for r in res + rep}) == 1
    assert all(r.num_epochs == 2 and r.rate_syncs == 1 for r in res)
    assert [r.speed_buckets for r in res + rep] == [[[2, 4]]] * 4
    assert [r.update_ema_s for r in res] == pytest.approx([0.004, 0.016])


def test_measured_speeds_adapt_step_counts(small_problem, monkeypatch):
    """After the rate sync the rebuilt schedule batches fewer walks per
    round on the discovered straggler."""
    monkeypatch.setattr(PT, "time", _PadClock())
    res = PT.run_threaded(_measured_cfg(), [_apibcd(small_problem)
                                            for _ in range(2)])

    def epoch_steps(r, ei):
        recs = [t for t in r.trace if t["epoch"] == ei]
        prev = [t for t in r.trace if t["epoch"] < ei]
        base = prev[-1]["own_updates"] if prev else 0
        return recs[-1]["own_updates"] - base
    assert epoch_steps(res[0], 0) == epoch_steps(res[1], 0)
    assert epoch_steps(res[1], 1) < epoch_steps(res[0], 1)


def test_measured_ema_not_poisoned_by_transport_latency(small_problem):
    """KV waits — sync gate AND mid-round ingestion — are separate
    monotonic segments, so 30 ms of chaos latency stays out of an EMA
    floored at 2 and 6 ms (real clock)."""
    cfg = _measured_cfg(speeds=(1.0, 3.0), min_update_s=0.002,
                        mid_round=True, speed_bucket_base=2.0 ** 0.5)
    kv = PC.ChaosKV(PC.DictKV(), seed=9, max_latency_s=0.03, dup_prob=0.3)
    res = PT.run_threaded(cfg, [_apibcd(small_problem) for _ in range(2)],
                          kv=kv)
    kv.drain()
    assert len({r.digest for r in res}) == 1
    for r, floor in zip(res, (0.002, 0.006)):
        assert floor * 0.9 <= r.update_ema_s < 0.015, (r.proc,
                                                       r.update_ema_s)
    assert any(r.gate_wait_s + r.ingest_wait_s > 0.02 for r in res)


# ---------------------------------------------------------------------------
# transports: every one carries the same numerics
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tcp_kvs(procs):
    """One store client per worker, process 0's hosting the store."""
    port = _free_port()
    return [PC.TCPStoreKV("localhost", port, procs, p, timeout_s=60.0)
            for p in range(procs)]


def _run_workers(cfg, methods, kvs):
    """run_threaded with a transport of its own for each worker."""
    workers = [PT.AsyncWorker(cfg, methods[p], p, kvs[p])
               for p in range(cfg.num_procs)]
    results, errors = [None] * cfg.num_procs, []

    def drive(p):
        try:
            results[p] = workers[p].run()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(p,), daemon=True)
               for p in range(cfg.num_procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=cfg.comm_timeout_s + 30)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    for kv in kvs[1:] + kvs[:1]:       # peers leave first, the host last
        kv.close()
    return results


def _chaos_cfg(**kw):
    base = dict(num_procs=3, num_agents=6, num_walks=2, rounds=6,
                local_steps=2, max_delay=2, adaptive=True,
                speeds=(1.0, 2.0, 1.0), comm_timeout_s=60.0,
                mid_round=True)
    base.update(kw)
    return PT.AsyncBCDConfig(**base)


@pytest.fixture(scope="module")
def clean_run(pair6):
    cfg = _chaos_cfg()
    return PT.run_threaded(cfg, [_apibcd(pair6[1]) for _ in range(3)])


@pytest.mark.parametrize("transport", ["dict", "file", "chaos-dict",
                                       "chaos-file", "tcp"])
def test_digests_equal_across_transports_and_repeats(pair6, clean_run,
                                                     transport, tmp_path):
    """Every worker's digest equals every other's, a repeat's under the
    same transport (and chaos seed), and the clean DictKV run's: the
    numerics never see the transport."""
    cfg = _chaos_cfg()
    digests = set()
    for rep in range(2):
        methods = [_apibcd(pair6[1]) for _ in range(3)]
        if transport == "tcp":
            res = _run_workers(cfg, methods, _tcp_kvs(3))
        else:
            kv = (PC.FileKV(str(tmp_path / f"kv{rep}"))
                  if transport.endswith("file") else PC.DictKV())
            if transport.startswith("chaos"):
                kv = PC.ChaosKV(kv, seed=5, max_latency_s=0.008,
                                dup_prob=0.5)
            res = PT.run_threaded(cfg, methods, kv=kv)
            if transport.startswith("chaos"):
                kv.drain()
        digests |= {r.digest for r in res}
        assert torch.equal(res[0].tokens, clean_run[0].tokens)
    assert digests == {clean_run[0].digest}


class _CountingKV(PC.DictKV):
    def __init__(self):
        super().__init__()
        self.sets = {}

    def set(self, key, value):
        self.sets[key] = self.sets.get(key, 0) + 1
        super().set(key, value)


def test_chaos_latency_and_duplicates_are_real():
    inner = _CountingKV()
    kv = PC.ChaosKV(inner, seed=3, max_latency_s=0.005, dup_prob=1.0)
    for i in range(8):
        kv.set(f"k/{i}", f"v{i}".encode())
    for i in range(8):
        assert kv.get(f"k/{i}", 5.0) == f"v{i}".encode()
    kv.drain()
    assert all(n == 2 for n in inner.sets.values()), inner.sets


def test_chaos_delivery_schedule_is_seeded():
    """Per-key delays depend only on (seed, key), and are the
    reference's draws."""
    kvs = [PC.ChaosKV(PC.DictKV(), seed=s) for s in (11, 11, 12)]
    draws = [tuple(float(kv._rng(f"delta/0/{r}").uniform(0.0, 1.0))
                   for r in range(6)) for kv in kvs]
    assert draws[0] == draws[1] != draws[2]
    ref = RC.ChaosKV(RC.DictKV(), seed=11)
    assert draws[0] == tuple(float(ref._rng(f"delta/0/{r}").uniform(0.0, 1.0))
                             for r in range(6))


def test_dictkv_tolerates_identical_replay_rejects_conflict():
    kv = PC.DictKV()
    kv.set("delta/0/1", b"payload")
    kv.set("delta/0/1", b"payload")
    assert kv.get("delta/0/1", 1.0) == b"payload"
    with pytest.raises(AssertionError):
        kv.set("delta/0/1", b"different")


@pytest.mark.parametrize("transport", ["chaos", "file", "tcp"])
def test_lost_update_times_out_instead_of_hanging(transport, tmp_path):
    """A key nobody publishes raises KVTimeout at the deadline."""
    if transport == "chaos":
        kv = PC.ChaosKV(PC.DictKV(), seed=0)
    elif transport == "file":
        kv = PC.FileKV(str(tmp_path / "kv"))
    else:
        kv = PC.TCPStoreKV("localhost", _free_port(), 1, 0, timeout_s=5.0)
    with pytest.raises(PC.KVTimeout):
        kv.get("delta/9/9", 0.05)


def test_tcp_store_round_trip_and_barrier():
    """Bytes come back as set, across clients, and a barrier releases
    every process once all have reached it."""
    kvs = _tcp_kvs(3)
    blob = PC.encode(np.arange(6.0).reshape(2, 3))
    kvs[1].set("delta/1/1", blob)
    assert kvs[0].get("delta/1/1", 5.0) == blob
    assert kvs[2].get("delta/1/1", 5.0) == blob
    threads = [threading.Thread(target=kv.barrier,
                                args=("b", 3, p, 10.0), daemon=True)
               for p, kv in enumerate(kvs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    for kv in kvs[1:] + kvs[:1]:
        kv.close()


def test_chaos_measured_speeds_rate_sync_survives(pair6):
    cfg = _chaos_cfg(rounds=8, measured_speeds=True, rate_rounds=4,
                     min_update_s=0.002)
    kv = PC.ChaosKV(PC.DictKV(), seed=21, max_latency_s=0.005, dup_prob=0.5)
    res = PT.run_threaded(cfg, [_apibcd(pair6[1]) for _ in range(3)], kv=kv)
    kv.drain()
    assert len({r.digest for r in res}) == 1
    assert all(r.rate_syncs == 1 for r in res)
    assert res[0].speed_buckets == res[1].speed_buckets \
        == res[2].speed_buckets
