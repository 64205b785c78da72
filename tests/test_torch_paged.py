"""Parity of the port's paged and ring-paged serving path with the JAX
reference, at smoke size on the CPU.

Both sides start from the reference's parameters (`params_from_jax`) and
pool (`pool_from_jax`) and run in f32 (compute and cache). The port's
paged decode attention goes through `kernels.ops`, which on the CPU runs
the kernels' plain versions; the reference's model path gathers the pages
and computes attention with jnp. Logits and pool leaves agree to atol
1e-5 (only the order of f32 sums differs), and greedy tokens are equal.

The JAX paged engine fails two of its own tests in bf16
(`tests/test_server.py`); here, in f32, the port's engines are held
against the JAX arena engine (and, for a window, against both JAX
windowed engines), and against their own unpreempted runs.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda)
from repro_torch.kernels.decode_attention_paged import (  # noqa: E402
    decode_attention_paged_cuda, decode_attention_ring_cuda)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_jax, pool_from_jax)
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve.bucketing import (  # noqa: E402
    chunks_needed, table_width)
from repro_torch.serve.paging import BlockAllocator, blocks_needed  # noqa: E402

ARCH = "qwen2-0.5b"
ATOL = 1e-5
WINDOW = 16


@pytest.fixture(scope="module")
def jx():
    """The JAX reference (absent on the card's machine: the card-only
    tests below do not use it)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as jax_get_smoke
    from repro.models import build_model as jax_build_model
    from repro.serve import Engine as JaxEngine
    from repro.serve import bucketing as jax_bucketing
    from repro.serve import paging as jax_paging
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke=jax_get_smoke,
                                 build_model=jax_build_model,
                                 Engine=JaxEngine, bucketing=jax_bucketing,
                                 paging=jax_paging)


def _models(jx, window):
    jcfg = dataclasses.replace(jx.get_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jmodel = jx.build_model(jcfg, window=window)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    tparams = params_from_jax(jx.jax.device_get(jparams))
    return jmodel, jparams, build_model(tcfg, window=window), tparams


@pytest.fixture(scope="module")
def served(jx):
    return _models(jx, 0)


@pytest.fixture(scope="module")
def served_windowed(jx):
    return _models(jx, WINDOW)


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


def _run(engine, prompts, budgets):
    uids = [engine.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    done = {r.uid: r for r in _drain(engine)}
    return [done[u].output.tolist() for u in uids], [done[u] for u in uids]


def _drain(eng, max_steps=800):
    """run() with a step cap: a livelock fails the test instead of
    hanging the suite."""
    for _ in range(max_steps):
        eng.step()
        if not (eng.pending or eng.num_active):
            return list(eng._done)
    raise AssertionError(f"engine did not drain in {max_steps} steps "
                         f"(pending={eng.pending}, active={eng.num_active})")


def _assert_pool_equal(jpool, tpool, skip_null=False):
    """Pool leaves to ATOL; skip_null leaves block 0 out (the null block
    takes the dead rows' writes, whose winner is undefined in both)."""
    lo = 1 if skip_null else 0
    for name, want in jpool[0].items():
        want, got = np.asarray(want), tpool[0][name].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got[:, lo:], want[:, lo:], rtol=0,
                                   atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# the host-side copies
# ---------------------------------------------------------------------------


def test_paging_and_bucketing_copies_match_reference(jx):
    for n in range(0, 40):
        for bs in (1, 4, 8, 16):
            assert blocks_needed(n, bs) == jx.paging.blocks_needed(n, bs)
            assert (chunks_needed(n, bs)
                    == jx.bucketing.chunks_needed(n, bs))
            for nb, window in ((6, 0), (64, 0), (64, 16), (64, 40)):
                assert (table_width(n, bs, nb, window)
                        == jx.bucketing.table_width(n, bs, nb, window))
    ops = [("alloc", 3), ("reserve", 2), ("alloc_r", 1), ("release", 0),
           ("alloc", 2), ("unreserve", 1), ("partial", 0)]
    mine, theirs = BlockAllocator(8), jx.paging.BlockAllocator(8)
    got = {}
    for a in (mine, theirs):
        held, trace = [], []
        for op, n in ops:
            if op == "alloc":
                held += a.alloc(n)
            elif op == "alloc_r":
                held += a.alloc(n, reserved=True)
            elif op == "reserve":
                a.reserve(n)
            elif op == "unreserve":
                a.unreserve(n)
            elif op == "release":
                a.release(held[:2])
                held = held[2:]
            else:
                a.free_partial([0] + held + [0])
                held = []
            trace.append((list(held), a.free_count, a.available, a.in_use,
                          a.peak_in_use, a.can_allocate(3, watermark=1)))
        got[id(a)] = trace
    assert got[id(mine)] == got[id(theirs)]


def test_pool_from_jax_round_trip(jx, served):
    jnp = jx.jnp
    jmodel, _, tmodel, _ = served
    jpool = jx.jax.device_get(jmodel.init_pool(6, 8, dtype=jnp.float32))
    (tpool,) = pool_from_jax(jpool)
    cfg = tmodel.cfg
    shape = (cfg.num_layers, 7, 8, cfg.num_kv_heads, cfg.head_dim)
    assert set(tpool) == {"k", "v"}
    (own,) = tmodel.init_pool(6, 8, dtype=torch.float32)
    for name in ("k", "v"):
        assert tuple(tpool[name].shape) == shape == jpool[0][name].shape
        assert tpool[name].dtype == own[name].dtype == torch.float32
        assert own[name].shape == tpool[name].shape
    jb = jx.jax.device_get(jmodel.init_pool(2, 4, dtype=jnp.bfloat16))
    jb[0]["v"] = jb[0]["v"] + jnp.bfloat16(-2.5)
    (tb,) = pool_from_jax(jb)
    assert tb["v"].dtype == torch.bfloat16 and bool((tb["v"] == -2.5).all())


# ---------------------------------------------------------------------------
# the model's paged entry points against the reference's jnp path
# ---------------------------------------------------------------------------


def _stream_prompts(jx, served, prompts, tables, chunk, jpool, tpool):
    """Chunked prefill of each prompt into its table on both sides;
    checks every chunk's logits and returns the pools."""
    jnp = jx.jnp
    jmodel, jparams, tmodel, tparams = served
    jprefill = jx.jax.jit(jmodel.prefill_chunk_into_blocks)
    for prompt, table in zip(prompts, tables):
        plen = len(prompt)
        for i in range(chunks_needed(plen, chunk)):
            part = prompt[i * chunk:(i + 1) * chunk]
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :len(part)] = part
            jl, jpool = jprefill(jparams, jnp.asarray(toks),
                                 jnp.int32(len(part)), jnp.int32(i * chunk),
                                 jnp.asarray(table), jpool)
            tl, tpool = tmodel.prefill_chunk_into_blocks(
                tparams, torch.from_numpy(toks), len(part), i * chunk,
                torch.from_numpy(table), tpool)
            assert tl.shape == jl.shape == (1, 1, tmodel.cfg.vocab_size)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=ATOL)
    return jpool, tpool


@pytest.mark.parametrize("window", [0, WINDOW], ids=["paged", "ring"])
def test_prefill_chunks_and_decode_rows_paged_match_reference(
        jx, served, served_windowed, window):
    """Two prompts (one longer than the window) stream in through chunks
    of 8 into scattered blocks; then three rows (the two, and a dead row
    on the null block) decode 24 steps, taking a fresh block whenever a
    live row crosses into an empty table entry. Logits every chunk and
    step, and the pool leaves after prefill and at the end, agree."""
    jnp = jx.jnp
    jmodel, jparams, tmodel, tparams = served_windowed if window else served
    vocab, bs, nb, chunk = tmodel.cfg.vocab_size, 8, 16, 8
    jpool = jmodel.init_pool(nb, bs, dtype=jnp.float32)
    tpool = pool_from_jax(jx.jax.device_get(jpool))
    prompts = _prompts(vocab, (21, 6), seed=40)
    w = table_width(21 + 24, bs, nb, window)
    free = iter([9, 3, 14, 6, 1, 11, 4, 16, 8, 2, 12, 5, 15, 7, 13, 10])
    tables = np.zeros((3, w), np.int32)
    for row, prompt in enumerate(prompts):
        n = blocks_needed(min(len(prompt), window or len(prompt)), bs)
        tables[row, :n] = [next(free) for _ in range(n)]
    jpool, tpool = _stream_prompts(
        jx, (jmodel, jparams, tmodel, tparams), prompts,
        [t[:table_width(len(p), bs, nb, window)].copy()
         for t, p in zip(tables, prompts)], chunk, jpool, tpool)
    _assert_pool_equal(jpool, tpool)

    lengths = np.array([21, 6, 0], np.int32)
    cur = _prompts(vocab, (3,), seed=41)[0]
    jdecode = jx.jax.jit(jmodel.decode_rows_paged)
    for _ in range(24):
        for row in (0, 1):
            pos = int(lengths[row]) % (window or 1 << 30)
            if tables[row, pos // bs] == 0:
                tables[row, pos // bs] = next(free)
        jl, jpool = jdecode(jparams, jnp.asarray(cur)[:, None], jpool,
                            jnp.asarray(tables), jnp.asarray(lengths))
        tl, tpool = tmodel.decode_rows_paged(
            tparams, torch.from_numpy(cur)[:, None], tpool,
            torch.from_numpy(tables), torch.from_numpy(lengths))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   rtol=0, atol=ATOL)
        want = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        np.testing.assert_array_equal(tl[:2, -1].argmax(-1).numpy(),
                                      want[:2])
        cur, lengths = want, lengths + 1
    if window:
        assert lengths[0] > 2 * window     # the ring wrapped
    _assert_pool_equal(jpool, tpool, skip_null=True)


@pytest.mark.parametrize("window", [0, WINDOW], ids=["paged", "ring"])
def test_token_variants_match_reference(jx, served, served_windowed, window):
    jnp = jx.jnp
    jmodel, jparams, tmodel, tparams = served_windowed if window else served
    bs, nb = 8, 8
    jpool = jmodel.init_pool(nb, bs, dtype=jnp.float32)
    tpool = pool_from_jax(jx.jax.device_get(jpool))
    tables = np.array([[2, 5], [7, 1]], np.int32)
    lengths = np.zeros(2, np.int32)
    cur = np.zeros(2, np.int32)
    for row, prompt in enumerate(_prompts(tmodel.cfg.vocab_size, (9, 4), 42)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(prompt)] = prompt
        jt, jpool = jmodel.prefill_chunk_into_blocks_token(
            jparams, jnp.asarray(toks), jnp.int32(len(prompt)), jnp.int32(0),
            jnp.asarray(tables[row]), jpool)
        tt, tpool = tmodel.prefill_chunk_into_blocks_token(
            tparams, torch.from_numpy(toks), len(prompt), 0,
            torch.from_numpy(tables[row]), tpool)
        assert tt.dtype == torch.int32 and tt.dim() == 0
        assert int(tt) == int(jt)
        lengths[row], cur[row] = len(prompt), int(jt)
    jcur, jlen = jnp.asarray(cur), jnp.asarray(lengths)
    tcur, tlen = torch.from_numpy(cur), torch.from_numpy(lengths)
    jdecode = jx.jax.jit(jmodel.decode_rows_paged_tokens)
    for _ in range(5):
        jcur, jpool, jlen = jdecode(jparams, jcur, jpool,
                                    jnp.asarray(tables), jlen)
        tcur, tpool, tlen = tmodel.decode_rows_paged_tokens(
            tparams, tcur, tpool, torch.from_numpy(tables), tlen)
        assert tcur.dtype == torch.int32 and tlen.dtype == torch.int32
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


def test_dead_row_drift_past_the_table_is_inert(jx, served):
    """A dead row (zeroed table) whose length has drifted past W * bs:
    its write goes to the null block (the reference drops it), the live
    rows' logits and every real block agree, and the row's own output is
    finite."""
    jnp = jx.jnp
    jmodel, jparams, tmodel, tparams = served
    bs, nb = 4, 8
    jpool = jmodel.init_pool(nb, bs, dtype=jnp.float32)
    tpool = pool_from_jax(jx.jax.device_get(jpool))
    prompt = _prompts(tmodel.cfg.vocab_size, (6,), 43)[0]
    tables = np.zeros((2, 4), np.int32)
    tables[0, :2] = [6, 3]
    jpool, tpool = _stream_prompts(jx, served, [prompt],
                                   [tables[0, :2].copy()], 8, jpool, tpool)
    lengths = np.array([6, 4 * bs + 9], np.int32)     # row 1: dead, drifted
    cur = np.array([17, 99], np.int32)
    for _ in range(3):
        jl, jpool = jmodel.decode_rows_paged(
            jparams, jnp.asarray(cur)[:, None], jpool, jnp.asarray(tables),
            jnp.asarray(lengths))
        tl, tpool = tmodel.decode_rows_paged(
            tparams, torch.from_numpy(cur)[:, None], tpool,
            torch.from_numpy(tables), torch.from_numpy(lengths))
        np.testing.assert_allclose(tl[:1].numpy(), np.asarray(jl)[:1],
                                   rtol=0, atol=ATOL)
        assert bool(torch.isfinite(tl).all())
        cur, lengths = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32), \
            lengths + 1
    _assert_pool_equal(jpool, tpool, skip_null=True)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# (prompt length, budget): more requests than rows, longer than the
# 16-token slot of the arena below, mixed lengths and budgets
WORKLOAD = [(5, 6), (11, 14), (3, 9), (8, 1), (14, 5), (2, 20), (9, 4)]


def _port(served, **kw):
    _, _, tmodel, tparams = served
    return Engine(tmodel, tparams, cache_dtype=torch.float32, paged=True,
                  **kw)


def _jax_arena(jx, served, prompts, budgets, max_len):
    jmodel, jparams = served[:2]
    eng = jx.Engine(jmodel, jparams, max_batch=3, max_len=max_len,
                    cache_dtype=jx.jnp.float32, overlap=False)
    assert not eng.paged and not eng.overlap
    return _run(eng, prompts, budgets)[0]


@pytest.fixture(scope="module")
def workload(jx, served):
    prompts = _prompts(served[2].cfg.vocab_size, [n for n, _ in WORKLOAD], 0)
    budgets = [b for _, b in WORKLOAD]
    return prompts, budgets, _jax_arena(jx, served, prompts, budgets, 32)


@pytest.mark.parametrize("block_size,chunk", [(8, 32), (4, 4)])
def test_paged_engine_matches_jax_arena_engine(served, workload, block_size,
                                               chunk):
    prompts, budgets, want = workload
    eng = _port(served, max_batch=3, max_len=16, block_size=block_size,
                num_blocks=24, prefill_chunk=chunk)
    assert eng.paged and eng.capacity == 16     # several exceed the slot
    outs, reqs = _run(eng, prompts, budgets)
    assert outs == want
    assert [len(o) for o in outs] == budgets
    assert eng.num_preemptions == 0
    assert eng.free_blocks == eng.num_blocks
    st = eng.stats
    assert st["decode_fetch_elems"] == 3 and st["decode_fetch_dtype"] == "int32"
    assert st["admissions"] == len(budgets) and st["replayed_tokens"] == 0
    assert eng.prefill_shapes == {chunk}


def test_paged_engine_rejects_what_the_pool_cannot_hold(served):
    eng = _port(served, max_batch=2, max_len=16, block_size=8, num_blocks=4)
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=14)
    eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=13)   # 32 fits


def test_ring_paged_engine_matches_jax_windowed_engines(jx, served_windowed):
    """Window 16, block size 8 (a ring of two blocks): prompts and
    generations past the window, against the JAX windowed arena and
    ring-paged engines (serialized)."""
    jmodel, jparams, tmodel, _ = served_windowed
    prompts = _prompts(tmodel.cfg.vocab_size, (5, 23, 11, 3), 44)
    budgets = [30, 30, 12, 25]
    want = _jax_arena(jx, served_windowed, prompts, budgets, 128)
    jpaged = jx.Engine(jmodel, jparams, max_batch=2, max_len=128,
                       cache_dtype=jx.jnp.float32, paged=True, block_size=8,
                       num_blocks=24, prefill_chunk=32, overlap=False)
    assert jpaged.paged and jpaged.prefill_chunk == WINDOW
    assert _run(jpaged, prompts, budgets)[0] == want
    eng = _port(served_windowed, max_batch=2, max_len=128, block_size=8,
                num_blocks=24, prefill_chunk=32)
    assert eng.window == WINDOW and eng.prefill_chunk == WINDOW
    outs, _ = _run(eng, prompts, budgets)
    assert outs == want
    # a ring of two blocks per slot, however long the generation
    assert eng._allocator.peak_in_use <= 2 * 2
    assert eng.free_blocks == eng.num_blocks


def test_ring_paged_engine_allocates_nothing_once_the_ring_is_full(
        served_windowed):
    eng = _port(served_windowed, max_batch=1, max_len=64, block_size=8,
                num_blocks=32, prefill_chunk=8)
    eng.submit(_prompts(512, (10,), 45)[0], max_new_tokens=100)
    eng.step()                                  # admission + first step
    held = eng._allocator.in_use
    assert held == 2
    for _ in range(60):
        eng.step()
        assert eng._allocator.in_use == held
    assert len(_drain(eng)[0].output) == 100
    assert eng._allocator.peak_in_use == 2
    assert eng.free_blocks == eng.num_blocks


def _solo(served, prompt, budget, **kw):
    eng = _port(served, **kw)
    eng.submit(prompt, max_new_tokens=budget)
    return _drain(eng)[0].output.tolist()


def test_preemption_bit_identity(jx, served):
    """Two hungry requests in a pool that cannot hold both at peak:
    optimistic admission takes both, the younger is evicted (LIFO) and
    recomputed, and both outputs equal their unpreempted runs and the
    JAX arena engine's."""
    prompts = _prompts(served[2].cfg.vocab_size, (8, 8), 30)
    geom = dict(max_batch=2, max_len=32, block_size=8, prefill_chunk=4)
    solo = [_solo(served, p, 20, num_blocks=16, **geom) for p in prompts]
    assert solo == _jax_arena(jx, served, prompts, [20, 20], 32)
    eng = _port(served, num_blocks=6, **geom)
    assert eng.preemption == "recompute"
    outs, reqs = _run(eng, prompts, [20, 20])
    assert eng.num_preemptions >= 1
    assert reqs[1].preemptions >= 1 and reqs[0].preemptions == 0
    assert eng.stats["replayed_tokens"] > 0
    assert outs == solo
    assert eng.free_blocks == eng.num_blocks


def test_preemption_during_replay_bit_identity(jx, served):
    """A slot evicted while it still replays an earlier eviction's tokens
    re-admits cleanly: its output is exactly its budget and equals the
    unpreempted run's and the JAX arena engine's."""
    prompts = _prompts(served[2].cfg.vocab_size, (4, 4), 34)
    budget = 24
    geom = dict(max_batch=2, max_len=32, block_size=4, prefill_chunk=4)
    solo = [_solo(served, p, budget, num_blocks=16, **geom) for p in prompts]
    assert solo == _jax_arena(jx, served, prompts, [budget] * 2, 32)
    eng = _port(served, num_blocks=7, **geom)
    ua, ub = (eng.submit(p, max_new_tokens=budget) for p in prompts)
    mid_replay_evictions = 0
    for _ in range(600):
        b_slot = next((s for s in range(eng.max_batch)
                       if eng._slot_req[s] is not None
                       and eng._slot_req[s].uid == ub), None)
        replaying = b_slot is not None and bool(eng._replay[b_slot])
        before = eng.num_preemptions
        eng.step()
        if (replaying and eng.num_preemptions > before
                and any(r.uid == ub for r in eng._queue)):
            mid_replay_evictions += 1
        if not (eng.pending or eng.num_active):
            break
    else:
        raise AssertionError("engine did not drain")
    assert mid_replay_evictions >= 1
    outs = {r.uid: r for r in eng._done}
    assert outs[ub].preemptions >= 2
    assert [outs[u].output.tolist() for u in (ua, ub)] == solo
    assert eng.free_blocks == eng.num_blocks


def test_ring_paged_preemption_bit_identity(served_windowed):
    """Preempt-and-recompute through the ring: the recompute prefill and
    the replay rebuild the ring, and the outputs equal unstarved runs."""
    prompts = _prompts(served_windowed[2].cfg.vocab_size, (9, 12), 46)
    geom = dict(max_batch=2, max_len=64, block_size=4, prefill_chunk=8)
    solo = [_solo(served_windowed, p, 40, num_blocks=16, **geom)
            for p in prompts]
    eng = _port(served_windowed, num_blocks=7, **geom)
    outs, reqs = _run(eng, prompts, [40, 40])
    assert reqs[1].preemptions >= 1
    assert eng.stats["replayed_tokens"] > 0
    assert outs == solo
    assert eng.free_blocks == eng.num_blocks


def test_reserve_never_preempts_and_drains_fifo(served, workload):
    """"reserve": a pool with room for about one request's worst case
    drains a deeper queue in FIFO order without preempting, every block
    returns, and the outputs equal the JAX arena engine's."""
    prompts, budgets, want = workload
    eng = _port(served, max_batch=3, max_len=16, block_size=4,
                num_blocks=8, prefill_chunk=4, preemption="reserve",
                overlap=False)
    uids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    eng.step()
    assert eng.num_active < 3 and eng.pending >= 1
    done = _drain(eng)
    assert eng.num_preemptions == 0
    outs = {r.uid: r.output.tolist() for r in done}
    assert [outs[u] for u in uids] == want
    assert eng.free_blocks == eng.num_blocks


def test_preemption_fifo_fairness_and_uid_order(served):
    """Under pressure, never-preempted requests finish in FIFO order, the
    queue stays uid-sorted at every step (evictees re-enter in uid
    position), and every block returns."""
    prompts = _prompts(served[2].cfg.vocab_size, [5] * 6, 33)
    eng = _port(served, max_batch=3, max_len=32, block_size=4, num_blocks=8,
                prefill_chunk=4, overlap=False)
    uids = [eng.submit(p, max_new_tokens=16) for p in prompts]
    for _ in range(800):
        eng.step()
        queued = [r.uid for r in eng._queue]
        assert queued == sorted(queued)
        if not (eng.pending or eng.num_active):
            break
    else:
        raise AssertionError("engine did not drain")
    done = eng._done
    assert sorted(r.uid for r in done) == uids
    assert all(len(r.output) == 16 for r in done)
    never = [r.uid for r in done if r.preemptions == 0]
    assert never == sorted(never)
    assert eng.num_preemptions >= 2
    assert eng.free_blocks == eng.num_blocks


def test_preemption_count_depends_on_lengths_only(served):
    """Block accounting sees lengths, never logits: two runs of one
    workload with different weights preempt the same requests at the
    same steps (the count chip_smoke.py predicts on the CPU for the
    card)."""
    _, _, tmodel, tparams = served
    other = {k: v * 0.5 for k, v in tparams.items()}
    prompts = _prompts(tmodel.cfg.vocab_size, [6] * 5, 47)
    counts = []
    for params in (tparams, other):
        eng = Engine(tmodel, params, max_batch=3, max_len=32,
                     cache_dtype=torch.float32, paged=True, block_size=4,
                     num_blocks=9, prefill_chunk=4, overlap=False)
        _, reqs = _run(eng, prompts, [14] * 5)
        counts.append((eng.num_preemptions, [r.preemptions for r in reqs],
                       eng.stats["decode_steps"],
                       eng.stats["replayed_tokens"]))
    assert counts[0] == counts[1] and counts[0][0] >= 1


def test_windowed_arena_raises(jx, served_windowed):
    """A windowed dense model serves from the arena too, as a ring of the
    window's capacity with prompts at their exact length (the reference's
    caps: no padding below the capacity): its tokens equal the JAX
    windowed arena engine's and the ring-paged engine's, on prompts and
    generations past the window. Its training takes the window (loss
    equal to the reference's windowed model's within 1e-5); a bad
    preemption policy raises."""
    jmodel, jparams, tmodel, tparams = served_windowed
    prompts = _prompts(tmodel.cfg.vocab_size, (5, 23, 11, 3), 44)
    budgets = [30, 30, 12, 25]
    want = _jax_arena(jx, served_windowed, prompts, budgets, 128)
    eng = Engine(tmodel, tparams, max_batch=3, max_len=128,
                 cache_dtype=torch.float32)
    assert not eng.paged and not eng.caps.pad_prompts
    outs, _ = _run(eng, prompts, budgets)
    assert outs == want
    assert eng.prefill_shapes == {5, 23, 11, 3}
    ring = _port(served_windowed, max_batch=2, max_len=128, block_size=8,
                 num_blocks=24, prefill_chunk=32)
    assert _run(ring, prompts, budgets)[0] == want
    arena = tmodel.init_arena(3, 128, dtype=torch.float32)
    assert arena[0]["k"].shape[2] == WINDOW     # the ring, not the capacity
    tokens = np.stack(_prompts(tmodel.cfg.vocab_size, [40, 40], 48))
    jloss, _ = jmodel.train_loss(jparams, {"tokens": jx.jnp.asarray(tokens),
                                           "targets": jx.jnp.asarray(tokens)})
    loss, _ = tmodel.train_loss(tparams, {"tokens": torch.from_numpy(tokens),
                                          "targets": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    with pytest.raises(ValueError, match="preemption"):
        Engine(tmodel, tparams, max_batch=1, max_len=16, paged=True,
               preemption="lifo")


def test_serve_cli_paged_on_cpu():
    from repro_torch.launch import serve
    base = ["--smoke", "--requests", "6", "--max-batch", "3",
            "--prompt-len", "8", "--new-tokens", "12", "--device", "cpu"]
    arena = serve.main(base)
    paged = serve.main(base + ["--paged", "--block-size", "4"])
    scarce = serve.main(base + ["--paged", "--block-size", "4",
                                "--num-blocks", "6"])
    reserve = serve.main(base + ["--paged", "--block-size", "4",
                                 "--num-blocks", "6", "--preemption",
                                 "reserve"])
    assert not arena["paged"] and arena["free_blocks"] is None
    for out in (paged, scarce, reserve):
        assert out["paged"] and out["outputs"] == arena["outputs"]
        assert out["free_blocks"] == out["num_blocks"]
    assert paged["num_preemptions"] == 0 and paged["num_blocks"] == 24
    assert scarce["num_preemptions"] >= 1
    assert reserve["num_preemptions"] == 0


# ---------------------------------------------------------------------------
# on the card (no JAX): the paged serving path through the CUDA kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, WINDOW], ids=["paged", "ring"])
def test_paged_steps_on_card_match_cpu(cuda, monkeypatch, window):
    """Smoke config in f32 (TF32 off): a chunked prefill and 20
    decode_rows_paged steps (past the ring for a window, with a dead row
    drifted past the table) through the kernels on the card and the
    plain versions on the CPU, from one set of parameters: the live row's
    logits agree to 1e-4 (f32 sums in another order), every row's are
    finite, the kernel launches once per layer per step and the linear
    decode kernel never."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    model = build_model(cfg, window=window)
    cpu = model.init(torch.Generator().manual_seed(0))
    bs, nb = 8, 12
    runs = [(dev, {k: v.to(dev) for k, v in cpu.items()},
             model.init_pool(nb, bs, dtype=torch.float32, device=dev))
            for dev in (torch.device("cpu"), cuda)]
    tables = np.zeros((3, 8), np.int32)
    tables[0, :3] = [4, 9, 2]
    prompt = _prompts(cfg.vocab_size, (19,), 48)[0]
    toks = np.zeros((1, 16), np.int32)
    for start in (0, 16):
        part = prompt[start:start + 16]
        toks[:] = 0
        toks[0, :len(part)] = part
        want, got = (model.prefill_chunk_into_blocks(
            p, torch.from_numpy(toks).to(dev), len(part), start,
            torch.from_numpy(tables[0]).to(dev), pool)[0].cpu()
            for dev, p, pool in runs)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    kernel = decode_attention_ring_cuda if window else \
        decode_attention_paged_cuda
    before = (kernel.launches, decode_attention_cuda.launches)
    lengths = np.array([19, 0, 8 * bs + 5], np.int32)   # live, dead, drifted
    cur = np.array([3, 5, 7], np.int32)
    free = iter([1, 3, 5, 6, 7, 8, 10, 11])
    for _ in range(20):
        pos = int(lengths[0]) % (window or 1 << 30)
        if tables[0, pos // bs] == 0:
            tables[0, pos // bs] = next(free)
        want, got = (model.decode_rows_paged(
            p, torch.from_numpy(cur)[:, None].to(dev), pool,
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths).to(dev))[0].cpu()
            for dev, p, pool in runs)
        # the dead rows read the null block, whose contents (the winners
        # of duplicate writes) differ by device: only the live row counts
        torch.testing.assert_close(got[:1], want[:1], rtol=0, atol=1e-4)
        assert bool(torch.isfinite(got).all())
        cur = want[:, -1].argmax(-1).numpy().astype(np.int32)
        lengths = lengths + 1
    assert kernel.launches - before[0] == 20 * cfg.num_layers
    assert decode_attention_cuda.launches == before[1]


@pytest.mark.cuda
def test_paged_engine_on_card_matches_cpu_with_preemption(cuda):
    """bf16 smoke engine on the card with a scarce pool: every request
    gets its budget, every block returns, the preemption count equals
    the CPU run's (it depends on lengths only), and the outputs equal the
    same engine's unpreempted run on the card."""
    cfg = get_smoke(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = _prompts(cfg.vocab_size, [6] * 5, 47)
    counts, outs = [], []
    for dev, num_blocks in (("cpu", 9), (cuda, 9), (cuda, 64)):
        eng = Engine(model, {k: v.to(dev) for k, v in params.items()},
                     max_batch=3, max_len=32, paged=True, block_size=4,
                     num_blocks=num_blocks, prefill_chunk=4)
        got, _ = _run(eng, prompts, [14] * 5)
        assert [len(o) for o in got] == [14] * 5
        assert eng.free_blocks == eng.num_blocks
        counts.append(eng.num_preemptions)
        outs.append(got)
    assert counts[0] == counts[1] >= 1 and counts[2] == 0
    assert outs[1] == outs[2]


@pytest.mark.cuda
def test_ring_paged_engine_on_card_matches_cpu(cuda, monkeypatch):
    """The windowed smoke model (window 16, blocks of 8) in f32, TF32 off,
    served from the ring on the card and on the CPU: short rows decode
    against tables narrower than the ring, long ones wrap; the tokens are
    equal, the ring kernel launches once per layer per decode step, and
    every block returns."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    model = build_model(cfg, window=WINDOW)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = _prompts(cfg.vocab_size, (5, 23, 11, 3), 44)
    budgets = [30, 30, 12, 25]
    outs = []
    for dev in ("cpu", cuda):
        eng = Engine(model, {k: v.to(dev) for k, v in params.items()},
                     max_batch=2, max_len=128, cache_dtype=torch.float32,
                     paged=True, block_size=8, num_blocks=24,
                     prefill_chunk=32)
        before = decode_attention_ring_cuda.launches
        outs.append(_run(eng, prompts, budgets)[0])
        assert eng.free_blocks == eng.num_blocks
    assert (decode_attention_ring_cuda.launches - before
            == cfg.num_layers * eng.stats["decode_steps"])
    assert outs[0] == outs[1]
