"""Overlapped admission in the port (the fused mixed decode + prefill
step on the arena, the paged pool and the ring pool, and the scheduler
that drives it) against the JAX reference, at smoke size on the CPU.

Both sides start from the reference's parameters (`params_from_jax`) and,
for the model entry points, from the same arena or pool (`arena_from_jax`,
`pool_from_jax`), and run in f32: caches agree to atol 1e-5 (only the
order of f32 sums differs), tokens are equal. The engine tests drive the
reference's `_STAGGER` workload (`tests/test_server.py`), arrivals
staggered so that admissions land while other rows decode. The bf16
tests hold the smoke config's own compute dtype against the reference up
to a stated fraction of the largest |logit|, with the port's f32 path as
the control. The `cuda` tests run the mixed steps through the kernels on
the card.
"""
import dataclasses
import math
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
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    arena_from_jax, params_from_jax, pool_from_jax)
from repro_torch.serve import Engine, bucket_length  # noqa: E402
from repro_torch.serve.engine import FamilyCaps, probe_family_caps  # noqa: E402
from test_torch_rwkv import assert_tokens_equal_up_to_ties  # noqa: E402

ARCH = "qwen2-0.5b"
ATOL = 1e-5
WINDOW = 16
# (prompt_len, budget, arrival_step), as tests/test_server.py's _STAGGER
_STAGGER = [(9, 6, 0), (5, 8, 0), (7, 5, 2), (4, 7, 3), (6, 6, 5)]


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
    from repro.serve.engine import probe_family_caps as jax_probe
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke=jax_get_smoke,
                                 build_model=jax_build_model,
                                 Engine=JaxEngine, probe=jax_probe)


def _models(jx, window, compute_dtype="float32"):
    jcfg = dataclasses.replace(jx.get_smoke(ARCH),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype=compute_dtype)
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


def _leaves_close(jcaches, tcaches, skip_null=False):
    """Every cache leaf to ATOL (ptr exactly); skip_null leaves a pool's
    block 0 out (the dead rows' writes, whose winner is undefined)."""
    lo = 1 if skip_null else 0
    for name, want in jcaches[0].items():
        want, got = np.asarray(want), tcaches[0][name].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got[:, lo:], want[:, lo:], rtol=0,
                                   atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# (a) capabilities and the engine's resolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,window,capacity,want", [
    ("qwen2-0.5b", 0, 32, (True, True, True, True)),
    ("qwen2-0.5b", WINDOW, 32, (False, True, True, True)),
    ("rwkv6-1.6b", 0, 32, (False, False, False, False)),
    ("recurrentgemma-2b", 0, 64, (False, False, False, False)),
], ids=["qwen2", "qwen2-windowed", "rwkv6", "recurrentgemma"])
def test_family_capability_flags(jx, arch, window, capacity, want):
    """The port probes the reference's four flags, and the engine resolves
    its backend and scheduler from them: overlap on the arena only where
    prompts pad, on the pool wherever it pages, never for a recurrent
    family (which serves serialized from the arena, without an error)."""
    tmodel = build_model(get_smoke(arch), window=window)
    jmodel = jx.build_model(jx.get_smoke(arch), window=window)
    caps = probe_family_caps(tmodel, capacity=capacity)
    jcaps = jx.probe(jmodel, max_batch=2, capacity=capacity)
    assert dataclasses.astuple(caps) == dataclasses.astuple(jcaps) == want
    assert caps == FamilyCaps(*want)
    params = tmodel.init(torch.Generator().manual_seed(0))
    for paged in (False, True):
        eng = Engine(tmodel, params, max_batch=2, max_len=capacity,
                     paged=paged)
        overlap = caps.supports_mixed_step and (
            eng.paged or caps.pad_prompts)
        assert eng.paged == (paged and caps.supports_paging)
        assert eng.overlap == overlap
        assert eng.stats["overlap_mode"] == ("fused" if overlap else "")
        off = Engine(tmodel, params, max_batch=2, max_len=capacity,
                     paged=paged, overlap=False)
        assert not off.overlap and off.stats["overlap_mode"] == ""


def test_overlap_mode_validated(served):
    _, _, tmodel, tparams = served
    with pytest.raises(ValueError, match="overlap_mode"):
        Engine(tmodel, tparams, max_batch=1, max_len=16,
               overlap_mode="eager")
    eng = Engine(tmodel, tparams, max_batch=1, max_len=16,
                 overlap_mode="async")
    assert eng.overlap and eng.stats["overlap_mode"] == "async"


def test_recurrent_models_have_no_mixed_step():
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        model = build_model(get_smoke(arch))
        assert model.mixed_step_tokens is None
        assert model.mixed_step_paged_tokens is None


# ---------------------------------------------------------------------------
# (b) the mixed steps against the reference's, on the same state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, WINDOW], ids=["arena", "ring-arena"])
def test_mixed_step_tokens_matches_reference(jx, served, served_windowed,
                                             window):
    """Slots 0 and 2 prefilled and decoded 3 steps; then the mixed step
    decodes them and prefills a prompt into slot 1, whose row held an
    earlier request (its garbage decode insert lands first, then the
    prompt's row over it): next tokens, positions, the prompt's token and
    every arena leaf equal the reference's; two more mixed steps follow
    over a slot in the middle of the batch."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served_windowed if window else served
    slots, cap = 3, 32
    jarena = jmodel.init_arena(slots, cap, dtype=jnp.float32)
    tarena = arena_from_jax(jax.device_get(jarena))
    prompts = _prompts(tmodel.cfg.vocab_size, (11, 6, 4, 9, 20), 50)

    def padded(prompt):
        sp = bucket_length(len(prompt), 8) if not window else len(prompt)
        toks = np.zeros((1, sp), np.int32)
        toks[0, :len(prompt)] = prompt
        return toks

    pos = np.zeros(slots, np.int32)
    for slot, prompt in zip((0, 1, 2), prompts[:3]):
        toks = padded(prompt)
        jt, jarena = jmodel.prefill_into_slot_token(
            jparams, jnp.asarray(toks), jnp.int32(len(prompt)),
            jnp.int32(slot), jarena)
        tt, tarena = tmodel.prefill_into_slot_token(
            tparams, torch.from_numpy(toks), len(prompt), slot, tarena)
        assert int(tt) == int(jt)
        pos[slot] = len(prompt)
    cur = _prompts(tmodel.cfg.vocab_size, (slots,), 51)[0]
    jcur, jpos = jnp.asarray(cur), jnp.asarray(pos)
    tcur, tpos = torch.from_numpy(cur), torch.from_numpy(pos)
    for _ in range(3):
        jcur, jarena, jpos = jmodel.decode_rows_tokens(jparams, jcur, jarena,
                                                       jpos)
        tcur, tarena, tpos = tmodel.decode_rows_tokens(tparams, tcur, tarena,
                                                       tpos)
    jmixed = jax.jit(jmodel.mixed_step_tokens)
    for prompt in prompts[2:]:      # slot 1 re-admitted three times
        toks = padded(prompt)
        jcur, jarena, jpos, jtok = jmixed(
            jparams, jcur, jarena, jpos, jnp.asarray(toks),
            jnp.int32(len(prompt)), jnp.int32(1))
        tcur, tarena, tpos, ttok = tmodel.mixed_step_tokens(
            tparams, tcur, tarena, tpos, torch.from_numpy(toks), len(prompt),
            1)
        assert tcur.dtype == tpos.dtype == ttok.dtype == torch.int32
        assert ttok.dim() == 0 and int(ttok) == int(jtok)
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        _leaves_close(jarena, tarena)
        assert int(tarena[0]["ptr"][0, 1]) == len(prompt)
        # the engine's resolution: slot 1 decodes from its prompt
        jcur = jcur.at[1].set(jtok)
        jpos = jpos.at[1].set(len(prompt))
        tcur[1], tpos[1] = ttok, len(prompt)


@pytest.mark.parametrize("window", [0, WINDOW], ids=["paged", "ring"])
def test_mixed_step_paged_tokens_matches_reference(jx, served,
                                                   served_windowed, window):
    """Rows 0 and 2 live (row 0 past the window for a ring), row 1
    streaming an 11-token prompt through chunks of 4 into its private
    table while its own table row is zero and its length 0: the first,
    middle and last chunk each ride a mixed step. Next tokens, lengths,
    the chunk's token and every real block equal the reference's."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served_windowed if window else served
    vocab, bs, nb, chunk = tmodel.cfg.vocab_size, 4, 24, 4
    jpool = jmodel.init_pool(nb, bs, dtype=jnp.float32)
    tpool = pool_from_jax(jax.device_get(jpool))
    live = _prompts(vocab, (21, 6), 52)
    stream = _prompts(vocab, (11,), 53)[0]
    w = 8
    tables = np.zeros((3, w), np.int32)
    free = iter(range(1, nb + 1))
    for row, prompt in zip((0, 2), live):
        n = -(-min(len(prompt), window or len(prompt)) // bs)
        tables[row, :n] = [next(free) for _ in range(n)]
        for i in range(-(-len(prompt) // chunk)):
            part = prompt[i * chunk:(i + 1) * chunk]
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :len(part)] = part
            _, jpool = jmodel.prefill_chunk_into_blocks_token(
                jparams, jnp.asarray(toks), jnp.int32(len(part)),
                jnp.int32(i * chunk), jnp.asarray(tables[row]), jpool)
            _, tpool = tmodel.prefill_chunk_into_blocks_token(
                tparams, torch.from_numpy(toks), len(part), i * chunk,
                torch.from_numpy(tables[row]), tpool)
    c_table = np.zeros(w, np.int32)
    c_table[:3] = [next(free) for _ in range(3)]
    lengths = np.array([21, 0, 6], np.int32)
    cur = np.array([5, 0, 9], np.int32)
    jmixed = jax.jit(jmodel.mixed_step_paged_tokens)
    for i in range(3):
        for row in (0, 2):
            p = int(lengths[row]) % (window or 1 << 30)
            if tables[row, p // bs] == 0:
                tables[row, p // bs] = next(free)
        part = stream[i * chunk:(i + 1) * chunk]
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :len(part)] = part
        jcur, jpool, jlen, jtok = jmixed(
            jparams, jnp.asarray(cur), jpool, jnp.asarray(tables),
            jnp.asarray(lengths), jnp.asarray(toks), jnp.int32(len(part)),
            jnp.int32(i * chunk), jnp.asarray(c_table))
        tcur, tpool, tlen, ttok = tmodel.mixed_step_paged_tokens(
            tparams, torch.from_numpy(cur), tpool, torch.from_numpy(tables),
            torch.from_numpy(lengths), torch.from_numpy(toks), len(part),
            i * chunk, torch.from_numpy(c_table))
        assert tcur.dtype == tlen.dtype == ttok.dtype == torch.int32
        np.testing.assert_array_equal(tcur.numpy()[[0, 2]],
                                      np.asarray(jcur)[[0, 2]])
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
        assert int(ttok) == int(jtok)
        _leaves_close(jpool, tpool, skip_null=True)
        cur, lengths = np.asarray(jcur).copy(), np.asarray(jlen).copy()
        lengths[1] = 0          # the streaming row stays dead
    if window:
        assert lengths[0] > WINDOW          # the ring wrapped


# ---------------------------------------------------------------------------
# (c, d, e) the overlapped engine
# ---------------------------------------------------------------------------


def _run_staggered(engine, vocab, snapshots=None):
    """Drive `_STAGGER` through `engine`; returns (outputs in submit
    order, final stats)."""
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, vocab, (int(n),)), int(b))
            for n, b, _ in _STAGGER]
    outs, uids, nxt, step_i = {}, [], 0, 0
    while nxt < len(reqs) or engine.num_active or engine.pending:
        assert step_i < 400, "the engine did not drain"
        while nxt < len(reqs) and _STAGGER[nxt][2] <= step_i:
            p, b = reqs[nxt]
            uids.append(engine.submit(p, max_new_tokens=b))
            nxt += 1
        for r in engine.step():
            outs[r.uid] = list(r.output)
        if snapshots is not None:
            snapshots.append(engine.stats)
        step_i += 1
    return [outs[u] for u in uids], engine.stats


_GEOMETRY = {"arena": dict(paged=False),
             "paged": dict(paged=True, num_blocks=6),
             "ring": dict(paged=True)}


def _engines(jx, models, backend, **kw):
    """(port engine, JAX engine) for `backend` with the reference test's
    geometry."""
    jmodel, jparams, tmodel, tparams = models
    geom = dict(max_batch=2, max_len=24, block_size=4, prefill_chunk=4,
                **_GEOMETRY[backend])
    port = Engine(tmodel, tparams, cache_dtype=torch.float32, **geom, **kw)
    ref = jx.Engine(jmodel, jparams, cache_dtype=jx.jnp.float32, **geom,
                    **kw)
    return port, ref


@pytest.mark.parametrize("backend", ["arena", "paged", "ring"])
def test_overlap_vs_serialized_bit_identity(jx, served, served_windowed,
                                            backend):
    """The reference's gate, on the port: the overlapped engine's tokens
    equal the port's serialized engine's and the JAX engine's at its
    default (overlap=True, fused), with preemption during overlapped
    admissions on the starved pool (num_blocks=6) in both schedulers."""
    models = served_windowed if backend == "ring" else served
    vocab = models[2].cfg.vocab_size
    ser_eng, _ = _engines(jx, models, backend, overlap=False)
    ser, st_s = _run_staggered(ser_eng, vocab)
    port, jeng = _engines(jx, models, backend)
    assert port.overlap and jeng.overlap and port.paged == jeng.paged
    ov, st_o = _run_staggered(port, vocab)
    want, st_j = _run_staggered(jeng, vocab)
    assert ov == ser == want
    assert [len(o) for o in ov] == [b for _, b, _ in _STAGGER]
    assert st_o["overlap_mode"] == st_j["overlap_mode"] == "fused"
    assert st_o["mixed_steps"] > 0 and st_o["overlapped_admissions"] > 0
    assert st_s["mixed_steps"] == st_s["overlapped_admissions"] == 0
    assert st_s["overlap_mode"] == ""
    if backend == "paged":
        assert st_s["preemptions"] > 0 and st_o["preemptions"] > 0
        assert st_o["preemptions"] == st_j["preemptions"]
    if port.paged:
        assert port.free_blocks == port.num_blocks
        assert port.prefill_shapes == {port.prefill_chunk}


@pytest.mark.parametrize("backend", ["arena", "paged"])
def test_overlap_async_mode_bit_identity(jx, served, backend):
    """overlap_mode="async" (the serialized step functions back to back,
    no fetch between them) gives the same tokens with no mixed step."""
    vocab = served[2].cfg.vocab_size
    ser_eng, _ = _engines(jx, served, backend, overlap=False)
    ser, _ = _run_staggered(ser_eng, vocab)
    port, _ = _engines(jx, served, backend, overlap_mode="async")
    ov, st = _run_staggered(port, vocab)
    assert ov == ser
    assert st["overlap_mode"] == "async"
    assert st["mixed_steps"] == 0
    assert st["overlapped_admissions"] > 0


def test_engine_stats_schema_and_monotone(jx, served):
    """Every stats key in every snapshot, counters never decrease, and
    the decode time is exactly its dispatch plus its fetch."""
    snaps = []
    port, _ = _engines(jx, served, "paged")
    _run_staggered(port, served[2].cfg.vocab_size, snapshots=snaps)
    keys = {"admissions", "admit_host_s", "prefill_wait_s",
            "decode_steps", "decode_s", "decode_dispatch_s",
            "decode_fetch_s", "topup_host_s", "h2d_uploads",
            "replayed_tokens", "mixed_steps", "overlapped_admissions",
            "decode_fetch_elems", "decode_fetch_dtype", "preemptions",
            "overlap_mode"}
    counters = keys - {"decode_fetch_elems", "decode_fetch_dtype",
                       "overlap_mode"}
    assert snaps and all(keys <= set(s) for s in snaps)
    for prev, cur in zip(snaps, snaps[1:]):
        for k in counters:
            assert cur[k] >= prev[k], f"{k} went backwards"
    last = snaps[-1]
    assert math.isclose(last["decode_s"], last["decode_dispatch_s"]
                        + last["decode_fetch_s"], rel_tol=1e-9)
    assert last["mixed_steps"] <= last["decode_steps"]
    assert last["overlapped_admissions"] <= last["admissions"]
    assert last["overlap_mode"] == "fused"
    assert last["decode_fetch_elems"] == 2
    assert last["decode_fetch_dtype"] == "int32"


@pytest.mark.parametrize("backend", ["arena", "paged"])
def test_overlapped_first_token_finishes_at_resolution(served, backend):
    """A staged admission whose first token ends it (budget 1, or EOS on
    it) finishes when it resolves, and frees its slot (and blocks) for
    the queue; outputs equal the serialized engine's."""
    _, _, tmodel, tparams = served
    prompts = _prompts(tmodel.cfg.vocab_size, (6, 5, 7, 4, 9), 54)
    geom = dict(max_batch=2, max_len=32, cache_dtype=torch.float32,
                block_size=4, prefill_chunk=4, paged=backend == "paged")

    def run(**kw):
        eng = Engine(tmodel, tparams, **geom, **kw)
        first = eng.submit(prompts[0], max_new_tokens=9)
        eng.step()
        eng.step()
        uids = [eng.submit(p, max_new_tokens=b)
                for p, b in zip(prompts[1:], (1, 4, 1, 3))]
        done = {r.uid: r.output.tolist() for r in eng.run()}
        return [done[u] for u in [first] + uids], eng

    want, _ = run(overlap=False)
    got, eng = run()
    assert got == want
    assert eng.stats["overlapped_admissions"] > 0
    if eng.paged:
        assert eng.free_blocks == eng.num_blocks
    # EOS on the first token ends the request at its resolution too
    eos = Engine(tmodel, tparams, **geom)
    eos.submit(prompts[0], max_new_tokens=9)
    eos.step()
    uid = eos.submit(prompts[1], max_new_tokens=6, eos_id=want[1][0])
    done = {r.uid: r.output.tolist() for r in eos.run()}
    assert done[uid] == want[1][:1]


@pytest.mark.parametrize("preemption", ["recompute", "reserve"])
def test_overlapped_pool_fifo_fairness_and_uid_order(served, preemption):
    """Under pool pressure with overlapped admission: the queue stays
    uid-sorted at every step, never-preempted requests finish in FIFO
    order, every block returns, "reserve" never preempts, and the tokens
    equal the serialized engine's."""
    _, _, tmodel, tparams = served
    prompts = _prompts(tmodel.cfg.vocab_size, [5] * 6, 33)
    geom = dict(max_batch=3, max_len=32, cache_dtype=torch.float32,
                paged=True, block_size=4, num_blocks=8, prefill_chunk=4,
                preemption=preemption)
    ser = Engine(tmodel, tparams, overlap=False, **geom)
    suids = [ser.submit(p, max_new_tokens=16) for p in prompts]
    want = {r.uid: r.output.tolist() for r in ser.run()}
    eng = Engine(tmodel, tparams, **geom)
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
    assert {r.uid: r.output.tolist() for r in done} == {
        u: want[s] for u, s in zip(uids, suids)}
    never = [r.uid for r in done if r.preemptions == 0]
    assert never == sorted(never)
    # "reserve" holds one worst case (5 of 8 blocks) at a time: each
    # admission finds no decode row to ride
    assert (eng.stats["mixed_steps"] > 0) == (preemption == "recompute")
    assert (eng.num_preemptions >= 1) == (preemption == "recompute")
    assert eng.free_blocks == eng.num_blocks


def test_overlapped_preemption_count_depends_on_lengths_only(served):
    """The overlapped scheduler's block accounting sees lengths, never
    logits: two runs of one workload with different weights preempt the
    same requests at the same steps (what chip_smoke.py predicts on the
    CPU for the card, whose serving runs at this default)."""
    _, _, tmodel, tparams = served
    other = {k: v * 0.5 for k, v in tparams.items()}
    prompts = _prompts(tmodel.cfg.vocab_size, [6] * 5, 47)
    counts = []
    for params in (tparams, other):
        eng = Engine(tmodel, params, max_batch=3, max_len=32,
                     cache_dtype=torch.float32, paged=True, block_size=4,
                     num_blocks=9, prefill_chunk=4)
        uids = [eng.submit(p, max_new_tokens=14) for p in prompts]
        done = {r.uid: r for r in eng.run()}
        st = eng.stats
        counts.append((eng.num_preemptions,
                       [done[u].preemptions for u in uids],
                       st["decode_steps"], st["replayed_tokens"],
                       st["mixed_steps"], st["overlapped_admissions"]))
    assert counts[0] == counts[1] and counts[0][0] >= 1
    assert counts[0][4] > 0


def test_serve_cli_overlapped_on_cpu(capsys):
    """The CLI runs the engine's default: overlapped for qwen2, with the
    serialized engine's tokens, on the arena and the pool."""
    base = ["--arch", ARCH, "--smoke", "--requests", "6", "--max-batch", "3",
            "--prompt-len", "8", "--new-tokens", "12", "--mixed",
            "--device", "cpu"]
    arena = serve_cli.main(base)
    paged = serve_cli.main(base + ["--paged", "--block-size", "4"])
    for out in (arena, paged):
        st = out["stats"]
        assert st["overlap_mode"] == "fused" and st["mixed_steps"] > 0
        assert st["overlapped_admissions"] > 0
    assert paged["outputs"] == arena["outputs"]
    assert "overlap_mode 'fused'" in capsys.readouterr().out
    args = serve_cli.parse_args(base)
    _, cfg, model, params = serve_cli.build(args)
    prompts, budgets = serve_cli.workload(args, cfg.vocab_size)
    eng = Engine(model, params, max_batch=3, max_len=arena["max_len"],
                 overlap=False)
    uids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    done = {r.uid: r.output.tolist() for r in eng.run()}
    assert [done[u] for u in uids] == arena["outputs"]


# ---------------------------------------------------------------------------
# bf16 (the smoke config's own compute dtype) against the reference
# ---------------------------------------------------------------------------

# Measured on the CPU at smoke size (qwen2: arena prefill into two slots
# and 8 decode steps, a mixed step, a pool's chunked prefill, 8 paged
# decode steps and a paged mixed step): the port's bf16 logits lie within
# 0.0112 of max |logit| of the reference's bf16 logits, its f32 path (the
# control: the whole stack in another precision) within 0.0154. The limit
# sits between the two; a greedy token may flip only where the
# reference's top two logits lie within it, in at most one request.
BF16_LOGIT_RTOL = 0.014
BF16_MAX_FLIPS = 1


@pytest.fixture(scope="module")
def served_bf16(jx):
    """The reference in the smoke config's bf16 compute, and the port in
    bf16 and (the control) in f32, from the reference's parameters."""
    jcfg, tcfg = jx.get_smoke(ARCH), get_smoke(ARCH)
    assert jcfg.compute_dtype == tcfg.compute_dtype == "bfloat16"
    jmodel, jparams, tmodel, tparams = _models(jx, 0, "bfloat16")
    f32 = build_model(dataclasses.replace(tcfg, compute_dtype="float32"))
    return jmodel, jparams, tmodel, tparams, f32


def _serving_logit_errors(jx, jmodel, jparams, tmodel, tparams,
                          cache_dtype):
    """max |port - reference| / max |reference| over the logits of every
    serving entry point on one run (the port's caches in `cache_dtype`,
    the reference's in bf16): arena prefill into slots 0 and 2 and 8
    decode steps, then a mixed step prefilling slot 1 against the
    reference's decode step and prefill (the reference's mixed step
    computes exactly those); then the pool's chunked prefill, 8 paged
    decode steps and a paged mixed step likewise. Each side continues
    from the reference's tokens."""
    jax, jnp = jx.jax, jx.jnp
    vocab = tmodel.cfg.vocab_size
    prompts = _prompts(vocab, (11, 6, 13), 55)
    worst = 0.0

    def err(tl, jl, rows=None):
        nonlocal worst
        want = np.asarray(jl, np.float32)
        got = tl.float().numpy()
        if rows is not None:
            want, got = want[rows], got[rows]
        worst = max(worst, float(np.abs(got - want).max())
                    / float(np.abs(want).max()))

    # the arena
    jarena = jmodel.init_arena(3, 32, dtype=jnp.bfloat16)
    tarena = tmodel.init_arena(3, 32, dtype=cache_dtype)
    pos = np.zeros(3, np.int32)
    cur = np.zeros(3, np.int32)
    for slot, prompt in zip((0, 2), prompts[:2]):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(prompt)] = prompt
        jl, jarena = jmodel.prefill_into_slot(
            jparams, jnp.asarray(toks), jnp.int32(len(prompt)),
            jnp.int32(slot), jarena)
        tl, tarena = tmodel.prefill_into_slot(
            tparams, torch.from_numpy(toks), len(prompt), slot, tarena)
        err(tl, jl)
        pos[slot], cur[slot] = len(prompt), int(jnp.argmax(jl[0, -1]))
    for _ in range(8):
        jl, jarena = jmodel.decode_rows(jparams, jnp.asarray(cur)[:, None],
                                        jarena, jnp.asarray(pos))
        tl, tarena = tmodel.decode_rows(tparams,
                                        torch.from_numpy(cur)[:, None],
                                        tarena, torch.from_numpy(pos))
        err(tl, jl, [0, 2])
        cur, pos = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32), pos + 1
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = prompts[2]
    tl_d, tl_p, _ = TF.mixed_step(tmodel.cfg, tparams, torch.from_numpy(cur),
                                  tarena, torch.from_numpy(pos),
                                  torch.from_numpy(toks), 13, 1)
    jl, jarena = jmodel.decode_rows(jparams, jnp.asarray(cur)[:, None],
                                    jarena, jnp.asarray(pos))
    err(tl_d, jl, [0, 2])
    jl, _ = jmodel.prefill_into_slot(jparams, jnp.asarray(toks),
                                     jnp.int32(13), jnp.int32(1), jarena)
    err(tl_p, jl)

    # the pool (block size 4, chunks of 8)
    jpool = jmodel.init_pool(16, 4, dtype=jnp.bfloat16)
    tpool = tmodel.init_pool(16, 4, dtype=cache_dtype)
    tables = np.zeros((3, 8), np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[2, :2] = [7, 1]
    lengths = np.zeros(3, np.int32)
    for row, prompt in zip((0, 2), prompts[:2]):
        for start in range(0, len(prompt), 8):
            part = prompt[start:start + 8]
            toks = np.zeros((1, 8), np.int32)
            toks[0, :len(part)] = part
            jl, jpool = jmodel.prefill_chunk_into_blocks(
                jparams, jnp.asarray(toks), jnp.int32(len(part)),
                jnp.int32(start), jnp.asarray(tables[row]), jpool)
            tl, tpool = tmodel.prefill_chunk_into_blocks(
                tparams, torch.from_numpy(toks), len(part), start,
                torch.from_numpy(tables[row]), tpool)
            err(tl, jl)
        lengths[row], cur[row] = len(prompt), int(jnp.argmax(jl[0, -1]))
    free = iter([3, 4, 6, 8, 10, 11])
    for _ in range(8):
        for row in (0, 2):
            if tables[row, lengths[row] // 4] == 0:
                tables[row, lengths[row] // 4] = next(free)
        jl, jpool = jmodel.decode_rows_paged(
            jparams, jnp.asarray(cur)[:, None], jpool, jnp.asarray(tables),
            jnp.asarray(lengths))
        tl, tpool = tmodel.decode_rows_paged(
            tparams, torch.from_numpy(cur)[:, None], tpool,
            torch.from_numpy(tables), torch.from_numpy(lengths))
        err(tl, jl, [0, 2])
        cur = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
        lengths = lengths + 1
        lengths[1] = 0
    c_table = np.array([12, 13, 0, 0, 0, 0, 0, 0], np.int32)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :8] = prompts[2][:8]
    tl_d, tl_c, _ = TF.mixed_step_paged(
        tmodel.cfg, tparams, torch.from_numpy(cur), tpool,
        torch.from_numpy(tables), torch.from_numpy(lengths),
        torch.from_numpy(toks), 8, 0, torch.from_numpy(c_table))
    jl, jpool = jmodel.decode_rows_paged(
        jparams, jnp.asarray(cur)[:, None], jpool, jnp.asarray(tables),
        jnp.asarray(lengths))
    err(tl_d, jl, [0, 2])
    jl, _ = jmodel.prefill_chunk_into_blocks(
        jparams, jnp.asarray(toks), jnp.int32(8), jnp.int32(0),
        jnp.asarray(c_table), jpool)
    err(tl_c, jl)
    return worst


def test_bf16_serving_logits_match_reference(jx, served_bf16):
    """bf16 logits of the arena, pool and mixed steps within
    BF16_LOGIT_RTOL of max |logit| of the reference's; the port's f32
    path, the control, lies outside it."""
    jmodel, jparams, tmodel, tparams, f32 = served_bf16
    got = _serving_logit_errors(jx, jmodel, jparams, tmodel, tparams,
                                torch.bfloat16)
    control = _serving_logit_errors(jx, jmodel, jparams, f32, tparams,
                                    torch.float32)
    # the limit tells the precisions apart: bf16 inside, f32 outside
    assert got <= BF16_LOGIT_RTOL < control, (got, control)


@pytest.mark.parametrize("backend", ["arena", "paged"])
def test_bf16_engine_tokens_match_reference_up_to_ties(jx, served_bf16,
                                                       backend):
    """The bf16 engines at their default (overlapped) on a longer
    workload: equal tokens, or a first difference at a reference
    near-tie."""
    jnp = jx.jnp
    jmodel, jparams, tmodel, tparams, _ = served_bf16
    workload = [(5, 6), (11, 14), (3, 9), (8, 1), (14, 5), (2, 12), (9, 4)]
    prompts = _prompts(tmodel.cfg.vocab_size, [n for n, _ in workload], 56)
    budgets = [b for _, b in workload]
    geom = dict(max_batch=3, max_len=32, paged=backend == "paged",
                block_size=4, prefill_chunk=8)

    def run(eng):
        uids = [eng.submit(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        done = {r.uid: r.output.tolist() for r in eng.run()}
        return [done[u] for u in uids], eng.stats

    outs, st = run(Engine(tmodel, tparams, cache_dtype=torch.bfloat16,
                          **geom))
    jouts, jst = run(jx.Engine(jmodel, jparams, cache_dtype=jnp.bfloat16,
                               **geom))
    assert st["mixed_steps"] > 0 and jst["mixed_steps"] > 0

    def ref_logits(seq):
        jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(seq[None],
                                                               jnp.int32)},
                               cache_dtype=jnp.bfloat16)
        return jl[0, -1]

    assert_tokens_equal_up_to_ties(prompts, outs, jouts, ref_logits,
                                   BF16_LOGIT_RTOL, BF16_MAX_FLIPS)


# ---------------------------------------------------------------------------
# (f) on the card (no JAX): the mixed steps through the CUDA kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_model(window, dtype):
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype=dtype)
    return build_model(cfg, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["arena", "paged", "ring"])
def test_mixed_steps_on_card_match_cpu(cuda, monkeypatch, backend):
    """Smoke config in f32 (TF32 off), one set of parameters: two live
    rows, then mixed steps prefilling the middle slot (the arena: three
    whole prompts; the pool: three chunks of one prompt) through the
    kernels on the card and the plain versions on the CPU. Logits within
    1e-4 (f32 sums in another order), equal greedy tokens, and each layer
    launches the decode half's kernel and, on the arena, the flash kernel
    once a mixed step."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = _card_model(WINDOW if backend == "ring" else 0, "float32")
    cfg = model.cfg
    cpu = model.init(torch.Generator().manual_seed(0))
    prompts = _prompts(cfg.vocab_size, (11, 6, 4, 9, 13), 57)
    devs = (torch.device("cpu"), cuda)
    params = [{k: v.to(d) for k, v in cpu.items()} for d in devs]
    counters = (flash_attention_cuda, decode_attention_cuda,
                decode_attention_paged_cuda, decode_attention_ring_cuda)
    before = [c.launches for c in counters]
    cur = np.array([3, 0, 5], np.int32)
    if backend == "arena":
        arenas = [model.init_arena(3, 32, dtype=torch.float32, device=d)
                  for d in devs]
        pos = np.array([11, 0, 6], np.int32)
        for slot, prompt in zip((0, 2), prompts[:2]):
            toks = np.zeros((1, 16), np.int32)
            toks[0, :len(prompt)] = prompt
            for d, p, a in zip(devs, params, arenas):
                model.prefill_into_slot(p, torch.from_numpy(toks).to(d),
                                        len(prompt), slot, a)
        before = [c.launches for c in counters]     # the mixed steps only
        for prompt in prompts[2:]:
            toks = np.zeros((1, bucket_length(len(prompt), 8)), np.int32)
            toks[0, :len(prompt)] = prompt
            (want_d, want_p, _), (got_d, got_p, _) = [TF.mixed_step(
                cfg, p, torch.from_numpy(cur).to(d), a,
                torch.from_numpy(pos).to(d), torch.from_numpy(toks).to(d),
                len(prompt), 1) for d, p, a in zip(devs, params, arenas)]
            for want, got in ((want_d[[0, 2]], got_d[[0, 2]]),
                              (want_p, got_p)):
                torch.testing.assert_close(got.cpu(), want, rtol=0,
                                           atol=1e-4)
                assert bool((got.cpu().argmax(-1) == want.argmax(-1)).all())
            cur = want_d[:, -1].argmax(-1).numpy().astype(np.int32)
            cur[1] = int(want_p[0, -1].argmax())
            pos = pos + 1
            pos[1] = len(prompt)
        want = (3 * cfg.num_layers, 3 * cfg.num_layers, 0, 0)
    else:
        window = WINDOW if backend == "ring" else 0
        pools = [model.init_pool(24, 4, dtype=torch.float32, device=d)
                 for d in devs]
        tables = np.zeros((3, 8), np.int32)
        tables[0, :3] = [5, 2, 9]
        tables[2, :2] = [7, 1]
        lengths = np.array([11, 0, 6], np.int32)
        for row, prompt in zip((0, 2), prompts[:2]):
            toks = np.zeros((1, 16), np.int32)
            toks[0, :len(prompt)] = prompt
            for d, p, pool in zip(devs, params, pools):
                model.prefill_chunk_into_blocks(
                    p, torch.from_numpy(toks).to(d), len(prompt), 0,
                    torch.from_numpy(tables[row]).to(d), pool)
        c_table = np.array([12, 13, 14, 0], np.int32)
        stream = prompts[4]
        free = iter([3, 4, 6, 8, 10, 11])
        for i in range(3):
            for row in (0, 2):
                p_ = int(lengths[row]) % (window or 1 << 30)
                if tables[row, p_ // 4] == 0:
                    tables[row, p_ // 4] = next(free)
            part = stream[i * 4:(i + 1) * 4]
            toks = np.zeros((1, 4), np.int32)
            toks[0, :len(part)] = part
            (want_d, want_c, _), (got_d, got_c, _) = [TF.mixed_step_paged(
                cfg, p, torch.from_numpy(cur).to(d), pool,
                torch.from_numpy(tables).to(d),
                torch.from_numpy(lengths).to(d), torch.from_numpy(toks).to(d),
                len(part), i * 4, torch.from_numpy(c_table).to(d),
                window=window) for d, p, pool in zip(devs, params, pools)]
            for want, got in ((want_d[[0, 2]], got_d[[0, 2]]),
                              (want_c, got_c)):
                torch.testing.assert_close(got.cpu(), want, rtol=0,
                                           atol=1e-4)
                assert bool((got.cpu().argmax(-1) == want.argmax(-1)).all())
            cur = want_d[:, -1].argmax(-1).numpy().astype(np.int32)
            lengths = lengths + 1
            lengths[1] = 0
        n = 3 * cfg.num_layers
        want = (0, 0, 0, n) if window else (0, 0, n, 0)
    assert tuple(c.launches - b for c, b in zip(counters, before)) == want


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["arena", "paged", "ring"])
def test_overlapped_engine_on_card_equals_serialized(cuda, backend):
    """bf16 smoke engines on the card, on `_STAGGER` (the pool starved to
    6 blocks, so it preempts during overlapped admissions): the
    overlapped engine's tokens equal the serialized engine's, mixed steps
    ran, and the kernels launched once per layer per decode step (and,
    on the arena, per admission)."""
    model = _card_model(WINDOW if backend == "ring" else 0, "bfloat16")
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    geom = dict(max_batch=2, max_len=24, block_size=4, prefill_chunk=4,
                **_GEOMETRY[backend])
    outs = {}
    for overlap in (False, True):
        eng = Engine(model, params, overlap=overlap, **geom)
        counters = (flash_attention_cuda, decode_attention_cuda,
                    decode_attention_ring_cuda if backend == "ring"
                    else decode_attention_paged_cuda)
        before = [c.launches for c in counters]
        outs[overlap], st = _run_staggered(eng, model.cfg.vocab_size)
        flash, decode, paged = (c.launches - b
                                for c, b in zip(counters, before))
        n = model.cfg.num_layers
        if eng.paged:
            assert (flash, decode, paged) == (0, 0, n * st["decode_steps"])
        else:
            assert (flash, decode, paged) == (n * st["admissions"],
                                              n * st["decode_steps"], 0)
        assert (st["mixed_steps"] > 0) == overlap
    assert outs[True] == outs[False]
