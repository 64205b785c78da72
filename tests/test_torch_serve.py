"""Parity of the port's serving path (the arena engine; its overlapped
scheduler is held in tests/test_torch_mixed.py) with the JAX reference, at
smoke size on the CPU.

Both sides start from the reference's parameters (`params_from_jax`) and,
for the model entry points, from the same arena (`arena_from_jax`), and
run in f32 (compute and cache). The port's prefill and decode attention
go through `kernels.ops`, which on the CPU run the kernels' plain
versions; the reference's model path computes attention with jnp. Logits
and arena leaves agree to atol 1e-5 (only the order of f32 sums differs),
and greedy tokens are equal.
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
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    arena_from_jax, params_from_jax)
from repro_torch.serve import Engine, bucket_length  # noqa: E402

ARCH = "qwen2-0.5b"
ATOL = 1e-5
SLOTS, CAPACITY = 3, 32
# (prompt length, budget) per request: more requests than slots, mixed
# lengths and budgets, every plen + budget within the 32-token capacity
WORKLOAD = [(5, 6), (11, 3), (3, 9), (8, 1), (14, 5), (2, 7), (9, 4)]


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
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke=jax_get_smoke,
                                 build_model=jax_build_model,
                                 Engine=JaxEngine)


@pytest.fixture(scope="module")
def served(jx):
    jcfg = dataclasses.replace(jx.get_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jmodel, tmodel = jx.build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    tparams = params_from_jax(jx.jax.device_get(jparams))
    return jmodel, jparams, tmodel, tparams


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (plen,)).astype(np.int32)
            for plen, _ in WORKLOAD]


def _padded(prompt):
    toks = np.zeros((1, bucket_length(len(prompt), 8)), np.int32)
    toks[0, :len(prompt)] = prompt
    return toks


def _assert_arena_equal(jarena, tarena):
    for name, want in jarena[0].items():
        want, got = np.asarray(want), tarena[0][name].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name)


def _fill_three_slots(jx, served):
    """Prefill three prompts into slots 2, 0, 1 of both arenas; returns
    the arenas, the prompts' lengths by slot and the logits pairs."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    jarena = jmodel.init_arena(SLOTS, CAPACITY, dtype=jnp.float32)
    tarena = arena_from_jax(jax.device_get(jarena))
    prompts = _prompts(jmodel.cfg.vocab_size)
    lengths = np.zeros(SLOTS, np.int32)
    logits = []
    for slot, prompt in zip((2, 0, 1), prompts[:3]):
        toks = _padded(prompt)
        jl, jarena = jmodel.prefill_into_slot(
            jparams, jnp.asarray(toks), jnp.int32(len(prompt)),
            jnp.int32(slot), jarena)
        tl, tarena = tmodel.prefill_into_slot(
            tparams, torch.from_numpy(toks), len(prompt), slot, tarena)
        lengths[slot] = len(prompt)
        logits.append((np.asarray(jl), tl.numpy()))
    return jarena, tarena, lengths, logits


def test_arena_from_jax_round_trip(jx, served):
    jax, jnp = jx.jax, jx.jnp
    jmodel, _, tmodel, _ = served
    jarena = jax.device_get(jmodel.init_arena(SLOTS, CAPACITY,
                                              dtype=jnp.float32))
    (tarena,) = arena_from_jax(jarena)
    cfg = tmodel.cfg
    shape = (cfg.num_layers, SLOTS, CAPACITY, cfg.num_kv_heads, cfg.head_dim)
    assert set(tarena) == {"k", "v", "ptr"}
    for name in ("k", "v"):
        assert tuple(tarena[name].shape) == shape == jarena[0][name].shape
        assert tarena[name].dtype == torch.float32
    assert tarena["ptr"].dtype == torch.int32
    assert tuple(tarena["ptr"].shape) == (cfg.num_layers, SLOTS)
    # the port's own arena has the same leaves
    (own,) = tmodel.init_arena(SLOTS, CAPACITY, dtype=torch.float32)
    for name in own:
        assert own[name].shape == tarena[name].shape
        assert own[name].dtype == tarena[name].dtype
    # bf16 leaves convert exactly
    jb = jax.device_get(jmodel.init_arena(1, 8, dtype=jnp.bfloat16))
    jb[0]["k"] = jb[0]["k"] + jnp.bfloat16(1.5)
    (tb,) = arena_from_jax(jb)
    assert tb["k"].dtype == torch.bfloat16 and bool((tb["k"] == 1.5).all())


def test_prefill_into_slot_matches_reference(jx, served):
    jarena, tarena, lengths, logits = _fill_three_slots(jx, served)
    for jl, tl in logits:
        assert tl.shape == jl.shape == (1, 1, served[0].cfg.vocab_size)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    _assert_arena_equal(jarena, tarena)
    assert tarena[0]["ptr"][:, [2, 0, 1]].tolist()[0] == [5, 11, 3]


def test_decode_rows_match_reference_past_the_ring(jx, served):
    """Rows at three depths decode 26 steps: row 0 (11 tokens in) passes
    the 32-slot ring's capacity at step 21 and evicts its oldest tokens."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    jarena, tarena, lengths, _ = _fill_three_slots(jx, served)
    rng = np.random.default_rng(1)
    cur = rng.integers(0, jmodel.cfg.vocab_size, SLOTS).astype(np.int32)
    pos = lengths.copy()
    jdecode = jax.jit(jmodel.decode_rows)
    for _ in range(26):
        jl, jarena = jdecode(jparams, jnp.asarray(cur)[:, None], jarena,
                             jnp.asarray(pos))
        tl, tarena = tmodel.decode_rows(tparams, torch.from_numpy(cur)[:, None],
                                        tarena, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        want = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), want)
        cur, pos = want, pos + 1
    assert pos.max() > CAPACITY
    _assert_arena_equal(jarena, tarena)


def test_token_variants_match_reference(jx, served):
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    jarena = jmodel.init_arena(SLOTS, CAPACITY, dtype=jnp.float32)
    tarena = arena_from_jax(jax.device_get(jarena))
    pos = np.zeros(SLOTS, np.int32)
    cur = np.zeros(SLOTS, np.int32)
    for slot, prompt in enumerate(_prompts(jmodel.cfg.vocab_size, 2)[:3]):
        toks = _padded(prompt)
        jt, jarena = jmodel.prefill_into_slot_token(
            jparams, jnp.asarray(toks), jnp.int32(len(prompt)),
            jnp.int32(slot), jarena)
        tt, tarena = tmodel.prefill_into_slot_token(
            tparams, torch.from_numpy(toks), len(prompt), slot, tarena)
        assert tt.dtype == torch.int32 and tt.dim() == 0
        assert int(tt) == int(jt)
        pos[slot], cur[slot] = len(prompt), int(jt)
    jcur, jpos = jnp.asarray(cur), jnp.asarray(pos)
    tcur, tpos = torch.from_numpy(cur), torch.from_numpy(pos)
    jdecode = jax.jit(jmodel.decode_rows_tokens)
    for _ in range(6):
        jcur, jarena, jpos = jdecode(jparams, jcur, jarena, jpos)
        tcur, tarena, tpos = tmodel.decode_rows_tokens(tparams, tcur, tarena,
                                                       tpos)
        assert tcur.dtype == torch.int32 and tpos.dtype == torch.int32
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_prefill_and_decode_step_match_reference(jx, served):
    """The unbatched loop: prefill a batch of two prompts into caches with
    room to decode, then decode_step at one shared position."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jmodel.cfg.vocab_size, (2, 7)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                cache_dtype=jnp.float32, cache_len=12)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                cache_dtype=torch.float32, cache_len=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    _assert_arena_equal(jcache, tcache)
    cur = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    jdecode = jax.jit(jmodel.decode_step)
    for position in range(7, 12):
        jl, jcache = jdecode(jparams, jnp.asarray(cur), jcache,
                             jnp.int32(position))
        tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(cur),
                                        tcache, position)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        cur = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    _assert_arena_equal(jcache, tcache)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _run(engine, prompts, budgets, eos=None):
    uids = [engine.submit(p, max_new_tokens=b, eos_id=eos)
            for p, b in zip(prompts, budgets)]
    done = {r.uid: r for r in engine.run()}
    return [done[u].output.tolist() for u in uids]


def _port_engine(served, max_batch=SLOTS, **kw):
    _, _, tmodel, tparams = served
    return Engine(tmodel, tparams, max_batch=max_batch, max_len=CAPACITY,
                  cache_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def port_outputs(served):
    """The serialized scheduler's run (its accounting is checked below;
    the overlapped engine's is in tests/test_torch_mixed.py)."""
    prompts = _prompts(served[0].cfg.vocab_size)
    budgets = [b for _, b in WORKLOAD]
    eng = _port_engine(served, overlap=False)
    outs = _run(eng, prompts, budgets)
    return prompts, budgets, outs, eng


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serialized", "jax-default-overlap"])
def test_engine_matches_jax_engine(jx, served, port_outputs, overlap):
    jmodel, jparams, _, _ = served
    prompts, budgets, outs, _ = port_outputs
    jeng = jx.Engine(jmodel, jparams, max_batch=SLOTS, max_len=CAPACITY,
                     cache_dtype=jx.jnp.float32, overlap=overlap)
    assert jeng.overlap == overlap
    assert outs == _run(jeng, prompts, budgets)
    assert [len(o) for o in outs] == budgets


def test_engine_output_equals_request_served_alone(served, port_outputs):
    prompts, budgets, outs, _ = port_outputs
    for prompt, budget, out in zip(prompts, budgets, outs):
        assert _run(_port_engine(served), [prompt], [budget]) == [out]


def test_engine_stats_and_fetch_contract(port_outputs):
    _, budgets, _, eng = port_outputs
    st = eng.stats
    assert st["admissions"] == len(budgets)
    assert st["decode_fetch_elems"] == SLOTS
    assert st["decode_fetch_dtype"] == "int32"
    assert st["preemptions"] == 0 and st["overlap_mode"] == ""
    assert st["decode_steps"] > 0
    # mirrors re-upload only on admission / first-token rounds
    assert st["h2d_uploads"] <= 2 * st["admissions"]
    assert eng.prefill_shapes <= {8, 16}


def test_engine_eos_on_prefill_token_frees_the_slot(served):
    """EOS emitted by the prefill itself finishes the request during
    admission; the slot is reused by the next request in the same step
    (the serialized scheduler's admission rounds; the overlapped one
    resolves first tokens a step later, tests/test_torch_mixed.py)."""
    vocab = served[0].cfg.vocab_size
    rng = np.random.default_rng(16)
    prompt = rng.integers(0, vocab, (6,))
    (first,) = _run(_port_engine(served, max_batch=1), [prompt], [1])
    eng = _port_engine(served, max_batch=1, overlap=False)
    eng.submit(prompt, max_new_tokens=10, eos_id=first[0])
    other = eng.submit(rng.integers(0, vocab, (4,)), max_new_tokens=3)
    done = eng.step()                   # admission finishes request 0
    assert [r.output.tolist() for r in done if r.uid != other] == [first]
    assert eng.num_active == 1 and eng.pending == 0
    assert eng.run()[-1].uid == other


def test_engine_rejects_longer_than_slot(served):
    eng = _port_engine(served, max_batch=1)
    with pytest.raises(ValueError, match="slot capacity"):
        eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=13)
    eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=12)   # fits


# ---------------------------------------------------------------------------
# on the card (no JAX): the serving path through the CUDA kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_serving_steps_on_card_match_cpu(cuda, monkeypatch):
    """Smoke config in f32 (TF32 off): prefill_into_slot + 8 decode_rows
    steps through the kernels on the card and the plain versions on the
    CPU, from one set of parameters. f32 sums run in another order on
    the card: logits agree to 1e-4. Every layer launches each kernel once
    per call."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    runs = [(dev, {k: v.to(dev) for k, v in cpu.items()},
             model.init_arena(2, CAPACITY, dtype=torch.float32, device=dev))
            for dev in (torch.device("cpu"), cuda)]
    flash0, decode0 = (flash_attention_cuda.launches,
                       decode_attention_cuda.launches)
    rng = np.random.default_rng(4)
    pos = np.zeros(2, np.int32)
    for slot, plen in ((1, 11), (0, 5)):
        toks = _padded(rng.integers(0, cfg.vocab_size, plen))
        want, got = (model.prefill_into_slot(
            p, torch.from_numpy(toks).to(dev), plen, slot, arena)[0].cpu()
            for dev, p, arena in runs)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        pos[slot] = plen
    cur = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
    for _ in range(8):
        want, got = (model.decode_rows(
            p, torch.from_numpy(cur)[:, None].to(dev), arena,
            torch.from_numpy(pos).to(dev))[0].cpu()
            for dev, p, arena in runs)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        cur, pos = want[:, -1].argmax(-1).numpy().astype(np.int32), pos + 1
    assert flash_attention_cuda.launches - flash0 == 2 * cfg.num_layers
    assert decode_attention_cuda.launches - decode0 == 8 * cfg.num_layers


@pytest.mark.cuda
def test_engine_on_card_serves_every_budget_as_alone(cuda):
    """bf16 smoke engine on the card: every request gets its budget's
    tokens, each equals the same request served alone, and the kernels
    launch once per layer per admission and per decode step."""
    cfg = get_smoke(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    prompts = _prompts(cfg.vocab_size)
    budgets = [b for _, b in WORKLOAD]
    eng = Engine(model, params, max_batch=SLOTS, max_len=CAPACITY)
    flash0, decode0 = (flash_attention_cuda.launches,
                       decode_attention_cuda.launches)
    outs = _run(eng, prompts, budgets)
    st = eng.stats
    assert (flash_attention_cuda.launches - flash0
            == cfg.num_layers * st["admissions"])
    assert (decode_attention_cuda.launches - decode0
            == cfg.num_layers * st["decode_steps"])
    assert [len(o) for o in outs] == budgets
    for prompt, budget, out in zip(prompts, budgets, outs):
        alone = Engine(model, params, max_batch=SLOTS, max_len=CAPACITY)
        assert _run(alone, [prompt], [budget]) == [out]
