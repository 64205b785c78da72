"""Parity of the port's RWKV6 serving path with the JAX reference, at smoke
size on the CPU.

Both sides start from the reference's parameters (`params_from_jax`) and,
for the model entry points, from the same recurrent state
(`arena_from_jax`), and run in f32 (compute and state). The port's WKV
recurrence goes through `kernels.ops.rwkv6_scan`, which on the CPU runs
the kernel's plain version `ref.rwkv6`; the reference's model path runs a
sequential `lax.scan` (S % 64 != 0 or S <= 64) or its chunked closed form
`wkv_chunked`. Where both are sequential, outputs and logits agree to
atol 1e-5 and states to atol 1e-4 plus rtol 1e-5 (only the order of f32
sums differs, and the state sums it over every step), and greedy tokens
are equal; against the chunked form the tolerance is the reference's own
1e-3 for the chunked against the sequential path
(`tests/test_model_numerics.py`).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rwkv6 as RW  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    arena_from_jax, params_from_jax)
from repro_torch.serve import Engine, probe_family_caps  # noqa: E402

ARCH = "rwkv6-1.6b"
ATOL = 1e-5          # sequential against sequential, f32
# the WKV state sums every step's k v^T (terms ~1, each off by ~1e-6 when
# f32 sums run in another order) under decays near 1, up to ~10 in size
STATE_ATOL = 1e-4
CHUNKED_ATOL = 1e-3  # against the reference's chunked closed form
SLOTS, CAPACITY = 3, 32
# (prompt length, budget) per request: more requests than slots, mixed
# lengths and budgets, every plen + budget within the 32-token capacity
WORKLOAD = [(5, 6), (11, 3), (3, 9), (8, 1), (14, 5), (2, 7), (9, 4)]


@pytest.fixture(scope="module")
def jx():
    """The JAX reference (absent on the card's machine: no test here runs
    there)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as jax_get_smoke
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    from repro.models import build_model as jax_build_model
    from repro.models import rwkv6 as jax_rw
    from repro.serve import Engine as JaxEngine
    from repro.serve.engine import probe_family_caps as jax_probe
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke=jax_get_smoke,
                                 ops=jax_ops, ref=jax_ref,
                                 build_model=jax_build_model, rw=jax_rw,
                                 Engine=JaxEngine, probe=jax_probe)


@pytest.fixture(scope="module")
def served(jx):
    jcfg = dataclasses.replace(jx.get_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jmodel, tmodel = jx.build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    tparams = params_from_jax(jx.jax.device_get(jparams))
    return jmodel, jparams, tmodel, tparams


def _wkv_inputs(shape, seed, state=True):
    """r, k, v, w [B,H,S,hd], u [H,hd] and an incoming state (or None) as
    f32 numpy arrays: unit-normal r, k, v, u, decays in [0.2, 0.99] (the
    reference's kernel tests), a state at 0.1."""
    rng = np.random.default_rng(seed)
    b, h, _, hd = shape
    r, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 0.99, shape).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32)
    st = (0.1 * rng.standard_normal((b, h, hd, hd)).astype(np.float32)
          if state else None)
    return (r, k, v, w, u), st


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# the recurrence: plain version against the JAX oracle and TPU kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 64, 32), (2, 3, 130, 64)])
def test_plain_rwkv6_matches_jax_oracle_with_a_state(jx, shape):
    """Output and final state from a nonzero incoming state: f32 sums in
    another order, over outputs of magnitude up to ~50 (decays up to
    0.99 let the state grow to ~10): rtol 1e-5, atol 1e-4."""
    jnp = jx.jnp
    arrays, st = _wkv_inputs(shape, seed=sum(shape))
    out, final = ref.rwkv6(*_torch(arrays), state=torch.from_numpy(st))
    jout, jfinal = jx.ref.rwkv6(*(jnp.asarray(a, jnp.float32) for a in arrays),
                                state=jnp.asarray(st, jnp.float32))
    assert out.dtype == final.dtype == torch.float32
    assert out.shape == shape and final.shape == st.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("s,hd,chunk", [(64, 32, 32), (128, 64, 64)])
def test_plain_rwkv6_matches_jax_tpu_kernel_from_zero(jx, s, hd, chunk):
    """The Pallas kernel (interpret mode) starts from zero and returns no
    state; the plain version from state None agrees at the reference's
    own kernel tolerance (2e-4, tests/test_kernels.py)."""
    jnp = jx.jnp
    arrays, _ = _wkv_inputs((2, 3, s, hd), seed=s, state=False)
    out, final = ref.rwkv6(*_torch(arrays))
    kern = jx.ops.rwkv6_scan(*(jnp.asarray(a, jnp.float32) for a in arrays),
                             chunk=chunk, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), rtol=2e-4,
                               atol=2e-4)
    assert final.shape == (2, 3, hd, hd)


def _decay_inputs(shape, seed, w0):
    """r, k, v unit-normal, decays exp(-exp(w0 + 0.5 z)) (w0 = -2: the
    model's initial decay; 0 to +2: strong), u at 0.1 and a unit-normal
    incoming state, f32 numpy (the card tests' operands)."""
    rng = np.random.default_rng(seed)
    b, h, _, hd = shape
    r, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(w0 + 0.5 * rng.standard_normal(shape))).astype(
        np.float32)
    u = (0.1 * rng.standard_normal((h, hd))).astype(np.float32)
    st = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    return (r, k, v, w, u), st


def _rule(got, want):
    """The card tests' RWKV rule: |got - want| <= 1e-5 rms(want) + 1e-4
    |want|."""
    tol = 1e-5 * want.pow(2).mean().sqrt() + 1e-4 * want.abs()
    return bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("w0", [-2.0, 2.0], ids=["model-decay", "strong"])
@pytest.mark.parametrize("s,chunk", [(192, 64), (200, 64), (70, 32)])
def test_plain_chunked_form_matches_jax_wkv_chunked_and_the_loop(jx, w0, s,
                                                                 chunk):
    """`ref.rwkv6_chunked` (the chunked kernel's arithmetic: sub-chunk
    anchored exponents, running products on the diagonal) against the
    sequential `ref.rwkv6` under the card tests' RWKV rule, against the
    reference's sequential oracle within its CHUNKED_ATOL of 1e-3, and,
    at the model's decays, against the reference's own chunked form
    `wkv_chunked` (S a multiple of its chunk) within the same 1e-3. At
    w0 = +2 `wkv_chunked` itself is 1.3e-3 from the loop at S = 192: its
    exponents are sums over 64 steps."""
    jnp = jx.jnp
    arrays, st = _decay_inputs((1, 3, s, 64), seed=s + chunk, w0=w0)
    ta = _torch(arrays)
    out, final = ref.rwkv6_chunked(*ta, torch.from_numpy(st), chunk=chunk)
    want, want_final = ref.rwkv6(*ta, torch.from_numpy(st))
    assert _rule(out, want) and _rule(final, want_final)
    ja = [jnp.asarray(a, jnp.float32) for a in arrays]
    jst = jnp.asarray(st, jnp.float32)
    jout, jfinal = jx.ref.rwkv6(*ja, state=jst)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=CHUNKED_ATOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=0,
                               atol=CHUNKED_ATOL)
    if s % chunk == 0 and w0 == -2.0:
        jout, jfinal = jx.rw.wkv_chunked(*ja, jst, chunk=chunk)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=CHUNKED_ATOL)
        np.testing.assert_allclose(final.numpy(), np.asarray(jfinal),
                                   rtol=0, atol=CHUNKED_ATOL)


@pytest.mark.parametrize("w0", [0.0, 1.0, 2.0])
def test_plain_chunked_form_at_strong_decays_stays_within_chunked_atol(w0):
    """At strong decays the chunked form's exponents lose what the
    sequential products keep; with every exponent a sum over at most 16
    steps it stays well inside the reference's CHUNKED_ATOL (1e-3) of the
    sequential loop, and no masked entry turns into inf or NaN."""
    arrays, st = _decay_inputs((1, 4, 256, 64), seed=int(w0), w0=w0)
    ta = _torch(arrays)
    out, final = ref.rwkv6_chunked(*ta, torch.from_numpy(st))
    want, want_final = ref.rwkv6(*ta, torch.from_numpy(st))
    assert torch.isfinite(out).all() and torch.isfinite(final).all()
    assert float((out - want).abs().max()) <= CHUNKED_ATOL
    assert float((final - want_final).abs().max()) <= CHUNKED_ATOL


def test_plain_chunked_form_pads_a_ragged_chunk_and_starts_from_zero():
    """S not a multiple of the chunk (padded with r = k = v = 0, w = 1),
    S below one sub-chunk, and state None (zeros), against the loop."""
    for s in (1, 5, 17, 100):
        arrays, _ = _decay_inputs((2, 2, s, 32), seed=s, w0=-2.0)
        ta = _torch(arrays)
        out, final = ref.rwkv6_chunked(*ta)
        want, want_final = ref.rwkv6(*ta)
        assert out.shape == want.shape and final.shape == want_final.shape
        assert _rule(out, want) and _rule(final, want_final)


def test_state_carried_across_a_split_equals_one_pass():
    """`ops.rwkv6_scan` over S in two pieces, the state carried in place
    between them, is bitwise one pass: each step runs the same ops on the
    same values."""
    arrays, st = _wkv_inputs((2, 3, 40, 64), seed=9)
    r, k, v, w, u = _torch(arrays)
    whole_state = torch.from_numpy(st.copy())
    whole, returned = ops.rwkv6_scan(r, k, v, w, u, whole_state)
    assert returned is whole_state          # overwritten in place
    state = torch.from_numpy(st.copy())
    halves = [ops.rwkv6_scan(r[:, :, a:b], k[:, :, a:b], v[:, :, a:b],
                             w[:, :, a:b], u, state)[0]
              for a, b in ((0, 17), (17, 40))]
    assert torch.equal(torch.cat(halves, dim=2), whole)
    assert torch.equal(state, whole_state)


def test_ops_sends_cpu_tensors_to_ref_without_launching():
    arrays, st = _wkv_inputs((1, 2, 5, 32), seed=3)
    before = rwkv6_scan_cuda.launches
    out, _ = ops.rwkv6_scan(*_torch(arrays), torch.from_numpy(st.copy()))
    want, _ = ref.rwkv6(*_torch(arrays), state=torch.from_numpy(st))
    assert torch.equal(out, want)
    assert rwkv6_scan_cuda.launches == before


# ---------------------------------------------------------------------------
# the block: time_mix and channel_mix against the reference's
# ---------------------------------------------------------------------------


def _block_inputs(jx, cfg, s, seed):
    """One layer's JAX mixing parameters, x [2, S, D] and a nonzero state,
    with the port's counterparts."""
    jnp = jx.jnp
    jparams = jx.rw.rwkv_init(jx.jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    b, d, hd = 2, cfg.d_model, cfg.rwkv_head_dim
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    st = {"shift": rng.standard_normal((b, d)).astype(np.float32),
          "wkv": 0.1 * rng.standard_normal(
              (b, d // hd, hd, hd)).astype(np.float32),
          "cm_shift": rng.standard_normal((b, d)).astype(np.float32)}
    jst = {n: jnp.asarray(a, jnp.float32) for n, a in st.items()}
    tparams = params_from_jax(jx.jax.device_get(jparams))
    tst = {n: torch.from_numpy(a.copy()) for n, a in st.items()}
    return (jparams, jnp.asarray(x, jnp.float32), jst), (
        tparams, torch.from_numpy(x), tst)


@pytest.mark.parametrize("s,sequential,atol", [
    (16, False, ATOL),            # the reference scans (S % 64 != 0)
    (128, False, CHUNKED_ATOL),   # the reference takes wkv_chunked
    (128, True, ATOL),            # ... unless REPRO_RWKV_SEQUENTIAL is set
], ids=["S16-sequential", "S128-chunked", "S128-forced-sequential"])
def test_time_mix_and_channel_mix_match_reference(jx, monkeypatch, s,
                                                  sequential, atol):
    if sequential:
        monkeypatch.setenv("REPRO_RWKV_SEQUENTIAL", "1")
    cfg = get_smoke(ARCH)
    (jp, jxx, jst), (tp, tx, tst) = _block_inputs(jx, cfg, s, seed=s)
    wkv_in = tst["wkv"]
    jout, jnew = jx.rw.time_mix(jp, cfg, jxx, jst)
    tout, tnew = RW.time_mix(tp, cfg, tx, tst)
    assert tnew["wkv"] is wkv_in            # the state advanced in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=atol)
    for name in ("shift", "wkv"):
        np.testing.assert_allclose(tnew[name].numpy(), np.asarray(jnew[name]),
                                   rtol=0, atol=atol, err_msg=name)
    jout, jnew = jx.rw.channel_mix(jp, cfg, jxx, jst)
    tout, tnew = RW.channel_mix(tp, cfg, tx, tst)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tnew["cm_shift"].numpy(),
                               np.asarray(jnew["cm_shift"]), rtol=0, atol=0)


def test_port_init_has_the_reference_leaves(jx, served):
    """The port's own init draws every leaf of the reference's pytree with
    its shape, dtype and scale (mix ratios 0.5, w0 -2, unit norms)."""
    _, _, tmodel, tparams = served
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert set(own) == set(tparams)
    for k, v in tparams.items():
        assert own[k].shape == v.shape and own[k].dtype == v.dtype, k
    for k in ("segments.0.mix.mu.r", "segments.0.mix.cm_mu.k"):
        assert bool((own[k] == 0.5).all())
    assert bool((own["segments.0.mix.w0"] == -2.0).all())
    assert float(own["segments.0.mix.u"].std()) == pytest.approx(0.1,
                                                                 rel=0.3)


# ---------------------------------------------------------------------------
# the serving entry points
# ---------------------------------------------------------------------------


def _assert_state_equal(jcache, tcache, atol=STATE_ATOL):
    """Every state leaf, to atol (and rtol 1e-5 where atol > 0)."""
    (want,) = arena_from_jax(jcache)
    (tcache,) = tcache
    assert set(tcache) == set(want) == {"shift", "wkv", "cm_shift"}
    for name, w in want.items():
        got = tcache[name]
        assert got.shape == w.shape and got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), w.numpy(),
                                   rtol=1e-5 if atol else 0, atol=atol,
                                   err_msg=name)


def test_arena_from_jax_recurrent_state(jx, served):
    jax, jnp = jx.jax, jx.jnp
    jmodel, _, tmodel, _ = served
    jarena = jax.device_get(jmodel.init_arena(SLOTS, CAPACITY,
                                              dtype=jnp.float32))
    (own,) = tmodel.init_arena(SLOTS, CAPACITY, dtype=torch.float32)
    cfg = tmodel.cfg
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    assert {n: tuple(t.shape) for n, t in own.items()} == {
        "shift": (cfg.num_layers, SLOTS, d),
        "wkv": (cfg.num_layers, SLOTS, d // hd, hd, hd),
        "cm_shift": (cfg.num_layers, SLOTS, d)}
    _assert_state_equal(jarena, [own], atol=0)
    # the reference's bf16 shifts (after a bf16 decode step) come back f32
    jarena[0]["shift"] = (jarena[0]["shift"] + 1.5).astype(jnp.bfloat16)
    (got,) = arena_from_jax(jarena)
    assert got["shift"].dtype == torch.float32
    assert bool((got["shift"] == 1.5).all())
    # the port's arena has no ptr, as the reference's recurrent arena
    assert "ptr" not in own


def test_prefill_and_decode_step_match_reference(jx, served):
    """The unbatched loop: prefill two prompts of 7, then 8 decode steps:
    logits and every state leaf."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jmodel.cfg.vocab_size, (2, 7)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                cache_dtype=jnp.float32)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    _assert_state_equal(jcache, tcache)
    cur = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    jdecode = jax.jit(jmodel.decode_step)
    for position in range(7, 15):
        jl, jcache = jdecode(jparams, jnp.asarray(cur), jcache,
                             jnp.int32(position))
        tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(cur),
                                        tcache, position)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        cur = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(
            tl[:, -1].argmax(-1).numpy()[:, None], cur)
        _assert_state_equal(jcache, tcache)


def test_prefill_of_a_chunked_length_matches_reference(jx, served):
    """A 128-token prompt: the reference's time_mix takes wkv_chunked
    (the port rounds its WKV output to the compute dtype there, a no-op
    in f32): logits and state at the chunked tolerance."""
    jnp = jx.jnp
    jmodel, jparams, tmodel, tparams = served
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jmodel.cfg.vocab_size, (1, 128)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                cache_dtype=jnp.float32)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=CHUNKED_ATOL)
    _assert_state_equal(jcache, tcache, atol=CHUNKED_ATOL)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (plen,)).astype(np.int32)
            for plen, _ in WORKLOAD]


def test_slot_arena_matches_reference_and_readmission_resets_state(
        jx, served):
    """prefill_into_slot into slots 2, 0, 1, 6 decode_rows steps, then a
    new request admitted into slot 0 over its previous occupant's state,
    and 4 more steps: logits and the whole arena at every step. The
    readmitted slot must equal a fresh prefill of the same prompt."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    jarena = jmodel.init_arena(SLOTS, CAPACITY, dtype=jnp.float32)
    tarena = arena_from_jax(jax.device_get(jarena))
    prompts = _prompts(jmodel.cfg.vocab_size)
    cur = np.zeros(SLOTS, np.int32)
    pos = np.zeros(SLOTS, np.int32)

    def admit(slot, prompt):
        nonlocal jarena, tarena
        toks = prompt[None]                   # exact length, no padding
        jl, jarena = jmodel.prefill_into_slot(
            jparams, jnp.asarray(toks), jnp.int32(len(prompt)),
            jnp.int32(slot), jarena)
        tl, tarena = tmodel.prefill_into_slot(
            tparams, torch.from_numpy(toks), len(prompt), slot, tarena)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        _assert_state_equal(jarena, tarena)
        cur[slot] = int(jnp.argmax(jl[0, -1]))
        pos[slot] = len(prompt)

    jdecode = jax.jit(jmodel.decode_rows)

    def decode(steps):
        nonlocal jarena, tarena, cur, pos
        for _ in range(steps):
            jl, jarena = jdecode(jparams, jnp.asarray(cur)[:, None], jarena,
                                 jnp.asarray(pos))
            tl, tarena = tmodel.decode_rows(
                tparams, torch.from_numpy(cur)[:, None], tarena,
                torch.from_numpy(pos))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=ATOL)
            want = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
            np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), want)
            cur, pos = want, pos + 1
            _assert_state_equal(jarena, tarena)

    for slot, prompt in zip((2, 0, 1), prompts[:3]):
        admit(slot, prompt)
    decode(6)
    assert float(tarena[0]["wkv"][:, 0].abs().max()) > 0    # occupied
    admit(0, prompts[3])
    fresh = tmodel.init_arena(1, CAPACITY, dtype=torch.float32)
    tmodel.prefill_into_slot(tparams, torch.from_numpy(prompts[3][None]),
                             len(prompts[3]), 0, fresh)
    for name, leaf in fresh[0].items():
        assert torch.equal(tarena[0][name][:, 0], leaf[:, 0]), name
    decode(4)


def test_token_variants_match_reference(jx, served):
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    jarena = jmodel.init_arena(SLOTS, CAPACITY, dtype=jnp.float32)
    tarena = arena_from_jax(jax.device_get(jarena))
    pos = np.zeros(SLOTS, np.int32)
    cur = np.zeros(SLOTS, np.int32)
    for slot, prompt in enumerate(_prompts(jmodel.cfg.vocab_size, 2)[:3]):
        jt, jarena = jmodel.prefill_into_slot_token(
            jparams, jnp.asarray(prompt[None]), jnp.int32(len(prompt)),
            jnp.int32(slot), jarena)
        tt, tarena = tmodel.prefill_into_slot_token(
            tparams, torch.from_numpy(prompt[None]), len(prompt), slot,
            tarena)
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
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _run(engine, prompts, budgets):
    uids = [engine.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    done = {r.uid: r for r in engine.run()}
    return [done[u].output.tolist() for u in uids]


def _port_engine(served, **kw):
    _, _, tmodel, tparams = served
    kw.setdefault("max_batch", SLOTS)
    return Engine(tmodel, tparams, max_len=CAPACITY,
                  cache_dtype=torch.float32, **kw)


def test_engine_matches_jax_engine(jx, served):
    jmodel, jparams, _, _ = served
    prompts = _prompts(jmodel.cfg.vocab_size)
    budgets = [b for _, b in WORKLOAD]
    eng = _port_engine(served)
    outs = _run(eng, prompts, budgets)
    jeng = jx.Engine(jmodel, jparams, max_batch=SLOTS, max_len=CAPACITY,
                     cache_dtype=jx.jnp.float32)
    assert outs == _run(jeng, prompts, budgets)
    assert [len(o) for o in outs] == budgets
    # every prompt prefilled at its exact length, as in the reference
    assert eng.prefill_shapes == jeng.prefill_shapes == {
        plen for plen, _ in WORKLOAD}
    assert eng.stats["admissions"] == len(WORKLOAD)


def test_engine_midflight_admission_equals_solo(jx, served):
    """Mirrors tests/test_server.py::test_engine_other_families_bit_
    identical for rwkv6 on both packages: a request admitted mid-flight
    gives the tokens it gives alone, and no prompt is padded."""
    jmodel, jparams, _, _ = served
    rng = np.random.default_rng(14)
    a = rng.integers(0, jmodel.cfg.vocab_size, (5,))
    b = rng.integers(0, jmodel.cfg.vocab_size, (7,))
    results = []
    for make in (lambda: _port_engine(served, max_batch=2),
                 lambda: jx.Engine(jmodel, jparams, max_batch=2,
                                   max_len=CAPACITY,
                                   cache_dtype=jx.jnp.float32)):
        alone = make()
        alone.submit(a, max_new_tokens=4)
        want = alone.run()[0].output
        eng = make()
        eng.submit(b, max_new_tokens=8)
        eng.step()
        eng.step()
        uid = eng.submit(a, max_new_tokens=4)       # admitted mid-flight
        outs = {r.uid: r.output.tolist() for r in eng.run()}
        assert outs[uid] == want.tolist()
        assert eng.prefill_shapes == {5, 7}
        results.append(outs)
    assert results[0] == results[1]


def test_probe_family_caps(jx, served):
    """rwkv: no padding, no paging, as the reference probes; the dense
    model pads and pages, and a window below the capacity stops the
    padding."""
    jmodel, _, tmodel, _ = served
    caps = probe_family_caps(tmodel, capacity=CAPACITY)
    jcaps = jx.probe(jmodel, capacity=CAPACITY)
    assert (caps.pad_prompts, caps.supports_paging) == (
        jcaps.pad_prompts, jcaps.supports_paging) == (False, False)
    dense = get_smoke("qwen2-0.5b")
    assert probe_family_caps(build_model(dense), capacity=32) == (
        type(caps)(pad_prompts=True, supports_paging=True,
                   supports_chunked_prefill=True, supports_mixed_step=True))
    windowed = build_model(dense, window=16)
    assert probe_family_caps(windowed, capacity=32) == (
        type(caps)(pad_prompts=False, supports_paging=True,
                   supports_chunked_prefill=True, supports_mixed_step=True))
    assert probe_family_caps(windowed, capacity=16).pad_prompts


# ---------------------------------------------------------------------------
# bf16 (the smoke config's own compute dtype) against the reference
# ---------------------------------------------------------------------------

# XLA and PyTorch round bf16 activations at other points (XLA fuses
# elementwise chains), so the two bf16 runs differ by about as much as
# either differs from f32. Measured on the CPU at smoke size: the port's
# bf16 logits lie within 0.0213 of max |logit| of the reference's over
# prefill and 8 decode steps, the port's f32 path (the control: the whole
# stack in another precision) within 0.0495 of the same reference. The
# limit sits between the two; a greedy token may flip only where the
# reference's top two logits lie within that limit (the one flip measured
# had a gap of 0.0061), and at most as many requests flip as did (one).
BF16_LOGIT_RTOL = 0.03
BF16_MAX_FLIPS = 1


def bf16_close(tl, jl, rtol):
    """(max |port - reference| <= rtol * max |reference|, that max)."""
    want = np.asarray(jl, np.float32)
    err = float(np.abs(tl.float().numpy() - want).max())
    return err <= rtol * float(np.abs(want).max()), err


def assert_tokens_equal_up_to_ties(prompts, outs, jouts, ref_logits, margin,
                                   max_flips):
    """Each request's tokens equal the reference's, or first differ where
    the reference's logits (`ref_logits(prompt + its tokens so far)`) put
    the port's token within margin * max |logit| of its own: a tie that
    bf16 rounding may break either way (CHANGES.md PRs 4, 6); at most
    max_flips requests differ."""
    flips = 0
    for prompt, out, jout in zip(prompts, outs, jouts):
        assert len(out) == len(jout)
        if out == jout:
            continue
        i = next(n for n, (a, b) in enumerate(zip(out, jout)) if a != b)
        logits = np.asarray(ref_logits(np.concatenate(
            [np.asarray(prompt), np.asarray(jout[:i], np.int64)])),
            np.float32)
        gap = float(logits[jout[i]] - logits[out[i]])
        tie = margin * float(np.abs(logits).max())
        assert 0 <= gap <= tie, (i, gap, tie)
        flips += 1
    assert flips <= max_flips, flips


@pytest.fixture(scope="module")
def served_bf16(jx):
    """Both sides in the smoke config's bf16 compute (f32 parameters and
    recurrent state), from the reference's parameters."""
    jcfg, tcfg = jx.get_smoke(ARCH), get_smoke(ARCH)
    assert jcfg.compute_dtype == tcfg.compute_dtype == "bfloat16"
    jmodel, tmodel = jx.build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    tparams = params_from_jax(jx.jax.device_get(jparams))
    return jmodel, jparams, tmodel, tparams


def test_bf16_prefill_and_decode_logits_match_reference(jx, served_bf16):
    """bf16 prefill of two prompts of 20 (the port's chunked WKV form, the
    reference's sequential scan) and 8 decode steps from the reference's
    tokens: logits within BF16_LOGIT_RTOL."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served_bf16
    toks = np.random.default_rng(5).integers(
        0, jmodel.cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                cache_dtype=jnp.bfloat16)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                cache_dtype=torch.bfloat16)
    ok, err = bf16_close(tl, jl, BF16_LOGIT_RTOL)
    assert ok, err
    jdecode = jax.jit(jmodel.decode_step)
    for position in range(20, 28):
        cur = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jcache = jdecode(jparams, jnp.asarray(cur), jcache,
                             jnp.int32(position))
        tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(cur),
                                        tcache, position)
        ok, err = bf16_close(tl, jl, BF16_LOGIT_RTOL)
        assert ok, (position, err)


def test_bf16_engine_tokens_match_reference_up_to_ties(jx, served_bf16):
    """The bf16 engines on the workload: equal tokens, or a first
    difference at a reference near-tie."""
    jnp = jx.jnp
    jmodel, jparams, tmodel, tparams = served_bf16
    prompts = _prompts(jmodel.cfg.vocab_size)
    budgets = [b for _, b in WORKLOAD]
    outs = _run(Engine(tmodel, tparams, max_batch=SLOTS, max_len=CAPACITY,
                       cache_dtype=torch.bfloat16), prompts, budgets)
    jouts = _run(jx.Engine(jmodel, jparams, max_batch=SLOTS,
                           max_len=CAPACITY, cache_dtype=jnp.bfloat16),
                 prompts, budgets)

    def ref_logits(seq):
        jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(seq[None],
                                                               jnp.int32)},
                               cache_dtype=jnp.bfloat16)
        return jl[0, -1]

    assert_tokens_equal_up_to_ties(prompts, outs, jouts, ref_logits,
                                   BF16_LOGIT_RTOL, BF16_MAX_FLIPS)


def test_paged_engine_serves_rwkv_from_the_arena(served):
    """Engine(paged=True) on a family that cannot page serves from the
    arena, as the reference does, with the arena's tokens."""
    prompts = _prompts(served[2].cfg.vocab_size, 5)
    budgets = [b for _, b in WORKLOAD]
    eng = _port_engine(served, paged=True, block_size=4)
    assert not eng.paged and eng.free_blocks is None
    assert _run(eng, prompts, budgets) == _run(_port_engine(served),
                                               prompts, budgets)


def test_rwkv_model_has_no_paged_entry_points_and_no_window(served):
    tmodel = served[2]
    assert tmodel.init_pool is None and tmodel.decode_rows_paged is None
    assert tmodel.window == 0
    with pytest.raises(ValueError, match="no attention|applies to"):
        build_model(tmodel.cfg, window=16)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_serve_cli_rwkv_on_cpu(capsys):
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--requests", "4",
                          "--max-batch", "2", "--prompt-len", "9",
                          "--new-tokens", "4", "--mixed", "--paged",
                          "--device", "cpu"])
    assert out["device"] == "cpu" and not out["paged"]
    assert [len(o) for o in out["outputs"]] == out["budgets"] == [1, 4, 1, 4]
    assert out["prefill_shapes"] == [9]          # exact length, no bucket
    assert out["stats"]["admissions"] == 4
    assert "served from the arena" in capsys.readouterr().out


@pytest.mark.parametrize("steps,extra", [(3, []), (2, ["--baseline"])],
                         ids=["api-bcd", "dp-baseline"])
def test_train_cli_rwkv_on_cpu(steps, extra):
    """The launcher trains the RWKV6 smoke config (API-BCD supersteps, or
    the DP baseline's steps) with finite losses."""
    out = train_cli.main(["--arch", ARCH, "--smoke", "--steps", str(steps),
                          "--seq", "16", "--batch-per-agent", "1",
                          "--device", "cpu", "--log-every", "0", *extra])
    assert out["device"] == "cpu" and len(out["losses"]) == steps
    assert np.all(np.isfinite(out["losses"]))


def test_full_config_is_the_published_width(jx):
    """rwkv6-1.6b (arXiv:2404.05892): 24 layers, d_model 2048, 32 WKV
    heads of 64, d_ff 7168, vocab 65536, as the reference's config; ~1.6 B
    parameters (counted from the reference's init, abstractly: the smoke
    test above holds the port's leaves to the reference's)."""
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.d_model // cfg.rwkv_head_dim,
            cfg.d_ff, cfg.vocab_size) == (24, 2048, 32, 7168, 65536)
    from repro.configs import get_config as jax_get_config
    jcfg = jax_get_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jmodel = jx.build_model(jcfg)
    shapes = jx.jax.eval_shape(jmodel.init, jx.jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape))
            for a in jx.jax.tree_util.tree_leaves(shapes))
    assert 1.5e9 < n < 1.7e9, n


# ---------------------------------------------------------------------------
# on the card (no JAX): the RWKV6 serving path through the CUDA kernel
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rwkv_serving_steps_on_card_match_cpu(cuda, monkeypatch):
    """Smoke config in f32 (TF32 off): prefill_into_slot into 2 slots (one
    prompt long enough for the chunked body) and 8
    decode_rows steps through the kernel on the card and the plain version
    on the CPU, from one set of parameters: logits within 1e-4 (f32 sums
    in another order), states within 1e-4 + 1e-5 of their size, and one
    launch per layer per admission and per decode step."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    # an RWKV slot holds no positions: a prompt may pass the capacity
    runs = [(dev, {k: v.to(dev) for k, v in cpu.items()},
             model.init_arena(2, CAPACITY, device=dev))
            for dev in (torch.device("cpu"), cuda)]
    before = rwkv6_scan_cuda.launches
    rng = np.random.default_rng(4)
    pos = np.zeros(2, np.int32)
    for slot, plen in ((1, 100), (0, 5)):     # 100: the chunked WKV body
        toks = rng.integers(0, cfg.vocab_size, (1, plen)).astype(np.int32)
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
    for name in runs[0][2][0]:
        torch.testing.assert_close(runs[1][2][0][name].cpu(),
                                   runs[0][2][0][name], rtol=1e-5, atol=1e-4)
    assert rwkv6_scan_cuda.launches - before == 10 * cfg.num_layers


@pytest.mark.cuda
def test_rwkv_engine_on_card_serves_every_budget_as_alone(cuda):
    """bf16 smoke engine on the card: every request gets its budget's
    tokens at its exact prompt length, each equals the same request
    served alone, and the kernel launches once per layer per admission and
    per decode step."""
    cfg = get_smoke(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    prompts = _prompts(cfg.vocab_size)
    budgets = [b for _, b in WORKLOAD]
    eng = Engine(model, params, max_batch=SLOTS, max_len=CAPACITY)
    before = rwkv6_scan_cuda.launches
    outs = _run(eng, prompts, budgets)
    st = eng.stats
    assert (rwkv6_scan_cuda.launches - before
            == cfg.num_layers * (st["admissions"] + st["decode_steps"]))
    assert [len(o) for o in outs] == budgets
    assert eng.prefill_shapes == {plen for plen, _ in WORKLOAD}
    for prompt, budget, out in zip(prompts, budgets, outs):
        alone = Engine(model, params, max_batch=SLOTS, max_len=CAPACITY)
        assert _run(alone, [prompt], [budget]) == [out]
