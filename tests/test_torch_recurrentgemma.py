"""Parity of the port's recurrentgemma (RG-LRU + local attention hybrid)
serving path with the JAX reference, at smoke size on the CPU.

Both sides start from the reference's parameters (`params_from_jax`) and,
for the model entry points, from the same caches (`arena_from_jax`), and
run in f32 (compute, caches and state) unless a test says bf16. The
port's gates and recurrence go through `kernels.ops.rglru_scan`, which on
the CPU runs the fused kernel's plain version `ref.rglru_gated` (the
block's ops, then `ref.rglru`); the reference's model path
runs a `lax.scan`. Both round the same f32 ops in the same order, so
recurrences agree to 1e-6 and the model's logits and states to 1e-5
(f32 matrix products sum in another order), and greedy tokens are equal.
In bf16 the reference's XLA rounds the intermediate ops of sigmoid and
gelu in bf16 where PyTorch computes them in f32 and rounds once: one bf16
ulp (2^-8) in a gate moves a block's output by ~1 % of its size, so bf16
blocks agree to 1e-2 at outputs of ~0.3.
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
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.rglru_scan import rglru_scan_cuda  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    arena_from_jax, params_from_jax)
from repro_torch.models.layers import mlp_apply, mlp_init  # noqa: E402
from repro_torch.serve import Engine, probe_family_caps  # noqa: E402
from test_torch_rwkv import (  # noqa: E402
    assert_tokens_equal_up_to_ties, bf16_close)

ARCH = "recurrentgemma-2b"
SCAN_ATOL = 1e-6     # the recurrence: the same f32 ops in the same order
ATOL = 1e-5          # logits, outputs and states: f32 products' sum order
BF16_ATOL = 1e-2     # bf16 blocks (module docstring)
SLOTS, CAPACITY = 3, 64
# (prompt length, budget): more requests than slots, prompts past the
# smoke config's 32-token window, every plen + budget within capacity 64
WORKLOAD = [(40, 12), (9, 12), (33, 6), (5, 20), (50, 8), (3, 9)]


@pytest.fixture(scope="module")
def jx():
    """The JAX reference (absent on the card's machine: no test here that
    uses it runs there)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs import get_smoke as jax_get_smoke
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    from repro.models import build_model as jax_build_model
    from repro.models import rglru as jax_rg
    from repro.models.layers import mlp_apply as jax_mlp_apply
    from repro.models.layers import mlp_init as jax_mlp_init
    from repro.serve import Engine as JaxEngine
    from repro.serve.engine import probe_family_caps as jax_probe
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        get_smoke=jax_get_smoke, ops=jax_ops, ref=jax_ref,
        build_model=jax_build_model, rg=jax_rg, mlp_apply=jax_mlp_apply,
        mlp_init=jax_mlp_init, Engine=JaxEngine, probe=jax_probe)


@pytest.fixture(scope="module")
def served(jx):
    jcfg = dataclasses.replace(jx.get_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jmodel, tmodel = jx.build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    tparams = params_from_jax(jx.jax.device_get(jparams))
    return jmodel, jparams, tmodel, tparams


def _scan_inputs(shape, seed):
    """a in [0.3, 0.999] (the reference's kernel tests), unit-normal u and
    an incoming state, f32 numpy."""
    rng = np.random.default_rng(seed)
    b, _, w = shape
    a = rng.uniform(0.3, 0.999, shape).astype(np.float32)
    u = rng.standard_normal(shape).astype(np.float32)
    return a, u, rng.standard_normal((b, w)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the recurrence: plain version against the JAX oracle and TPU kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [True, False],
                         ids=["from-state", "from-zero"])
def test_plain_rglru_matches_jax_oracle(jx, with_state):
    jnp = jx.jnp
    a, u, h0 = _scan_inputs((2, 37, 96), seed=1)
    out, final = ref.rglru(*_t(a, u), *(_t(h0) if with_state else []))
    jout, jfinal = jx.ref.rglru(jnp.asarray(a), jnp.asarray(u),
                                jnp.asarray(h0) if with_state else None)
    assert out.dtype == final.dtype == torch.float32
    assert out.shape == (2, 37, 96) and final.shape == (2, 96)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=SCAN_ATOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=0,
                               atol=SCAN_ATOL)


@pytest.mark.parametrize("s,w,chunk,block_w",
                         [(64, 256, 32, 128), (100, 130, 64, 512)])
def test_plain_rglru_matches_jax_tpu_kernel_from_zero(jx, s, w, chunk,
                                                      block_w):
    """The Pallas kernel (interpret mode, as tests/test_kernels.py runs
    it) starts from zero and returns no state; it agrees at the
    reference's own kernel tolerance, 1e-5 (interpret mode lands an ulp
    off the sequential scan on some elements)."""
    jnp = jx.jnp
    a, u, _ = _scan_inputs((2, s, w), seed=s)
    out, _ = ref.rglru(*_t(a, u))
    kern = jx.ops.rglru_scan(jnp.asarray(a), jnp.asarray(u), chunk=chunk,
                             block_w=block_w, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), rtol=1e-5,
                               atol=1e-5)


def _gated_inputs(b, s, w, dtype, seed):
    """The fused scan's inputs in dtype (gate products, b_a, b_i, lamb
    spread over (-1, 3), xa) and an f32 incoming state."""
    rng = np.random.default_rng(seed)
    ga, gi, xa = (torch.from_numpy(rng.standard_normal((b, s, w)).astype(
        np.float32)).to(dtype) for _ in range(3))
    b_a, b_i = (torch.from_numpy(0.5 * rng.standard_normal(w).astype(
        np.float32)).to(dtype) for _ in range(2))
    lamb = torch.from_numpy(rng.uniform(-1, 3, w).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32))
    return (ga, gi, b_a, b_i, lamb.to(dtype), xa), h0


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_state_carried_across_pieces_equals_one_pass(out_dtype):
    """`ops.rglru_scan` in pieces (at 1, 16 and 29 of 40 steps), the state
    carried in place, is bitwise one pass; the output is in the inputs'
    dtype and is `ref.rglru_gated`'s."""
    (ga, gi, b_a, b_i, lamb, xa), h0 = _gated_inputs(2, 40, 64, out_dtype, 9)
    whole_state = h0.clone()
    whole, returned = ops.rglru_scan(ga, gi, b_a, b_i, lamb, xa, whole_state)
    assert returned is whole_state          # overwritten in place
    assert whole.dtype == out_dtype
    state = h0.clone()
    cuts = (0, 1, 16, 29, 40)
    pieces = [ops.rglru_scan(ga[:, x:z], gi[:, x:z], b_a, b_i, lamb,
                             xa[:, x:z], state)[0]
              for x, z in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(pieces, dim=1), whole)
    assert torch.equal(state, whole_state)
    want, _ = ref.rglru_gated(ga, gi, b_a, b_i, lamb, xa, h0)
    assert torch.equal(whole, want)


def test_ops_sends_cpu_tensors_to_ref_without_launching():
    args, h0 = _gated_inputs(1, 5, 32, torch.float32, 3)
    before = rglru_scan_cuda.launches
    out, _ = ops.rglru_scan(*args, h0.clone())
    want, _ = ref.rglru_gated(*args, h0)
    assert torch.equal(out, want)
    assert rglru_scan_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gated_plain_is_the_block_op_sequence_then_the_scan(dtype):
    """`ref.rglru_gated` is the block's former op sequence (gates, decay,
    scale as separate PyTorch ops) followed by `ref.rglru`, bitwise, with
    lamb past softplus's threshold of 20 on one channel."""
    (ga, gi, b_a, b_i, lamb, xa), h0 = _gated_inputs(2, 7, 48, dtype, 21)
    lamb[5] = 25.0
    r = torch.sigmoid(ga + b_a)
    i = torch.sigmoid(gi + b_i)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lamb.float())
                  * r.float())
    u = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xa).float()
    want, want_final = ref.rglru(a, u, h0)
    got, final = ref.rglru_gated(ga, gi, b_a, b_i, lamb, xa, h0)
    assert torch.equal(got, want.to(dtype)) and torch.equal(final,
                                                            want_final)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 9])
def test_rglru_block_equals_the_former_op_sequence(dtype, s):
    """The block with the fused entry gives the output and state of the
    former sequence (17 separate ops, then the scan), bitwise."""
    import torch.nn.functional as F
    cfg = get_smoke(ARCH)
    g = torch.Generator().manual_seed(s)
    p = RG.rglru_init(g, (), cfg, dtype)
    p["b_a"] = (0.3 * torch.randn(p["b_a"].shape, generator=g)).to(dtype)
    p["lamb"] = (3 * torch.rand(p["lamb"].shape, generator=g)).to(dtype)
    x = torch.randn(2, s, cfg.d_model, generator=g).to(dtype)
    st = RG.init_state(cfg, 2)
    st["h"].normal_(generator=g)
    st["conv"].normal_(generator=g)
    old = {k: v.clone() for k, v in st.items()}
    out, new = RG.rglru_block(p, cfg, x, st)
    xa, conv = RG._causal_conv(p, x @ p["w_x"], old["conv"])
    r = torch.sigmoid(xa @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(xa @ p["w_i"] + p["b_i"])
    a = torch.exp(-8.0 * F.softplus(p["lamb"].float()) * r.float())
    u = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xa).float()
    h, final = ref.rglru(a, u, old["h"])
    yb = F.gelu(x @ p["w_y"], approximate="tanh")
    assert torch.equal(out, (h.to(dtype) * yb) @ p["w_out"])
    assert torch.equal(new["h"], final) and torch.equal(new["conv"], conv)


# ---------------------------------------------------------------------------
# the block: causal conv, RG-LRU block and gelu MLP against the reference's
# ---------------------------------------------------------------------------


def _block_params(jx, dtype, seed=1):
    """One RG-LRU block's JAX parameters in dtype, and the port's."""
    jnp = jx.jnp
    cfg = get_smoke(ARCH)
    jparams = jx.rg.rglru_init(jx.jax.random.PRNGKey(seed), cfg, jnp.float32)
    tparams = {k: v.to(dtype) for k, v in
               params_from_jax(jx.jax.device_get(jparams)).items()}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return cfg, jx.jax.tree.map(lambda t: t.astype(jdt), jparams), tparams, jdt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 2, 12])
def test_causal_conv_matches_reference(jx, dtype, s):
    """S below, at and above conv_width - 1 = 3, from a nonzero state:
    the taps' sum in the same order rounds the same way, so output and
    new state are bitwise the reference's."""
    jnp = jx.jnp
    cfg, jp, tp, jdt = _block_params(jx, dtype)
    rng = np.random.default_rng(s)
    w = cfg.rnn_width
    x = rng.standard_normal((2, s, w)).astype(np.float32)
    st = rng.standard_normal((2, cfg.conv_width - 1, w)).astype(np.float32)
    out, new = RG._causal_conv(tp, torch.from_numpy(x).to(dtype),
                               torch.from_numpy(st))
    jout, jnew = jx.rg._causal_conv(jp, jnp.asarray(x, jdt), jnp.asarray(st))
    assert out.dtype == dtype and out.shape == (2, s, w)
    assert new.shape == (2, cfg.conv_width - 1, w)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jout, np.float32))
    np.testing.assert_array_equal(new.float().numpy(),
                                  np.asarray(jnew, np.float32))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, ATOL),
                                        (torch.bfloat16, BF16_ATOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 12])
def test_rglru_block_matches_reference_with_a_state(jx, dtype, atol, s):
    """Output and new state (h advanced in place, conv inputs copied in)
    from a nonzero state."""
    jnp = jx.jnp
    cfg, jp, tp, jdt = _block_params(jx, dtype)
    rng = np.random.default_rng(10 + s)
    w = cfg.rnn_width
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    st = {"conv": rng.standard_normal((2, cfg.conv_width - 1, w)),
          "h": rng.standard_normal((2, w))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    h_in = tst["h"]
    out, new = RG.rglru_block(tp, cfg, torch.from_numpy(x).to(dtype), tst)
    jout, jnew = jx.rg.rglru_block(jp, cfg, jnp.asarray(x, jdt),
                                   {k: jnp.asarray(v) for k, v in st.items()})
    assert new["h"] is h_in and out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), rtol=0, atol=atol)
    for name in ("h", "conv"):
        assert new[name].dtype == torch.float32
        np.testing.assert_allclose(new[name].numpy(),
                                   np.asarray(jnew[name], np.float32),
                                   rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, ATOL),
                                        (torch.bfloat16, BF16_ATOL)],
                         ids=["f32", "bf16"])
def test_gelu_mlp_matches_reference(jx, dtype, atol):
    """The tanh-form gelu MLP (one up projection), outputs of ~1."""
    jnp = jx.jnp
    jp = jx.mlp_init(jx.jax.random.PRNGKey(4), 64, 128, "gelu", jnp.float32)
    tp = {k: v.to(dtype) for k, v in
          params_from_jax(jx.jax.device_get(jp)).items()}
    assert set(tp) == {"w_up", "w_down"}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = np.random.default_rng(4).standard_normal((2, 5, 64)).astype(
        np.float32)
    out = mlp_apply(tp, torch.from_numpy(x).to(dtype), "gelu")
    jout = jx.mlp_apply(jx.jax.tree.map(lambda t: t.astype(jdt), jp),
                        jnp.asarray(x, jdt), "gelu")
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), rtol=0, atol=atol)
    own = mlp_init(torch.Generator().manual_seed(0), (3,), 64, 128,
                   torch.float32, "gelu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        "w_up": (3, 64, 128), "w_down": (3, 128, 64)}


# ---------------------------------------------------------------------------
# the stack: segments, parameters and caches
# ---------------------------------------------------------------------------


def test_segments_and_port_init_match_the_reference(jx, served):
    """17 segments for the full config, 2 for the smoke one, as the
    reference's `build_segments`; the port's own init draws every leaf of
    the reference's pytree with its shape, dtype and scale."""
    from repro.models.transformer import build_segments as jax_segments
    full = get_config(ARCH)
    segs = TF.segments(full)
    assert segs == jax_segments(full.layer_types)
    assert len(segs) == 17 and segs[:3] == [("rglru", 2), ("attn", 1),
                                            ("rglru", 2)]
    assert sum(c for k, c in segs if k == "rglru") == 18
    _, _, tmodel, tparams = served
    assert TF.segments(tmodel.cfg) == [("rglru", 2), ("attn", 1)]
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert set(own) == set(tparams)
    for k, v in tparams.items():
        assert own[k].shape == v.shape and own[k].dtype == v.dtype, k
    assert bool((own["segments.0.rnn.lamb"] == 1.0).all())
    assert bool((own["segments.0.rnn.conv_bias"] == 0).all())
    assert float(own["segments.0.rnn.conv_kernel"].std()) == pytest.approx(
        0.1, rel=0.3)


def test_params_and_arena_from_jax_over_three_segments(jx, served):
    """A 7-layer stack (rglru x2, attn, rglru x2, attn, rglru): 5
    segments of parameters and caches convert with their shapes; the
    reference's bf16 conv inputs (after a bf16 step) come back f32."""
    jax, jnp = jx.jax, jx.jnp
    types_ = ("rglru", "rglru", "attn", "rglru", "rglru", "attn", "rglru")
    jcfg = dataclasses.replace(jx.get_smoke(ARCH), num_layers=7,
                               layer_types=types_)
    tcfg = dataclasses.replace(get_smoke(ARCH), num_layers=7,
                               layer_types=types_)
    jmodel, tmodel = jx.build_model(jcfg), build_model(tcfg)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(1)))
    tparams = params_from_jax(jparams)
    own = tmodel.init(torch.Generator().manual_seed(1))
    assert set(own) == set(tparams)
    for k, v in tparams.items():
        assert own[k].shape == v.shape, k
    assert tparams["segments.2.rnn.w_x"].shape == (2, 128, 128)
    assert tparams["segments.3.attn.wq"].shape == (1, 128, 128)
    assert tparams["segments.4.rnn.w_x"].shape == (1, 128, 128)
    jarena = jax.device_get(jmodel.init_arena(SLOTS, CAPACITY,
                                              dtype=jnp.bfloat16))
    tarena = arena_from_jax(jarena)
    mine = tmodel.init_arena(SLOTS, CAPACITY)
    assert len(tarena) == len(mine) == 5
    for want, got in zip(tarena, mine):
        assert set(want) == set(got)
        for name in got:
            assert want[name].shape == got[name].shape, name
            assert want[name].dtype == got[name].dtype, name
    assert mine[1]["k"].shape == (1, SLOTS, 32, 1, 64)   # the window's ring
    assert mine[1]["ptr"].shape == (1, SLOTS)
    assert mine[0]["conv"].dtype == mine[0]["h"].dtype == torch.float32
    jarena[4]["conv"] = (jarena[4]["conv"] + 1.5).astype(jnp.bfloat16)
    got = arena_from_jax(jarena)[4]["conv"]
    assert got.dtype == torch.float32 and bool((got == 1.5).all())


# ---------------------------------------------------------------------------
# the serving entry points
# ---------------------------------------------------------------------------


def _assert_caches_equal(jcaches, tcaches, atol=ATOL):
    """Every leaf of every segment, to atol (ptr exactly)."""
    want = arena_from_jax(jcaches)
    assert len(want) == len(tcaches)
    for si, (w, got) in enumerate(zip(want, tcaches)):
        assert set(w) == set(got), si
        for name, leaf in w.items():
            assert got[name].shape == leaf.shape, (si, name)
            assert got[name].dtype == leaf.dtype, (si, name)
            np.testing.assert_allclose(
                got[name].float().numpy(), leaf.float().numpy(), rtol=0,
                atol=0 if name == "ptr" else atol, err_msg=f"{si} {name}")


def test_prefill_and_decode_step_match_reference(jx, served):
    """The unbatched loop: two prompts of 40 (past the 32-token window:
    the ring wraps and the window binds in the prefill), then 10 decode
    steps: logits, greedy tokens and every cache leaf."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    toks = np.random.default_rng(3).integers(
        0, jmodel.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                cache_dtype=jnp.float32, cache_len=CAPACITY)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                cache_dtype=torch.float32, cache_len=CAPACITY)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    _assert_caches_equal(jcache, tcache)
    assert tcache[1]["k"].shape[2] == 32
    cur = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    jdecode = jax.jit(jmodel.decode_step)
    for position in range(40, 50):
        jl, jcache = jdecode(jparams, jnp.asarray(cur), jcache,
                             jnp.int32(position))
        tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(cur),
                                        tcache, position)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        cur = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(
            tl[:, -1].argmax(-1).numpy()[:, None], cur)
    _assert_caches_equal(jcache, tcache)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (plen,)).astype(np.int32)
            for plen, _ in WORKLOAD]


def test_slot_arena_matches_reference_and_readmission_resets_state(
        jx, served):
    """prefill_into_slot into slots 2, 0, 1 (prompts of 40, 9, 33), 6
    decode_rows steps, then a new request admitted into slot 0 over its
    previous occupant's state and ring, and 4 more steps: logits and the
    whole arena at every step. The readmitted slot equals a fresh
    prefill of the same prompt."""
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
        _assert_caches_equal(jarena, tarena)
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
            _assert_caches_equal(jarena, tarena)

    for slot, prompt in zip((2, 0, 1), prompts[:3]):
        admit(slot, prompt)
    decode(6)
    assert float(tarena[0]["h"][:, 0].abs().max()) > 0     # occupied
    admit(0, prompts[3])
    fresh = tmodel.init_arena(1, CAPACITY, dtype=torch.float32)
    tmodel.prefill_into_slot(tparams, torch.from_numpy(prompts[3][None]),
                             len(prompts[3]), 0, fresh)
    for seg, fseg in zip(tarena, fresh):
        for name, leaf in fseg.items():
            assert torch.equal(seg[name][:, 0], leaf[:, 0]), name
    decode(4)


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


def _reference_greedy(jx, served, prompt, budget):
    """The reference's unbatched greedy loop: prefill, then decode_step."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams = served[:2]
    jl, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt[None])},
                               cache_dtype=jnp.float32, cache_len=CAPACITY)
    out = [int(jnp.argmax(jl[0, -1]))]
    decode = jax.jit(jmodel.decode_step)
    for position in range(len(prompt), len(prompt) + budget - 1):
        jl, cache = decode(jparams, jnp.asarray([[out[-1]]], jnp.int32),
                           cache, jnp.int32(position))
        out.append(int(jnp.argmax(jl[0, -1])))
    return out


def test_engine_matches_jax_engine_and_unbatched_loop(jx, served):
    jmodel, jparams, _, _ = served
    prompts = _prompts(jmodel.cfg.vocab_size)
    budgets = [b for _, b in WORKLOAD]
    eng = _port_engine(served)
    outs = _run(eng, prompts, budgets)
    jeng = jx.Engine(jmodel, jparams, max_batch=SLOTS, max_len=CAPACITY,
                     cache_dtype=jx.jnp.float32, overlap=False)
    assert outs == _run(jeng, prompts, budgets)
    assert [len(o) for o in outs] == budgets
    for prompt, budget, out in zip(prompts, budgets, outs):
        assert out == _reference_greedy(jx, served, prompt, budget)
    # every prompt prefilled at its exact length, as in the reference
    assert eng.prefill_shapes == jeng.prefill_shapes == {
        plen for plen, _ in WORKLOAD}
    assert eng.stats["admissions"] == len(WORKLOAD)


# ---------------------------------------------------------------------------
# bf16 (the smoke config's own compute dtype) against the reference
# ---------------------------------------------------------------------------

# Measured on the CPU at smoke size: the port's bf16 logits lie within
# 0.0131 of max |logit| of the reference's over prefill and 8 decode steps
# (the two bf16 runs round at other points; see test_torch_rwkv.py). The
# port's f32 path reads 0.0126 against the same reference, so at this
# size the logits cannot tell a stack run in another precision from the
# rounding-point noise: `rglru_block`'s bitwise test against the former op
# sequence and the kernel's bitwise card tests hold the precision. The
# limit is 1.4 times the reading; no request flipped, and none may.
BF16_LOGIT_RTOL = 0.018
BF16_MAX_FLIPS = 0


@pytest.fixture(scope="module")
def served_bf16(jx):
    """Both sides in the smoke config's bf16 compute (f32 parameters,
    recurrent state f32, KV cache bf16), from the reference's
    parameters."""
    jcfg, tcfg = jx.get_smoke(ARCH), get_smoke(ARCH)
    assert jcfg.compute_dtype == tcfg.compute_dtype == "bfloat16"
    jmodel, tmodel = jx.build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    tparams = params_from_jax(jx.jax.device_get(jparams))
    return jmodel, jparams, tmodel, tparams


def test_bf16_prefill_and_decode_logits_match_reference(jx, served_bf16):
    """bf16 prefill of two prompts of 40 (past the 32-token window) and 8
    decode steps from the reference's tokens: logits within
    BF16_LOGIT_RTOL."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served_bf16
    toks = np.random.default_rng(5).integers(
        0, jmodel.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                cache_dtype=jnp.bfloat16, cache_len=CAPACITY)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                cache_dtype=torch.bfloat16,
                                cache_len=CAPACITY)
    ok, err = bf16_close(tl, jl, BF16_LOGIT_RTOL)
    assert ok, err
    jdecode = jax.jit(jmodel.decode_step)
    for position in range(40, 48):
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
                           max_len=CAPACITY, cache_dtype=jnp.bfloat16,
                           overlap=False), prompts, budgets)

    def ref_logits(seq):
        jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(seq[None],
                                                               jnp.int32)},
                               cache_dtype=jnp.bfloat16, cache_len=CAPACITY)
        return jl[0, -1]

    assert_tokens_equal_up_to_ties(prompts, outs, jouts, ref_logits,
                                   BF16_LOGIT_RTOL, BF16_MAX_FLIPS)


def test_probe_family_caps_and_paged_request(jx, served):
    """The hybrid: no padding, no paging, as the reference probes;
    Engine(paged=True) serves it from the arena with the arena's tokens."""
    jmodel, _, tmodel, _ = served
    caps = probe_family_caps(tmodel, capacity=CAPACITY)
    jcaps = jx.probe(jmodel, capacity=CAPACITY)
    assert (caps.pad_prompts, caps.supports_paging) == (
        jcaps.pad_prompts, jcaps.supports_paging) == (False, False)
    assert tmodel.init_pool is None and tmodel.decode_rows_paged is None
    assert tmodel.window == 32
    prompts = _prompts(tmodel.cfg.vocab_size, 5)
    budgets = [b for _, b in WORKLOAD]
    eng = _port_engine(served, paged=True, block_size=4)
    assert not eng.paged and eng.free_blocks is None
    assert _run(eng, prompts, budgets) == _run(_port_engine(served),
                                               prompts, budgets)


# ---------------------------------------------------------------------------
# the launchers and the full config
# ---------------------------------------------------------------------------


def test_serve_cli_recurrentgemma_on_cpu(capsys):
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--requests", "4",
                          "--max-batch", "2", "--prompt-len", "40",
                          "--new-tokens", "8", "--mixed", "--paged",
                          "--device", "cpu"])
    assert out["device"] == "cpu" and not out["paged"]
    assert [len(o) for o in out["outputs"]] == out["budgets"] == [2, 8, 2, 8]
    assert out["prefill_shapes"] == [40]         # exact length, no bucket
    assert "served from the arena" in capsys.readouterr().out


@pytest.mark.parametrize("steps,extra", [(3, []), (2, ["--baseline"])],
                         ids=["api-bcd", "dp-baseline"])
def test_train_cli_hybrid_on_cpu(steps, extra):
    """The launcher trains the hybrid's smoke config (API-BCD supersteps,
    or the DP baseline's steps) past its 32-token window, with finite
    losses."""
    out = train_cli.main(["--arch", ARCH, "--smoke", "--steps", str(steps),
                          "--seq", "40", "--batch-per-agent", "1",
                          "--device", "cpu", "--log-every", "0", *extra])
    assert out["device"] == "cpu" and len(out["losses"]) == steps
    assert np.all(np.isfinite(out["losses"]))


def test_full_config_is_the_published_width(jx):
    """recurrentgemma-2b (arXiv:2402.19427): 26 layers in the pattern
    (rglru, rglru, attn), d_model 2560, 10 query heads of 256 over 1 kv
    head, window 2048, RG-LRU width 2560, conv width 4, gelu d_ff 7680,
    vocab 256000, as the reference's config; ~3.04 B parameters (counted
    from the reference's init, abstractly)."""
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.attn_window, cfg.rnn_width, cfg.conv_width,
            cfg.d_ff, cfg.vocab_size, cfg.mlp_type) == (
        26, 2560, 10, 1, 256, 2048, 2560, 4, 7680, 256000, "gelu")
    jcfg = jx.get_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jmodel = jx.build_model(jcfg)
    shapes = jx.jax.eval_shape(jmodel.init, jx.jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape))
            for a in jx.jax.tree_util.tree_leaves(shapes))
    assert 3.0e9 < n < 3.1e9, n


# ---------------------------------------------------------------------------
# on the card (no JAX): the hybrid serving path through the CUDA kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts():
    return (rglru_scan_cuda.launches, flash_attention_cuda.launches,
            decode_attention_cuda.launches)


@pytest.mark.cuda
def test_hybrid_serving_steps_on_card_match_cpu(cuda, monkeypatch):
    """Smoke config in f32 (TF32 off): prefill_into_slot of a 40-token
    prompt (past the 32-token window) and an 11-token one, 8 decode_rows
    steps, a readmission over slot 0 and 4 more steps, through the kernels
    on the card and the plain versions on the CPU, from one set of
    parameters: logits within 1e-4 (f32 sums in another order), every
    cache leaf within 1e-4 + 1e-5 of its size, and per admission one
    RG-LRU launch per RG-LRU layer and one flash launch per attention
    layer, per decode step one RG-LRU and one decode launch."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    runs = [(dev, {k: v.to(dev) for k, v in cpu.items()},
             model.init_arena(2, CAPACITY, dtype=torch.float32, device=dev))
            for dev in (torch.device("cpu"), cuda)]
    before = _counts()
    rng = np.random.default_rng(4)
    pos = np.zeros(2, np.int32)
    cur = np.zeros(2, np.int32)

    def admit(slot, plen):
        toks = rng.integers(0, cfg.vocab_size, (1, plen)).astype(np.int32)
        want, got = (model.prefill_into_slot(
            p, torch.from_numpy(toks).to(dev), plen, slot, arena)[0].cpu()
            for dev, p, arena in runs)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        pos[slot], cur[slot] = plen, int(want[0, -1].argmax())

    def decode(steps):
        nonlocal cur, pos
        for _ in range(steps):
            want, got = (model.decode_rows(
                p, torch.from_numpy(cur)[:, None].to(dev), arena,
                torch.from_numpy(pos).to(dev))[0].cpu()
                for dev, p, arena in runs)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
            cur = want[:, -1].argmax(-1).numpy().astype(np.int32)
            pos = pos + 1

    admit(1, 40)
    admit(0, 11)
    decode(8)
    admit(0, 23)
    decode(4)
    for cpu_seg, card_seg in zip(runs[0][2], runs[1][2]):
        for name, leaf in cpu_seg.items():
            got = card_seg[name].cpu()
            assert bool(((got.float() - leaf.float()).abs()
                         <= 1e-4 + 1e-5 * leaf.float().abs()).all()), name
    after = _counts()
    admissions, steps = 3, 12
    assert after[0] - before[0] == 2 * (admissions + steps)
    assert after[1] - before[1] == admissions
    assert after[2] - before[2] == steps


@pytest.mark.cuda
def test_hybrid_engine_on_card_serves_every_budget_as_alone(cuda):
    """bf16 smoke engine on the card: every request gets its budget's
    tokens at its exact prompt length (prompts past the window), each
    equals the same request served alone, and the kernels launch once per
    layer of their kind per admission and per decode step."""
    cfg = get_smoke(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    prompts = _prompts(cfg.vocab_size)
    budgets = [b for _, b in WORKLOAD]
    eng = Engine(model, params, max_batch=SLOTS, max_len=CAPACITY)
    before = _counts()
    outs = _run(eng, prompts, budgets)
    after = _counts()
    st = eng.stats
    assert after[0] - before[0] == 2 * (st["admissions"]
                                        + st["decode_steps"])
    assert after[1] - before[1] == st["admissions"]
    assert after[2] - before[2] == st["decode_steps"]
    assert [len(o) for o in outs] == budgets
    assert eng.prefill_shapes == {plen for plen, _ in WORKLOAD}
    for prompt, budget, out in zip(prompts, budgets, outs):
        alone = Engine(model, params, max_batch=SLOTS, max_len=CAPACITY)
        assert _run(alone, [prompt], [budget]) == [out]
