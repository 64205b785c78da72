"""Training the recurrent families (rwkv6-1.6b, recurrentgemma-2b) in the
port, against the JAX reference, at smoke size on the CPU.

The port trains a recurrent layer through `torch.autograd.Function`s
(`kernels.ops.rwkv6_scan_train`, `rglru_scan_train`) whose backward is a
hand-written kernel on the card and its plain version (`ref.rwkv6_bwd`,
`ref.rglru_gated_bwd`) on the CPU; the reference differentiates its jnp
scans with `jax.grad`. Inputs come from numpy seeds, both models from the
reference's `model.init` (`params_from_jax`), everything in f32 unless a
test says otherwise; each tolerance is named where it is used.

The card tests (marker `cuda`) import no JAX: they hold each backward
kernel against its plain version.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.trainer import make_train_step  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_cuda  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.models import rwkv6 as RW  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten, params_from_jax, state_from_jax)

RWKV, HYBRID = "rwkv6-1.6b", "recurrentgemma-2b"
# the train_loss bounds of tests/test_torch_train_paths.py: f32 sums in
# another order
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# the plain backward against autograd through the plain forward, both f32
# on the CPU: the same products summed in another order, over gradients
# of up to ~100 (unit inputs, decays to 0.99, 128 steps), so within 2e-6
# of the largest |gradient| of each input
PLAIN_REL = 2e-6


@pytest.fixture(scope="module")
def jx():
    """The JAX reference (absent on the card's machine, where only the
    `cuda` tests run)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import checkpoint as jax_ckpt
    from repro.configs import get_smoke as jax_get_smoke
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.data.tokens import agent_batches as jax_agent_batches
    from repro.dist import trainer as jax_trainer
    from repro.models import build_model as jax_build_model
    from repro.models import rglru as jax_rg
    from repro.models import rwkv6 as jax_rw
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ckpt=jax_ckpt, get_smoke=jax_get_smoke,
        TrainConfig=JaxTrainConfig, agent_batches=jax_agent_batches,
        trainer=jax_trainer, build_model=jax_build_model, rg=jax_rg,
        rw=jax_rw)


def _np(jx, tree):
    return flatten(jx.jax.device_get(tree))


def _assert_rel(got, want, rel, what):
    """|got - want| <= rel * max |want| (and want's shape)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


# ---------------------------------------------------------------------------
# the plain backward versions against autograd through the plain forwards
# ---------------------------------------------------------------------------


def _wkv_case(b, h, s, hd, seed, strong=False):
    """r, k, v [B,H,S,hd], w (decays in [0.2, 0.99], or ~exp(-exp(4)) and
    down to 1e-30 when `strong`), u, a state at 0.1, and the cotangents
    of out and of the final state, as f32 tensors."""
    rng = np.random.default_rng(seed)
    shape = (b, h, s, hd)
    r, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    if strong:
        w = np.maximum(np.exp(-np.exp(4 + rng.standard_normal(shape))),
                       1e-30).astype(np.float32)
    else:
        w = rng.uniform(0.2, 0.99, shape).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32)
    st = 0.1 * rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    dout = rng.standard_normal(shape).astype(np.float32)
    dst = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    return [torch.from_numpy(a) for a in (r, k, v, w, u, st, dout, dst)]


@pytest.mark.parametrize("s", [1, 16, 128])
@pytest.mark.parametrize("hd", [32, 64])
def test_plain_wkv_backward_matches_autograd(hd, s):
    """Every gradient of `ref.rwkv6` from a nonzero state and a nonzero
    final-state cotangent: within PLAIN_REL."""
    r, k, v, w, u, st, dout, dst = _wkv_case(2, 2, s, hd, seed=hd + s)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u, st)]
    out, final = ref.rwkv6(*leaves)
    want = torch.autograd.grad((out * dout).sum() + (final * dst).sum(),
                               leaves)
    got = ref.rwkv6_bwd(r, k, v, w, u, st, dout, dst)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                          want):
        assert g.dtype == torch.float32
        _assert_rel(g, x, PLAIN_REL, name)


def test_plain_wkv_backward_with_strong_decays():
    """Decays down to 1e-30 (S_{t-1} recomputed forward, never divided
    out of S_t): every gradient finite and within PLAIN_REL."""
    r, k, v, w, u, st, dout, dst = _wkv_case(1, 2, 40, 64, seed=7,
                                             strong=True)
    assert float(w.min()) <= 1e-29
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u, st)]
    out, final = ref.rwkv6(*leaves)
    want = torch.autograd.grad((out * dout).sum() + (final * dst).sum(),
                               leaves)
    got = ref.rwkv6_bwd(r, k, v, w, u, st, dout, dst)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                          want):
        assert bool(torch.isfinite(g).all()), name
        _assert_rel(g, x, PLAIN_REL, name)


def _rglru_case(b, s, w, seed, clamp=False, dtype=torch.float32):
    """Gate products and xa [B,S,W], biases, lamb (spread past 20, where
    softplus is linear), h0 and the cotangents of out and of the final h.
    `clamp`: gate_a near -40, so r ~ 0, a rounds to 1 and the 1e-12 clamp
    of 1 - a^2 binds."""
    rng = np.random.default_rng(seed)
    ga, gi, xa = (rng.standard_normal((b, s, w)).astype(np.float32)
                  for _ in range(3))
    if clamp:
        ga[:, ::2] -= 40.0
    ba, bi = (0.5 * rng.standard_normal(w).astype(np.float32)
              for _ in range(2))
    lamb = (3.0 * rng.standard_normal(w)).astype(np.float32)
    lamb[0] = 21.0
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    dout = rng.standard_normal((b, s, w)).astype(np.float32)
    dh = rng.standard_normal((b, w)).astype(np.float32)
    ins = [torch.from_numpy(a).to(dtype) for a in (ga, gi, ba, bi, lamb, xa)]
    return ins, torch.from_numpy(h0), torch.from_numpy(dout), \
        torch.from_numpy(dh)


@pytest.mark.parametrize("s,clamp", [(1, False), (16, False), (128, False),
                                     (16, True)],
                         ids=["S1", "S16", "S128", "S16-clamp-binds"])
def test_plain_rglru_backward_matches_autograd(s, clamp):
    """Every gradient of `ref.rglru_gated` (gate math and scan) from a
    nonzero h0 and final-h cotangent: within PLAIN_REL; where the clamp
    binds, 1 - a^2 gives no gradient on both sides."""
    ins, h0, dout, dh = _rglru_case(2, s, 24, seed=s + 100 * clamp,
                                    clamp=clamp)
    leaves = [t.clone().requires_grad_() for t in (*ins, h0)]
    out, final = ref.rglru_gated(*leaves)
    want = torch.autograd.grad((out * dout).sum() + (final * dh).sum(),
                               leaves)
    got = ref.rglru_gated_bwd(*ins, h0, dout, dh)
    names = ("dgate_a", "dgate_i", "db_a", "db_i", "dlamb", "dxa", "dh0")
    for name, g, x in zip(names, got, want):
        _assert_rel(g, x, PLAIN_REL, name)
    if clamp:
        r = torch.sigmoid(ins[0] + ins[2])
        a = torch.exp(-8.0 * torch.nn.functional.softplus(ins[4]) * r)
        assert bool((1.0 - a * a < 1e-12).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_ops_carry_gradients_in_each_inputs_dtype(dtype):
    """`ops.rwkv6_scan_train` and `ops.rglru_scan_train` on the CPU: the
    plain forward from zero, no state written, and each gradient in its
    input's dtype (w's in f32), equal to the plain backward's rounded."""
    r, k, v, w, u, _, dout, _ = _wkv_case(2, 2, 16, 32, seed=3)
    r, k, v, u = (t.to(dtype) for t in (r, k, v, u))
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    out = ops.rwkv6_scan_train(*leaves)
    want_out, _ = ref.rwkv6(r, k, v, w, u)
    assert torch.equal(out.detach(), want_out)
    grads = torch.autograd.grad(out, leaves, dout)
    want = ref.rwkv6_bwd(r, k, v, w, u, None, dout)
    for g, x, t in zip(grads, want, (r, k, v, w, u)):
        assert g.dtype == t.dtype
        assert torch.equal(g, x.to(t.dtype))

    ins, _, dout, _ = _rglru_case(2, 16, 24, seed=4, dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in ins]
    out = ops.rglru_scan_train(*leaves)
    assert out.dtype == dtype
    assert torch.equal(out.detach(), ref.rglru_gated(*ins)[0])
    grads = torch.autograd.grad(out, leaves, dout.to(dtype))
    want = ref.rglru_gated_bwd(*ins, None, dout.to(dtype))
    for g, x, t in zip(grads, want, ins):
        assert g.dtype == t.dtype
        assert torch.equal(g, x.to(t.dtype))


# ---------------------------------------------------------------------------
# the blocks' gradients against jax.grad of the reference's blocks
# ---------------------------------------------------------------------------


def _block_grads(jx, kind, s, seed):
    """jax.grad and the port's autograd of sum(block(x) * cot) for one
    layer's parameters and x [2, S, D], from the reference's zero state."""
    jnp = jx.jnp
    cfg = get_smoke(RWKV if kind == "rwkv" else HYBRID)
    key = jx.jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    if kind == "rwkv":
        jp = jx.rw.rwkv_init(key, cfg, jnp.float32)
        jfn, tfn, jstate = (jx.rw.time_mix, RW.time_mix,
                            jx.rw.init_state(cfg, 2))
    else:
        jp = jx.rg.rglru_init(key, cfg, jnp.float32)
        w = cfg.rnn_width
        # nonzero biases and a spread of lamb, so every gate has a gradient
        jp = dict(jp, b_a=jnp.asarray(0.5 * rng.standard_normal(w),
                                      jnp.float32),
                  b_i=jnp.asarray(0.5 * rng.standard_normal(w), jnp.float32),
                  lamb=jnp.asarray(rng.uniform(-2.0, 3.0, w), jnp.float32))
        jfn, tfn, jstate = (jx.rg.rglru_block, RG.rglru_block,
                            jx.rg.init_state(cfg, 2))
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jfn(p, cfg, xx, jstate)[0] * cot)

    jgp, jgx = jx.jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in
          params_from_jax(jx.jax.device_get(jp)).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, new_state = tfn(tp, cfg, tx, None)
    assert new_state is None
    # time_mix leaves the channel mix's leaves unused: zero gradients, as
    # jax.grad gives them
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [*tp.values(), tx], allow_unused=True,
                                materialize_grads=True)
    got = dict(zip(tp, grads))
    want = _np(jx, jgp)
    assert set(got) == set(want)
    got["x"], want["x"] = grads[-1], np.asarray(jgx)
    return got, want


@pytest.mark.parametrize("kind,s,sequential", [
    ("rwkv", 16, False),      # the reference scans (S % 64 != 0)
    ("rwkv", 128, True),      # REPRO_RWKV_SEQUENTIAL: the reference scans
    ("rwkv", 128, False),     # the reference's chunked form, wkv_chunked
    ("rglru", 16, False),
    ("rglru", 128, False),
], ids=["rwkv-S16", "rwkv-S128-forced-sequential", "rwkv-S128-chunked",
        "rglru-S16", "rglru-S128"])
def test_block_gradients_match_reference(jx, monkeypatch, kind, s,
                                         sequential):
    """time_mix and rglru_block in train mode (zero state, no state
    written): the gradient of every parameter and of x within rtol 1e-4
    and an atol of 1e-5 times the leaf's largest |value| where that passes
    1 (a weight's gradient sums B x S products, and f32 sums in another
    order leave an error of the leaf's scale: 2.2e-5 on rwkv6's wk, of
    largest value ~10, at S = 128) of jax.grad of the reference's block.
    The reference's chunked form at S = 128 (its forward held to
    CHUNKED_ATOL = 1e-3 in tests/test_torch_rwkv.py) takes the same bound:
    its gradients measured within 3.8e-5 of the port's on leaves of up to
    ~34, as the sequential scan's within 3.9e-5."""
    if sequential:
        monkeypatch.setenv("REPRO_RWKV_SEQUENTIAL", "1")
    else:
        monkeypatch.delenv("REPRO_RWKV_SEQUENTIAL", raising=False)
    got, want = _block_grads(jx, kind, s, seed=s)
    for k in sorted(want):
        np.testing.assert_allclose(
            got[k].numpy(), want[k], rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(1.0, float(np.abs(want[k]).max())),
            err_msg=k)


# ---------------------------------------------------------------------------
# train_loss, remat, the superstep
# ---------------------------------------------------------------------------

# recurrentgemma at S = 48 passes its smoke window of 32
SEQ = {RWKV: 16, HYBRID: 48}


@pytest.fixture(scope="module")
def models(jx):
    """{arch: (reference model, its params, port model, port params, batch
    tokens, targets)} in f32."""
    out = {}
    for arch in (RWKV, HYBRID):
        jcfg = dataclasses.replace(jx.get_smoke(arch),
                                   compute_dtype="float32")
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        jmodel = jx.build_model(jcfg)
        jparams = jmodel.init(jx.jax.random.PRNGKey(0))
        rng = np.random.default_rng(5)
        toks = rng.integers(0, cfg.vocab_size,
                            (2, SEQ[arch] + 1)).astype(np.int32)
        out[arch] = (jmodel, jparams, build_model(cfg),
                     params_from_jax(jx.jax.device_get(jparams)),
                     toks[:, :-1], toks[:, 1:])
    return out


def _port_loss_and_grads(model, params, toks, targs, remat):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = model.train_loss(leaves, {"tokens": torch.from_numpy(toks),
                                        "targets": torch.from_numpy(targs)},
                               remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", [RWKV, HYBRID])
def test_train_loss_and_every_gradient_leaf_match_reference(jx, models,
                                                            arch, remat):
    """The reference's jax.value_and_grad of train_loss with the same
    remat: loss rtol 1e-5, every gradient leaf within rtol 1e-4 / atol
    1e-5 (tests/test_torch_train_paths.py's bounds)."""
    jmodel, jparams, model, params, toks, targs = models[arch]
    jnp = jx.jnp
    (jloss, _), jgrads = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, b, remat=remat), has_aux=True))(
        jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targs)})
    jgrads = _np(jx, jgrads)
    loss, grads = _port_loss_and_grads(model, params, toks, targs, remat)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    assert set(grads) == set(jgrads)
    for k in sorted(jgrads):
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", [RWKV, HYBRID])
def test_remat_leaves_loss_and_gradients_bitwise(models, arch):
    """Checkpointing every block recomputes the same forward (the
    recurrences from a fresh zero state, nothing saved overwritten), so on
    the CPU the loss and every gradient leaf are bitwise those without."""
    _, _, model, params, toks, targs = models[arch]
    loss_r, grads_r = _port_loss_and_grads(model, params, toks, targs, True)
    loss_n, grads_n = _port_loss_and_grads(model, params, toks, targs, False)
    assert loss_r == loss_n
    for k in grads_n:
        assert torch.equal(grads_r[k], grads_n[k]), k


A, M = 4, 2
# one agent's gradient leaves in the supersteps below, port against
# reference: up to 2.8e-4 of the leaf's largest |value| (rwkv6's u and
# mu.k after one and two steps; each framework within 4e-5 of an f64
# evaluation of the reference at the fourth step's state, and the port
# no farther than the reference)
SUPERSTEP_REL = 5e-4


@pytest.mark.parametrize("arch", [RWKV, HYBRID])
def test_four_supersteps_match_reference(jx, arch):
    """Four API-BCD supersteps of the reference's make_train_step on
    `agent_batches` (2 x 16 tokens an agent), the port's taken from the
    reference's state before each (the token schedule turns through
    every agent, gacc accumulates between visits): loss rtol 1e-5; gacc,
    which holds gradients, within SUPERSTEP_REL of the leaf's largest
    |value|; params, token and zhat, which a step moves by a linear map of
    those gradients, within 1e-5 plus SUPERSTEP_REL of the largest move
    the reference's step made in the leaf.

    Each step starts from the reference's state because the trajectories
    themselves part: the recurrent smoke models' gradients are large (up
    to ~50 on the embedding, where qwen2's smoke stays near 1), a step
    moves their parameters by up to ~1 at rho = 20, and on rwkv6 f32
    noise grows ~40x a superstep."""
    jnp = jx.jnp
    jcfg = dataclasses.replace(jx.get_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    jtcfg = jx.TrainConfig(num_agents=A, model_parallel=1, num_walks=M)
    jmodel = jx.build_model(jcfg)
    jstate = jx.trainer.init_train_state(jmodel, jtcfg,
                                         key=jx.jax.random.PRNGKey(0))
    jstep = jx.jax.jit(jx.trainer.make_train_step(jmodel, jtcfg))
    step_fn = make_train_step(build_model(cfg),
                              TrainConfig(num_agents=A, num_walks=M))
    jbatches = jx.agent_batches(jcfg.vocab_size, A, 2, 16, seed=0)
    batches = agent_batches(cfg.vocab_size, A, 2, 16, seed=0)
    for step in range(4):
        jtoks, jtargs = next(jbatches)
        toks, targs = next(batches)
        np.testing.assert_array_equal(toks, jtoks)
        # copies: the jitted step donates (overwrites) the buffers that
        # jax.device_get would share on the CPU
        before = {part: flatten(jx.jax.tree.map(np.array, jstate[part]))
                  for part in ("params", "token", "zhat", "gacc")}
        state = {part: {k: torch.from_numpy(v.copy())
                        for k, v in leaves.items()}
                 for part, leaves in before.items()}
        jstate, jmetrics = jstep(jstate, {"tokens": jnp.asarray(jtoks),
                                          "targets": jnp.asarray(jtargs)},
                                 jnp.int32(step))
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(toks),
                                         "targets": torch.from_numpy(targs)},
                                 step)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
        for part in ("params", "token", "zhat", "gacc"):
            want = _np(jx, jstate[part])
            assert set(state[part]) == set(want)
            for k, v in want.items():
                if part == "gacc":
                    atol = SUPERSTEP_REL * float(np.abs(v).max())
                else:
                    moved = float(np.abs(v - before[part][k]).max())
                    atol = 1e-5 + SUPERSTEP_REL * moved
                np.testing.assert_allclose(state[part][k].numpy(), v,
                                           rtol=0, atol=atol,
                                           err_msg=f"step {step} {part}/{k}")


# ---------------------------------------------------------------------------
# checkpoints of an RWKV6 train state, read by both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rwkv_train_state(jx):
    """The reference's smoke train state at A=2, M=1, its token, zhat and
    gacc leaves filled with numpy normals (nonzero, as after steps)."""
    jcfg = dataclasses.replace(jx.get_smoke(RWKV), compute_dtype="float32")
    jtcfg = jx.TrainConfig(num_agents=2, model_parallel=1, num_walks=1)
    jstate = jx.trainer.init_train_state(jx.build_model(jcfg), jtcfg,
                                         key=jx.jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    for part in ("token", "zhat", "gacc"):
        jstate[part] = jx.jax.tree.map(
            lambda a: jx.jnp.asarray(rng.standard_normal(a.shape),
                                     a.dtype), jstate[part])
    return jstate


NESTED = {"params/segments/0/mix/mu/r": "segments.0.mix.mu.r",
          "params/segments/0/mix/cm_mu/k": "segments.0.mix.cm_mu.k"}


def test_port_rwkv_checkpoint_loads_in_reference(jx, rwkv_train_state,
                                                 tmp_path):
    """The port's save_checkpoint of an RWKV6 train state, read by the
    reference's load_checkpoint into its own state: bitwise; the nested
    mix ratios land on the reference's nested paths."""
    jstate = rwkv_train_state
    state = state_from_jax(jstate)
    ckpt.save_checkpoint(str(tmp_path), state, step=3,
                         metadata={"arch": "rwkv6-smoke"})
    with np.load(tmp_path / "arrays.npz") as data:
        for key, leaf in NESTED.items():
            np.testing.assert_array_equal(data[key],
                                          state["params"][leaf].numpy())
    zeros = jx.jax.tree.map(jx.jnp.zeros_like, jstate)
    got, step = jx.ckpt.load_checkpoint(str(tmp_path), zeros)
    assert step == 3
    want = _np(jx, jstate)
    got = _np(jx, got)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_reference_rwkv_checkpoint_loads_in_port(jx, rwkv_train_state,
                                                 tmp_path):
    """The reference's save_checkpoint of an RWKV6 train state, read by the
    port's load_checkpoint into a template of zeros: bitwise, the nested
    mix ratios on the port's dotted keys."""
    jstate = rwkv_train_state
    jx.ckpt.save_checkpoint(str(tmp_path), jstate, step=5,
                            metadata={"arch": "rwkv6-smoke"})
    want = state_from_jax(jstate)
    template = {part: {k: torch.zeros_like(v) for k, v in leaves.items()}
                for part, leaves in want.items()}
    got, step = ckpt.load_checkpoint(str(tmp_path), template)
    assert step == 5
    for leaf in NESTED.values():
        assert leaf in got["params"]
    for part, leaves in want.items():
        assert set(got[part]) == set(leaves)
        for k, v in leaves.items():
            assert got[part][k].dtype == v.dtype, k
            assert torch.equal(got[part][k], v), f"{part}/{k}"


# ---------------------------------------------------------------------------
# on the card (no JAX): each backward kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_close(got, want):
    """|kernel - plain| <= 1e-5 * rms(plain) + 1e-4 * |plain| (f32 sums in
    another order on both, chip_smoke.py's rule for the WKV kernels)."""
    want = want.float()
    err = (got.float() - want).abs()
    return bool((err <= 1e-5 * want.pow(2).mean().sqrt()
                 + 1e-4 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hd,s", [(64, 40), (32, 16), (64, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_backward_kernel_matches_plain(cuda, dtype, hd, s):
    r, k, v, w, u, st, dout, dst = (t.to(cuda) for t in
                                    _wkv_case(2, 3, s, hd, seed=s))
    r, k, v, u = (t.to(dtype) for t in (r, k, v, u))
    got = rwkv6_scan_bwd_cuda(r, k, v, w, u, st, dout, dst)
    again = rwkv6_scan_bwd_cuda(r, k, v, w, u, st, dout, dst)
    torch.cuda.synchronize()
    want = ref.rwkv6_bwd(r, k, v, w, u, st, dout, dst)
    for name, g, g2, x in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                              again, want):
        assert torch.equal(g, g2), name          # a repeat is bitwise
        assert _card_close(g, x), name


@pytest.mark.cuda
@pytest.mark.parametrize("s", [3, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_backward_kernel_matches_plain(cuda, dtype, s):
    ins, h0, dout, dh = _rglru_case(2, s, 200, seed=s, clamp=True,
                                    dtype=dtype)
    ins = [t.to(cuda) for t in ins]
    h0, dh, dout = h0.to(cuda), dh.to(cuda), dout.to(cuda, dtype)
    got = rglru_scan_bwd_cuda(*ins, h0, dout, dh)
    again = rglru_scan_bwd_cuda(*ins, h0, dout, dh)
    torch.cuda.synchronize()
    want = ref.rglru_gated_bwd(*ins, h0, dout, dh)
    names = ("dgate_a", "dgate_i", "db_a", "db_i", "dlamb", "dxa", "dh0")
    for name, g, g2, x in zip(names, got, again, want):
        assert torch.equal(g, g2), name
        assert _card_close(g, x), name


@pytest.mark.cuda
def test_train_ops_on_card_launch_the_backward_kernels(cuda):
    """One backward launch a call of each train op, gradients within the
    card rule of the CPU's, and the forward's saved inputs untouched."""
    r, k, v, w, u, _, dout, _ = _wkv_case(2, 2, 40, 64, seed=9)
    leaves = [t.to(cuda).requires_grad_() for t in (r, k, v, w, u)]
    before = rwkv6_scan_bwd_cuda.launches
    grads = torch.autograd.grad(ops.rwkv6_scan_train(*leaves), leaves,
                                dout.to(cuda))
    assert rwkv6_scan_bwd_cuda.launches == before + 1
    for g, x in zip(grads, ref.rwkv6_bwd(r, k, v, w, u, None, dout)):
        assert _card_close(g.cpu(), x)
    ins, _, dout, _ = _rglru_case(2, 40, 64, seed=10)
    leaves = [t.to(cuda).requires_grad_() for t in ins]
    before = rglru_scan_bwd_cuda.launches
    grads = torch.autograd.grad(ops.rglru_scan_train(*leaves), leaves,
                                dout.to(cuda))
    assert rglru_scan_bwd_cuda.launches == before + 1
    for g, x in zip(grads, ref.rglru_gated_bwd(*ins, None, dout)):
        assert _card_close(g.cpu(), x)
