"""The MoE family (dbrx-132b) in the port against the JAX reference, at
smoke size on the CPU.

Both sides start from the reference's parameters (`params_from_jax`), see
inputs made with numpy and run in f32 unless a test says otherwise.
`moe_apply` and `moe_apply_scatter` alone agree to rtol 1e-5 / atol 1e-6
(out) and rtol 1e-5 (aux): the port dispatches by gathers where the
reference multiplies one-hots, which copies the same rows, and sums a
token's k expert outputs in another order. Ties among the router's
probabilities break to the lower expert on both sides. The model's
loss, aux and gradients, one API-BCD superstep and the serving engine
are held as the other families' tests hold them.

The card tests (marker `cuda`) import no JAX: they hold the MoE on the
card against the CPU and a decode step against its repeat.
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
from repro_torch.configs.base import ArchConfig, MoEConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.trainer import make_train_step  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    arena_from_jax, flatten, params_from_jax, state_from_jax)
from repro_torch.serve import Engine, probe_family_caps  # noqa: E402

ARCH = "dbrx-132b"
RTOL, ATOL = 1e-5, 1e-6         # moe_apply alone: f32 sums in another order
LOSS_RTOL = 1e-5
# gradients and serving logits: f32 sums in another order, within 1e-5
# of the leaf's (or the logits') scale
GRAD_ATOL = 1e-5
SLOTS, CAPACITY = 3, 32
# bf16 serving logits, as a fraction of max |reference logit|: the port's
# bf16 path lies within it and its f32 path (the control) does not.
# Measured on the CPU (the port's bf16 against the reference's bf16, then
# the f32 control): 0.0158 / 0.0179; the limit sits between them. The
# bf16 paths part mostly at silu (XLA's bf16 sigmoid and PyTorch's round
# differently; the router's bf16 logits agree bitwise).
BF16_LOGIT_RTOL = 0.017


@pytest.fixture(scope="module")
def jx():
    """The JAX reference (absent on the card's machine: only the `cuda`
    tests run there)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as jax_get_smoke
    from repro.configs.base import ArchConfig as JaxArchConfig
    from repro.configs.base import MoEConfig as JaxMoEConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.dist import trainer as jax_trainer
    from repro.models import build_model as jax_build_model
    from repro.models import moe as jax_moe
    from repro.serve import Engine as JaxEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_smoke=jax_get_smoke, ArchConfig=JaxArchConfig,
        MoEConfig=JaxMoEConfig, TrainConfig=JaxTrainConfig,
        trainer=jax_trainer, build_model=jax_build_model, moe=jax_moe,
        Engine=JaxEngine)


def _np(jx, tree):
    return flatten(jx.jax.device_get(tree))


# ---------------------------------------------------------------------------
# moe_apply and moe_apply_scatter alone
# ---------------------------------------------------------------------------


def _moe_cfgs(jx, **moe):
    """(reference config, port config): d_model 32, 6 experts top 2 of
    width 48 unless `moe` says otherwise."""
    arch = dict(name="moe-test", family="moe", source="test", num_layers=1,
                d_model=32, num_heads=2, num_kv_heads=1, d_ff=48,
                vocab_size=64)
    moe = dict(dict(num_experts=6, top_k=2, d_ff_expert=48), **moe)
    return (jx.ArchConfig(**arch, moe=jx.MoEConfig(**moe)),
            ArchConfig(**arch, moe=MoEConfig(**moe)))


# (B, S, MoEConfig fields, skew, drops): skew leans every token to
# expert 0, so its buckets overflow at cf 1.25; drops says whether some
# slot is dropped (random routing at cf 1.25 drops a few too)
MOE_CASES = {
    "generous": (1, 24, dict(capacity_factor=8.0), False, False),
    "drops": (1, 40, dict(capacity_factor=1.25), True, True),
    "shared": (1, 24, dict(num_shared_experts=1), False, True),
    "groups": (3, 16, dict(capacity_factor=1.25), True, True),
}


def _moe_case(jx, case, seed=0):
    """(reference params, config, port params, config, x [B, S, D])."""
    b, s, moe, skew, _ = MOE_CASES[case]
    jcfg, cfg = _moe_cfgs(jx, **moe)
    jparams = jx.moe.moe_init(jx.jax.random.PRNGKey(seed), jcfg,
                              jx.jnp.float32)
    params = params_from_jax(jx.jax.device_get(jparams))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if skew:
        router = np.asarray(jparams["router"]).copy()
        router[:, 0] = np.abs(router[:, 0]) + 0.5
        x += 1.0
        jparams["router"] = jx.jnp.asarray(router)
        params["router"] = torch.from_numpy(router)
    return jparams, jcfg, params, cfg, x


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("variant", ["moe_apply", "moe_apply_scatter"])
def test_moe_matches_reference(jx, variant, case):
    jparams, jcfg, params, cfg, x = _moe_case(jx, case)
    want, want_aux = getattr(jx.moe, variant)(jparams, jcfg,
                                              jx.jnp.asarray(x))
    got, got_aux = getattr(MOE, variant)(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)
    # slots dropped, per sequence or over the batch (the scatter variant's
    # one capacity), as the case says
    b, s, _, _, drops = MOE_CASES[case]
    _, _, gate_i = MOE.route(params, cfg, torch.from_numpy(x))
    tokens = s if variant == "moe_apply" else b * s
    pos = MOE.bucket_positions(gate_i.reshape(-1, tokens, cfg.moe.top_k),
                               cfg.moe.num_experts)
    assert bool((pos >= MOE.capacity(cfg, tokens)).any()) == drops


def test_moe_without_aux_returns_the_same_output(jx):
    jparams, jcfg, params, cfg, x = _moe_case(jx, "groups")
    for fn in (MOE.moe_apply, MOE.moe_apply_scatter):
        out, aux = fn(params, cfg, torch.from_numpy(x))
        out2, none = fn(params, cfg, torch.from_numpy(x), with_aux=False)
        assert none is None and torch.equal(out, out2)


def test_router_ties_break_as_jax_top_k(jx):
    """Experts 1 and 3 copy expert 0's router column and expert 4 copies
    expert 2's, so probabilities tie inside the top 3 and at its edge.
    The port picks jax.lax.top_k's experts (the lower index first), where
    torch.topk picks others, and the outputs agree."""
    jcfg, cfg = _moe_cfgs(jx, top_k=3)
    jparams = jx.moe.moe_init(jx.jax.random.PRNGKey(1), jcfg, jx.jnp.float32)
    router = np.asarray(jparams["router"]).copy()
    router[:, 1] = router[:, 3] = router[:, 0]
    router[:, 4] = router[:, 2]
    jparams["router"] = jx.jnp.asarray(router)
    params = params_from_jax(jx.jax.device_get(jparams))
    x = np.random.default_rng(2).standard_normal((2, 30, 32)).astype(
        np.float32)
    # the reference's routing, as moe_apply computes it
    probs = jx.jax.nn.softmax(jx.jnp.asarray(x) @ jparams["router"], axis=-1)
    _, want = jx.jax.lax.top_k(probs, 3)
    probs_t, _, got = MOE.route(params, cfg, torch.from_numpy(x))
    # the ties are real on both sides
    probs = np.asarray(probs)
    for a, b in ((0, 1), (0, 3), (2, 4)):
        assert torch.equal(probs_t[..., a], probs_t[..., b])
        assert np.array_equal(probs[..., a], probs[..., b])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the control: torch.topk breaks the same ties otherwise
    _, other = torch.topk(probs_t, 3)
    assert not np.array_equal(other.numpy(), np.asarray(want))
    for variant in ("moe_apply", "moe_apply_scatter"):
        jout, _ = getattr(jx.moe, variant)(jparams, jcfg, jx.jnp.asarray(x))
        out, _ = getattr(MOE, variant)(params, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# the model: init, train_loss, gradients, the superstep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(jx):
    """(reference model, its params, port model, the params converted),
    dbrx's smoke config in f32."""
    jcfg = dataclasses.replace(jx.get_smoke(ARCH), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jmodel = jx.build_model(jcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    return jmodel, jparams, build_model(cfg), params_from_jax(
        jx.jax.device_get(jparams))


def test_init_keys_shapes_and_scales_match_reference(jx, served):
    """The port's own init has the reference's leaves
    (segments.0.moe.router, w_gate, w_up, w_down; no mlp) and shapes, and
    each leaf's std lies within 10 % of the reference's."""
    _, jparams, model, _ = served
    want = _np(jx, jparams)
    got = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert "segments.0.moe.w_gate" in got
    assert not any(".mlp." in k for k in got)
    for k, v in want.items():
        if v.std() > 0:
            assert abs(float(got[k].float().std()) / float(v.std()) - 1) \
                < 0.1, k
        else:
            assert float(got[k].float().std()) == 0, k


def test_shared_experts_init_as_reference(jx):
    """With num_shared_experts the block also holds moe.shared.* leaves,
    as the reference's (deepseek's shared experts are this; its MLA is
    what keeps deepseek unported)."""
    jcfg = dataclasses.replace(
        jx.get_smoke(ARCH), moe=dataclasses.replace(jx.get_smoke(ARCH).moe,
                                                    num_shared_experts=1))
    cfg = dataclasses.replace(
        get_smoke(ARCH), moe=dataclasses.replace(get_smoke(ARCH).moe,
                                                 num_shared_experts=1))
    want = _np(jx, jx.build_model(jcfg).init(jx.jax.random.PRNGKey(0)))
    got = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert "segments.0.moe.shared.w_down" in got


def _batch(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_loss_and_grads(model, params, toks, targs, remat):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, metrics = model.train_loss(
        leaves, {"tokens": torch.from_numpy(toks),
                 "targets": torch.from_numpy(targs)}, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return ({k: float(v) for k, v in dict(metrics, loss=loss).items()},
            dict(zip(leaves, grads)))


@pytest.mark.parametrize("scatter", [False, True], ids=["gshard", "scatter"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_loss_aux_and_every_gradient_match_reference(
        jx, served, monkeypatch, remat, scatter):
    """loss, nll and aux (nonzero) within rtol 1e-5; every gradient leaf,
    the router's included, within 1e-5 of its leaf's largest |gradient|
    (at least 1); REPRO_MOE_SCATTER selects the scatter variant on both
    sides, read where the block runs."""
    if scatter:
        monkeypatch.setenv("REPRO_MOE_SCATTER", "1")
    jmodel, jparams, model, params = served
    toks, targs = _batch(model.cfg.vocab_size, 2, 24, 5)
    jnp = jx.jnp
    (jloss, jmetrics), jgrads = jx.jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, b, remat=remat), has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targs)})
    jgrads = _np(jx, jgrads)
    metrics, grads = _port_loss_and_grads(model, params, toks, targs, remat)
    assert metrics["aux"] > 0
    for name, want in (("loss", jloss), ("nll", jmetrics["nll"]),
                       ("aux", jmetrics["aux"])):
        np.testing.assert_allclose(metrics[name], float(want),
                                   rtol=LOSS_RTOL, err_msg=name)
    assert set(grads) == set(jgrads)
    assert float(jnp.abs(jgrads["segments.0.moe.router"]).max()) > 0
    for k in sorted(jgrads):
        atol = GRAD_ATOL * max(1.0, float(np.abs(jgrads[k]).max()))
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k], rtol=0,
                                   atol=atol, err_msg=k)


def test_one_superstep_matches_reference(jx):
    """One API-BCD superstep of the reference's make_train_step and the
    port's from one state (A=4, M=2, 2 x 16 tokens an agent): loss rtol
    1e-5; params, token and zhat within 1e-4, gacc within 1e-4 of its
    leaf's largest |value| where that passes 1 (chip_smoke phase 37's
    rule); one prox launch a leaf on the card is phase 38's."""
    jnp = jx.jnp
    a, m = 4, 2
    jcfg = dataclasses.replace(jx.get_smoke(ARCH), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jtcfg = jx.TrainConfig(num_agents=a, model_parallel=1, num_walks=m)
    jmodel = jx.build_model(jcfg)
    jstate = jx.trainer.init_train_state(jmodel, jtcfg,
                                         key=jx.jax.random.PRNGKey(0))
    # copies: the jitted step donates the buffers device_get would share
    state = state_from_jax(jx.jax.tree.map(np.array, jstate))
    toks, targs = next(agent_batches(cfg.vocab_size, a, 2, 16, seed=0))
    jstate, jmetrics = jx.jax.jit(jx.trainer.make_train_step(jmodel, jtcfg))(
        jstate, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targs)},
        jnp.int32(0))
    state, metrics = make_train_step(
        build_model(cfg), TrainConfig(num_agents=a, num_walks=m))(
        state, {"tokens": torch.from_numpy(toks),
                "targets": torch.from_numpy(targs)}, 0)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=LOSS_RTOL)
    assert float(metrics["aux"]) > 0
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]),
                               rtol=LOSS_RTOL)
    for part in ("params", "token", "zhat", "gacc"):
        want = _np(jx, jstate[part])
        assert set(state[part]) == set(want)
        for k, v in want.items():
            atol = 1e-4 * (max(1.0, float(np.abs(v).max()))
                           if part == "gacc" else 1.0)
            np.testing.assert_allclose(state[part][k].numpy(), v, rtol=0,
                                       atol=atol, err_msg=f"{part}/{k}")


# ---------------------------------------------------------------------------
# serving: the arena only, every prompt at its exact length
# ---------------------------------------------------------------------------


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


def _run(engine, prompts, budgets):
    uids = [engine.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    done = {r.uid: r for r in engine.run()}
    return [done[u].output.tolist() for u in uids]


def test_family_caps_and_pool_refusal(served):
    """The reference's probe gives MoE (False, False, False, False): no
    padding, no pages, no chunks, no mixed step; init_pool refuses with
    the reference's reason."""
    _, _, model, _ = served
    assert tuple(dataclasses.astuple(probe_family_caps(
        model, capacity=CAPACITY))) == (False, False, False, False)
    assert model.init_pool is None and model.mixed_step_tokens is None
    with pytest.raises(NotImplementedError, match="capacity"):
        TF.init_pool(model.cfg, 4, 4)


def test_engine_matches_reference_with_mid_flight_admission(jx, served):
    """The port's copy of tests/test_server.py's other-families check on
    dbrx: a request admitted mid-flight gets the tokens of the reference's
    engine serving it alone, and every prompt prefills at its exact
    length (prefill_shapes == {5, 7})."""
    jmodel, jparams, model, params = served
    a, b = _prompts(model.cfg.vocab_size, (5, 7), 14)
    ref = jx.Engine(jmodel, jparams, max_batch=2, max_len=CAPACITY,
                    cache_dtype=jx.jnp.float32)
    ref.submit(a, max_new_tokens=4)
    want = ref.run()[0].output.tolist()
    eng = Engine(model, params, max_batch=2, max_len=CAPACITY,
                 cache_dtype=torch.float32)
    eng.submit(b, max_new_tokens=8)
    eng.step()
    eng.step()
    uid = eng.submit(a, max_new_tokens=4)
    outs = {r.uid: r.output.tolist() for r in eng.run()}
    assert outs[uid] == want
    assert eng.prefill_shapes == {5, 7}
    assert not eng.overlap


def test_engine_workload_matches_reference(jx, served):
    """More requests than slots, mixed lengths and budgets: every token
    equal to the reference's engine's."""
    jmodel, jparams, model, params = served
    lengths, budgets = (5, 11, 3, 8, 14, 2, 9), [6, 3, 9, 1, 5, 7, 4]
    prompts = _prompts(model.cfg.vocab_size, lengths, 7)
    eng = Engine(model, params, max_batch=SLOTS, max_len=CAPACITY,
                 cache_dtype=torch.float32)
    jeng = jx.Engine(jmodel, jparams, max_batch=SLOTS, max_len=CAPACITY,
                     cache_dtype=jx.jnp.float32)
    assert _run(eng, prompts, budgets) == _run(jeng, prompts, budgets)
    assert eng.prefill_shapes == set(lengths)


def test_engine_paged_falls_back_to_arena(served):
    """The port's copy of tests/test_server.py's
    test_engine_paged_auto_selects_arena for dbrx: paged=True serves from
    the arena, with the arena's tokens."""
    _, _, model, params = served
    (prompt,) = _prompts(model.cfg.vocab_size, (5,), 24)
    eng = Engine(model, params, max_batch=2, max_len=CAPACITY, paged=True)
    assert not eng.paged, "moe chunking changes routing capacity"
    ref = Engine(model, params, max_batch=2, max_len=CAPACITY)
    assert _run(eng, [prompt], [4]) == _run(ref, [prompt], [4])


def test_arena_caches_and_logits_match_reference(jx, served):
    """prefill_into_slot at exact lengths into slots 0 and 2 and 6
    decode_rows steps: logits within 1e-5 of their scale, and the
    reference's arena, converted with arena_from_jax, equal to the port's
    (k, v within 1e-5, ptr exact)."""
    jmodel, jparams, model, params = served
    jnp = jx.jnp
    jarena = jmodel.init_arena(SLOTS, CAPACITY, dtype=jnp.float32)
    arena = model.init_arena(SLOTS, CAPACITY, dtype=torch.float32)
    pos = np.zeros(SLOTS, np.int32)
    cur = np.zeros(SLOTS, np.int32)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAD_ATOL
                                   * max(1.0, float(np.abs(want).max())))

    for slot, prompt in zip((0, 2), _prompts(model.cfg.vocab_size, (9, 4),
                                             3)):
        toks = prompt[None]
        jl, jarena = jmodel.prefill_into_slot(
            jparams, jnp.asarray(toks), jnp.int32(len(prompt)),
            jnp.int32(slot), jarena)
        tl, arena = model.prefill_into_slot(params, torch.from_numpy(toks),
                                            len(prompt), slot, arena)
        close(tl, jl)
        pos[slot], cur[slot] = len(prompt), int(jnp.argmax(jl[0, -1]))
    for _ in range(6):
        jl, jarena = jmodel.decode_rows(jparams, jnp.asarray(cur)[:, None],
                                        jarena, jnp.asarray(pos))
        tl, arena = model.decode_rows(params, torch.from_numpy(cur)[:, None],
                                      arena, torch.from_numpy(pos))
        close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
        cur = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
        pos = pos + 1
    (want,) = arena_from_jax(jx.jax.device_get(jarena))
    assert torch.equal(arena[0]["ptr"], want["ptr"])
    for name in ("k", "v"):
        close(arena[0][name][:, [0, 2]], want[name][:, [0, 2]].numpy())


def test_decode_row_batched_equals_the_row_alone(served):
    """Each decode row is its own routing group (capacity 4 >= k at S =
    1), so a row's logits do not depend on the other rows: bitwise equal
    in an arena whose other slots hold other requests and in one where
    they are empty."""
    _, _, model, params = served
    prompts = _prompts(model.cfg.vocab_size, (6, 9, 4), 31)
    busy = model.init_arena(SLOTS, CAPACITY, dtype=torch.float32)
    alone = model.init_arena(SLOTS, CAPACITY, dtype=torch.float32)
    for slot, prompt in enumerate(prompts):
        model.prefill_into_slot(params, torch.from_numpy(prompt[None]),
                                len(prompt), slot, busy)
    model.prefill_into_slot(params, torch.from_numpy(prompts[1][None]),
                            len(prompts[1]), 1, alone)
    tok = torch.tensor([[3], [17], [101]])
    pos = torch.tensor([6, 9, 4], dtype=torch.int32)
    for _ in range(4):
        lb, _ = model.decode_rows(params, tok, busy, pos)
        la, _ = model.decode_rows(params, tok, alone, pos)
        assert torch.equal(lb[1], la[1])
        tok, pos = lb[:, -1].argmax(-1)[:, None], pos + 1


def _bf16_logit_error(jx, jmodel, jparams, model, params, cache_dtype):
    """max |port - reference| / max |reference| over the logits of two
    exact-length admissions and 8 decode steps (the reference in bf16
    compute and cache), each side continuing from the reference's
    tokens."""
    jnp = jx.jnp
    jarena = jmodel.init_arena(SLOTS, CAPACITY, dtype=jnp.bfloat16)
    arena = model.init_arena(SLOTS, CAPACITY, dtype=cache_dtype)
    pos = np.zeros(SLOTS, np.int32)
    cur = np.zeros(SLOTS, np.int32)
    worst = 0.0

    def err(tl, jl):
        nonlocal worst
        want = np.asarray(jl, np.float32)
        worst = max(worst, float(np.abs(tl.float().numpy() - want).max())
                    / float(np.abs(want).max()))

    for slot, prompt in zip((0, 2), _prompts(model.cfg.vocab_size, (11, 6),
                                             55)):
        jl, jarena = jmodel.prefill_into_slot(
            jparams, jnp.asarray(prompt[None]), jnp.int32(len(prompt)),
            jnp.int32(slot), jarena)
        tl, arena = model.prefill_into_slot(
            params, torch.from_numpy(prompt[None]), len(prompt), slot, arena)
        err(tl, jl)
        pos[slot], cur[slot] = len(prompt), int(jnp.argmax(jl[0, -1]))
    for _ in range(8):
        jl, jarena = jmodel.decode_rows(jparams, jnp.asarray(cur)[:, None],
                                        jarena, jnp.asarray(pos))
        tl, arena = model.decode_rows(params, torch.from_numpy(cur)[:, None],
                                      arena, torch.from_numpy(pos))
        err(tl[[0, 2]], np.asarray(jl)[[0, 2]])
        cur, pos = np.array(jnp.argmax(jl[:, -1], -1), np.int32), pos + 1
    return worst


def test_bf16_serving_logits_within_share_of_reference(jx):
    """dbrx's smoke config in its own bf16 compute: the port's logits lie
    within BF16_LOGIT_RTOL of the reference's largest |logit|, and the
    port's f32 path, the control, does not (so the bound can tell)."""
    jmodel = jx.build_model(jx.get_smoke(ARCH))
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    params = params_from_jax(jx.jax.device_get(jparams))
    cfg = get_smoke(ARCH)
    assert cfg.compute_dtype == "bfloat16"
    bf16 = _bf16_logit_error(jx, jmodel, jparams, build_model(cfg), params,
                             torch.bfloat16)
    f32 = _bf16_logit_error(
        jx, jmodel, jparams,
        build_model(dataclasses.replace(cfg, compute_dtype="float32")),
        params, torch.float32)
    assert bf16 <= BF16_LOGIT_RTOL < f32, (bf16, f32)


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["arena", "paged"])
def test_serve_cli_on_cpu(capsys, paged):
    argv = ["--arch", ARCH, "--smoke", "--requests", "4", "--max-batch",
            "2", "--prompt-len", "8", "--new-tokens", "4", "--device",
            "cpu"] + (["--paged"] if paged else [])
    out = serve_cli.serve(serve_cli.parse_args(argv))
    assert [len(o) for o in out["outputs"]] == out["budgets"]
    assert out["prefill_shapes"] == [8] and not out["paged"]
    text = capsys.readouterr().out
    assert "(arena, serialized)" in text
    assert ("cannot page (moe routing capacity depends on the chunk "
            "length)" in text) == paged


def test_serve_cli_names_the_recurrent_reason(capsys):
    argv = ["--arch", "rwkv6-1.6b", "--smoke", "--requests", "2",
            "--max-batch", "2", "--prompt-len", "8", "--new-tokens", "2",
            "--device", "cpu", "--paged"]
    serve_cli.serve(serve_cli.parse_args(argv))
    assert "cannot page (recurrent state)" in capsys.readouterr().out


def test_serve_cli_cuts_layers():
    args = serve_cli.parse_args(["--arch", ARCH, "--smoke", "--layers", "1",
                                 "--device", "cpu"])
    _, cfg, _, params = serve_cli.build(args)
    assert cfg.num_layers == 1 and cfg.layer_types == ("moe",)
    assert params["segments.0.moe.w_gate"].shape[0] == 1


@pytest.mark.parametrize("baseline", [False, True], ids=["apibcd",
                                                         "baseline"])
def test_train_cli_on_cpu(baseline):
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--seq", "16",
            "--batch-per-agent", "1", "--log-every", "0", "--device", "cpu"]
    out = train_cli.train(train_cli.parse_args(
        argv + (["--baseline"] if baseline else [])))
    assert np.all(np.isfinite(out["losses"]))
    assert all(a > 0 for a in out["auxs"])


def test_full_config_builds_with_bf16_parameters():
    """dbrx-132b itself builds; its widths cut here (the dtype and the
    leaves are all this checks)."""
    full = get_config(ARCH)
    model = build_model(full)
    assert model.init_pool is None and full.param_dtype == "bfloat16"
    cfg = dataclasses.replace(full, num_layers=1, layer_types=("moe",),
                              d_model=64, num_heads=4, num_kv_heads=2,
                              head_dim=16, d_ff=32, vocab_size=64,
                              moe=dataclasses.replace(full.moe,
                                                      d_ff_expert=32))
    params = TF.transformer_init(cfg, torch.Generator().manual_seed(0))
    assert {v.dtype for v in params.values()} == {torch.bfloat16}
    assert params["segments.0.moe.w_gate"].shape == (1, 16, 64, 32)


# ---------------------------------------------------------------------------
# on the card (no JAX)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["moe_apply", "moe_apply_scatter"])
def test_moe_on_card_matches_cpu(cuda, monkeypatch, variant):
    """f32 (TF32 off), slots dropped at cf 1.25: out within 1e-5 (f32
    products summed in another order), aux within rtol 1e-5."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_smoke(ARCH)
    p = TF.transformer_init(dataclasses.replace(cfg, param_dtype="float32"),
                            torch.Generator().manual_seed(0))
    params = {k[len("segments.0.moe."):]: v[0] for k, v in p.items()
              if k.startswith("segments.0.moe.")}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    want, want_aux = getattr(MOE, variant)(params, cfg, x)
    got, got_aux = getattr(MOE, variant)(
        {k: v.to(cuda) for k, v in params.items()}, cfg, x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_decode_step_on_card_repeats_bitwise(cuda):
    """bf16 smoke config on the card: a decode step over 3 live rows run
    twice on copies of one arena gives the same logits bitwise (no
    atomics in dispatch or combine)."""
    cfg = get_smoke(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    arena = model.init_arena(SLOTS, CAPACITY, device=cuda)
    for slot, prompt in enumerate(_prompts(cfg.vocab_size, (6, 9, 4), 31)):
        model.prefill_into_slot(params, torch.from_numpy(prompt[None]).to(
            cuda), len(prompt), slot, arena)
    tok = torch.tensor([[3], [17], [101]], device=cuda)
    pos = torch.tensor([6, 9, 4], dtype=torch.int32, device=cuda)
    copies = [[{k: v.clone() for k, v in seg.items()} for seg in arena]
              for _ in range(2)]
    first, second = (model.decode_rows(params, tok, c, pos)[0]
                     for c in copies)
    assert torch.equal(first, second)
