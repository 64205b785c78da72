"""The rest of the dense family in the port against the JAX reference, at
smoke size on the CPU: internlm2-1.8b (plain GQA), qwen3-8b (qk-norm)
and nemotron-4-15b (the squared-ReLU MLP, bf16 parameters).

Both sides start from the reference's `model.init` (converted with
`params_from_jax`), see inputs made with numpy and run in f32: loss,
gradients, train state, logits and caches agree to atol 1e-5 (only the
order of f32 sums differs), greedy tokens are equal. The engines are held
against the reference's arena engine at its default (overlapped)
scheduler; its paged GQA engine is no ground truth (two of its own tests
fail, ROADMAP). The bf16 cases hold the smoke configs' own compute dtype
within a stated fraction of the largest |logit| of the reference's, with
the port's f32 path as the control, as tests/test_torch_mixed.py does for
qwen2. The mixed-step checks and the bf16 logit walk are
tests/test_torch_mixed.py's, run on these models.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.trainer import make_train_step  # noqa: E402
from repro_torch.models import attention, build_model, layers  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    arena_from_jax, flatten, params_from_jax, pool_from_jax, state_from_jax)
from repro_torch.serve import Engine  # noqa: E402
from test_torch_mixed import _run_staggered  # noqa: E402
from test_torch_mixed import _serving_logit_errors  # noqa: E402
from test_torch_mixed import (  # noqa: E402
    test_mixed_step_paged_tokens_matches_reference as _mixed_paged_check)
from test_torch_mixed import (  # noqa: E402
    test_mixed_step_tokens_matches_reference as _mixed_arena_check)

ARCHS = ("internlm2-1.8b", "qwen3-8b", "nemotron-4-15b")
ATOL = 1e-5
A, M = 4, 2
STATE_KEYS = ("params", "token", "zhat", "gacc")
# bf16 serving logits, as a fraction of max |reference logit|: each
# config's bf16 path lies within it and its f32 path (the control) does
# not. Measured on the CPU (the port's bf16 against the reference's bf16,
# then the f32 control): internlm2 0.0137 / 0.0222, qwen3 0.0150 /
# 0.0207, nemotron 0.0132 / 0.0168; the limit sits between the largest
# bf16 error and the smallest control.
BF16_LOGIT_RTOL = 0.016


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs import get_smoke as jax_get_smoke
    from repro.configs import get_train as jax_get_train
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.dist import trainer as jax_trainer
    from repro.models import attention as jax_attention
    from repro.models import build_model as jax_build_model
    from repro.models import layers as jax_layers
    from repro.serve import Engine as JaxEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config, get_smoke=jax_get_smoke,
        get_train=jax_get_train, TrainConfig=JaxTrainConfig,
        trainer=jax_trainer, attention=jax_attention,
        build_model=jax_build_model, layers=jax_layers, Engine=JaxEngine)


def _models(jx, arch, compute_dtype="float32", **overrides):
    """(reference model, its params, port model, the params converted)
    from the smoke config with `overrides`."""
    jcfg = dataclasses.replace(jx.get_smoke(arch),
                               compute_dtype=compute_dtype, **overrides)
    tcfg = dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype,
                               **overrides)
    jmodel = jx.build_model(jcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    tparams = params_from_jax(jx.jax.device_get(jparams))
    return jmodel, jparams, build_model(tcfg), tparams


@pytest.fixture(scope="module", params=ARCHS)
def served(jx, request):
    return _models(jx, request.param)


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


def _bf16_ulp(v):
    """Spacing of bf16 values at |v|: 2^(e-8) for |v| = m * 2^e, m in
    [.5, 1)."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg=what)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("part", ["config", "smoke", "train"])
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_configs_equal_reference(jx, arch, part):
    """Every ported id's full config and smoke config equal the
    reference's field by field; its TRAIN equals the reference's on the
    fields the port's TrainConfig has (the mesh-only ones, such as
    model_parallel, are not ported)."""
    if part == "config":
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jx.get_config(arch))
    elif part == "smoke":
        assert dataclasses.asdict(get_smoke(arch)) == dataclasses.asdict(
            jx.get_smoke(arch))
    else:
        from repro_torch.configs import _module
        want = jx.get_train(arch)
        got = _module(arch).TRAIN
        assert dataclasses.asdict(got) == {
            f.name: getattr(want, f.name)
            for f in dataclasses.fields(TrainConfig)}


def test_param_names_shapes_and_dtypes_match_reference(jx, served):
    """The port's own init has the reference's leaves, shapes and dtypes
    (q_norm/k_norm for qwen3, no w_gate for nemotron's squared ReLU)."""
    jmodel, jparams, tmodel, _ = served
    want = flatten(jx.jax.device_get(jparams))
    got = tmodel.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(str(v.dtype).removeprefix("torch.") == want[k].dtype.name
               for k, v in got.items())
    cfg = tmodel.cfg
    assert ("segments.0.attn.q_norm.scale" in got) == cfg.qk_norm
    assert ("segments.0.mlp.w_gate" in got) == (cfg.mlp_type == "swiglu")


def test_nemotron_full_config_inits_bf16_leaves():
    """nemotron-4-15b's param_dtype makes every leaf bf16 (its widths cut
    here; the dtype is all this checks)."""
    cfg = dataclasses.replace(
        get_config("nemotron-4-15b"), num_layers=2, layer_types=("attn",) * 2,
        d_model=96, num_heads=6, num_kv_heads=2, head_dim=16, d_ff=192,
        vocab_size=64)
    assert cfg.param_dtype == "bfloat16" and cfg.mlp_type == "sq_relu"
    params = TF.transformer_init(cfg, torch.Generator().manual_seed(0))
    assert {v.dtype for v in params.values()} == {torch.bfloat16}
    assert "segments.0.mlp.w_gate" not in params


# variants of the dense stack that the reference builds: phi-3-vision's
# family "vlm" with its patch prefix, layernorm in every norm, a gelu MLP
@pytest.mark.parametrize("change", [
    dict(family="vlm", frontend="vision", num_patches=16),
    dict(norm_type="layernorm"), dict(mlp_type="gelu")],
    ids=["vlm", "layernorm", "gelu-dense"])
def test_unported_dense_variants_still_raise(jx, change):
    """Each variant of qwen3-8b's smoke config builds, and its f32
    train_loss and prefill (a patch prefix with the vlm) match the
    reference's from the reference's parameters: loss rtol 1e-5, logits
    and caches to atol 1e-5."""
    jmodel, jparams, tmodel, tparams = _models(jx, "qwen3-8b", **change)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tmodel.cfg.vocab_size, (2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if change.get("num_patches"):
        batch["patches"] = rng.standard_normal(
            (2, 16, tmodel.cfg.d_model)).astype(np.float32)
    if change.get("norm_type"):
        assert "segments.0.ln1.bias" in tparams
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jloss, _ = jmodel.train_loss(jparams, jb)
    loss, _ = tmodel.train_loss(tparams, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    del jb["targets"], tb["targets"]
    jl, jc = jmodel.prefill(jparams, jb, cache_dtype=jx.jnp.float32,
                            cache_len=40)
    tl, tc = tmodel.prefill(tparams, tb, cache_dtype=torch.float32,
                            cache_len=40)
    _close(tl, jl, "logits")
    for name, want in jc[0].items():
        _close(tc[0][name], np.asarray(want), name)


# ---------------------------------------------------------------------------
# the new pieces, alone
# ---------------------------------------------------------------------------


def test_sq_relu_mlp_matches_reference(jx):
    rng = np.random.default_rng(1)
    d, ff = 24, 40
    p = {"w_up": rng.standard_normal((d, ff)).astype(np.float32) / 5,
         "w_down": rng.standard_normal((ff, d)).astype(np.float32) / 6}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = jx.layers.mlp_apply({k: jx.jnp.asarray(v) for k, v in p.items()},
                               jx.jnp.asarray(x), "sq_relu")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = layers.mlp_apply(tp, torch.from_numpy(x), "sq_relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    hidden = layers.mlp_hidden(tp, torch.from_numpy(x), "sq_relu")
    assert float(hidden.min()) >= 0.0


def test_project_qkv_with_qk_norm_matches_reference(jx):
    """qk-norm over hd after the reshape, before rope: q, k and v of the
    reference's `_project_qkv`, with norm scales that are not 1."""
    cfg = get_smoke("qwen3-8b")
    assert cfg.qk_norm
    rng = np.random.default_rng(2)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": rng.standard_normal((d, h * hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, kv * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, kv * hd)) / np.sqrt(d),
         "q_norm.scale": 1 + rng.standard_normal(hd) / 4,
         "k_norm.scale": 1 + rng.standard_normal(hd) / 4}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10), (2, 7)).astype(np.int32)
    jp = {k: jx.jnp.asarray(v) for k, v in p.items()
          if not k.endswith(".scale")}
    jp.update({k.split(".")[0]: {"scale": jx.jnp.asarray(v)}
               for k, v in p.items() if k.endswith(".scale")})
    want = jx.attention._project_qkv(jp, cfg, jx.jnp.asarray(x),
                                     jx.jnp.asarray(pos))
    got = attention._project_qkv({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# training: loss, gradients, the superstep
# ---------------------------------------------------------------------------


def test_train_loss_and_every_gradient_leaf_match(jx, served):
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tmodel.cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.train_loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = flatten(jax.device_get(jgrads))

    # torch.autograd.grad, as the trainer takes it: train_loss checkpoints
    # its layers, which torch.func.grad does not run
    leaves = {k: v.detach().requires_grad_() for k, v in tparams.items()}
    loss, _ = tmodel.train_loss(leaves, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4,
                               atol=1e-5)
    assert set(grads) == set(jgrads)
    for k in sorted(jgrads):
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _superstep_pair(jx, arch, steps, **overrides):
    """Run `steps` supersteps (A=4, M=2) of the reference's
    `make_train_step` and of the port's from the reference's train state;
    yields (step, port state, port metrics, reference state, its
    metrics) after each."""
    jax, jnp = jx.jax, jx.jnp
    jcfg = dataclasses.replace(jx.get_smoke(arch), compute_dtype="float32",
                               **overrides)
    tcfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32",
                               **overrides)
    jtcfg = jx.TrainConfig(num_agents=A, model_parallel=1, num_walks=M)
    jmodel = jx.build_model(jcfg)
    jstate = jx.trainer.init_train_state(jmodel, jtcfg,
                                         key=jax.random.PRNGKey(0))
    state = state_from_jax(jax.device_get(jstate))
    jstep = jax.jit(jx.trainer.make_train_step(jmodel, jtcfg))
    step_fn = make_train_step(build_model(tcfg),
                              TrainConfig(num_agents=A, num_walks=M))
    batches = agent_batches(tcfg.vocab_size, A, 2, 16, seed=0)
    for step in range(steps):
        toks, targs = next(batches)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks),
                                    "targets": jnp.asarray(targs)},
                           jnp.int32(step))
        state, m = step_fn(state, {"tokens": torch.from_numpy(toks),
                                   "targets": torch.from_numpy(targs)}, step)
        yield step, state, m, jax.device_get(jstate), jm


@pytest.mark.parametrize("arch", ARCHS)
def test_superstep_matches_reference(jx, arch):
    """Two API-BCD supersteps in f32: loss, params, token, zhat and gacc
    of every leaf (qk-norm's too) to atol 1e-5."""
    for _, state, m, jstate, jm in _superstep_pair(jx, arch, 2):
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for part in STATE_KEYS:
            want = flatten(jstate[part])
            assert set(state[part]) == set(want)
            for k, v in want.items():
                _close(state[part][k], v, f"{part}/{k}")


def test_bf16_parameter_superstep_matches_reference(jx):
    """nemotron's bf16 parameters (the smoke config with its full
    config's param_dtype), f32 compute: the update runs on bf16 leaves.
    Both sides round the same f32 gradient and the same f32 update to
    bf16, where the f32 sums' order can tip a rounding, and a gradient
    tipped by one bf16 ulp moves the update and the token's f32 delta by
    at most one bf16 ulp of the leaf's scale: every leaf of every part
    lies within one bf16 ulp of its value plus one of the leaf's largest
    |value| of the reference's."""
    for _, state, m, jstate, jm in _superstep_pair(
            jx, "nemotron-4-15b", 2, param_dtype="bfloat16"):
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert {v.dtype for v in state["params"].values()} == {
            torch.bfloat16}
        for part in STATE_KEYS:
            for k, v in flatten(jstate[part]).items():
                want = torch.from_numpy(np.asarray(v, np.float32).copy())
                err = (state[part][k].float() - want).abs()
                bound = _bf16_ulp(want) + _bf16_ulp(want.abs().max())
                assert bool((err <= bound).all()), (part, k,
                                                    float(err.max()))


# ---------------------------------------------------------------------------
# serving: the arena, the pool, the mixed steps, the engines
# ---------------------------------------------------------------------------


def test_arena_prefill_and_decode_logits_match(jx, served):
    """prefill_into_slot into slots 2 and 0, then 6 decode_rows steps:
    logits and every arena leaf to atol 1e-5."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    jarena = jmodel.init_arena(3, 32, dtype=jnp.float32)
    tarena = arena_from_jax(jax.device_get(jarena))
    pos = np.zeros(3, np.int32)
    for slot, prompt in zip((2, 0), _prompts(tmodel.cfg.vocab_size,
                                             (11, 5), 4)):
        toks = np.zeros((1, 16 if len(prompt) > 8 else 8), np.int32)
        toks[0, :len(prompt)] = prompt
        jl, jarena = jmodel.prefill_into_slot(
            jparams, jnp.asarray(toks), jnp.int32(len(prompt)),
            jnp.int32(slot), jarena)
        tl, tarena = tmodel.prefill_into_slot(
            tparams, torch.from_numpy(toks), len(prompt), slot, tarena)
        _close(tl, jl, f"prefill slot {slot}")
        pos[slot] = len(prompt)
    cur = _prompts(tmodel.cfg.vocab_size, (3,), 5)[0]
    for i in range(6):
        jl, jarena = jmodel.decode_rows(jparams, jnp.asarray(cur)[:, None],
                                        jarena, jnp.asarray(pos))
        tl, tarena = tmodel.decode_rows(tparams,
                                        torch.from_numpy(cur)[:, None],
                                        tarena, torch.from_numpy(pos))
        _close(tl[[0, 2]], np.asarray(jl)[[0, 2]], f"decode step {i}")
        cur = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
        assert np.array_equal(tl[:, -1].argmax(-1).numpy()[[0, 2]],
                              cur[[0, 2]])
        pos += 1
    for name, want in jarena[0].items():
        _close(tarena[0][name], want, name)


def test_pool_chunk_prefill_and_decode_logits_match(jx, served):
    """Two prompts streamed through chunks of 4 into their blocks, then 6
    paged decode steps: logits and every real block to atol 1e-5."""
    jax, jnp = jx.jax, jx.jnp
    jmodel, jparams, tmodel, tparams = served
    bs, chunk = 4, 4
    jpool = jmodel.init_pool(16, bs, dtype=jnp.float32)
    tpool = pool_from_jax(jax.device_get(jpool))
    tables = np.zeros((2, 8), np.int32)
    tables[0, :4] = [5, 2, 9, 3]
    tables[1, :2] = [7, 1]
    lengths = np.zeros(2, np.int32)
    cur = np.zeros(2, np.int32)
    for row, prompt in enumerate(_prompts(tmodel.cfg.vocab_size, (13, 6),
                                          6)):
        for start in range(0, len(prompt), chunk):
            part = prompt[start:start + chunk]
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :len(part)] = part
            jl, jpool = jmodel.prefill_chunk_into_blocks(
                jparams, jnp.asarray(toks), jnp.int32(len(part)),
                jnp.int32(start), jnp.asarray(tables[row]), jpool)
            tl, tpool = tmodel.prefill_chunk_into_blocks(
                tparams, torch.from_numpy(toks), len(part), start,
                torch.from_numpy(tables[row]), tpool)
            _close(tl, jl, f"row {row} chunk at {start}")
        lengths[row], cur[row] = len(prompt), int(jnp.argmax(jl[0, -1]))
    free = iter([4, 6, 8, 10, 11])
    for i in range(6):
        for row in range(2):
            if tables[row, lengths[row] // bs] == 0:
                tables[row, lengths[row] // bs] = next(free)
        jl, jpool = jmodel.decode_rows_paged(
            jparams, jnp.asarray(cur)[:, None], jpool, jnp.asarray(tables),
            jnp.asarray(lengths))
        tl, tpool = tmodel.decode_rows_paged(
            tparams, torch.from_numpy(cur)[:, None], tpool,
            torch.from_numpy(tables), torch.from_numpy(lengths))
        _close(tl, jl, f"paged decode step {i}")
        cur = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
        lengths = lengths + 1
    for name, want in jpool[0].items():
        _close(tpool[0][name][:, 1:], np.asarray(want)[:, 1:], name)


@pytest.mark.parametrize("backend", ["arena", "paged"])
def test_mixed_steps_match_reference(jx, served, backend):
    """tests/test_torch_mixed.py's mixed-step checks on these models: the
    port's `mixed_step_tokens` / `mixed_step_paged_tokens` against the
    reference's, tokens equal and caches to atol 1e-5, over a slot
    re-admitted three times and over the first, middle and last chunk of
    a streamed prompt."""
    if backend == "arena":
        _mixed_arena_check(jx, served, None, 0)
    else:
        _mixed_paged_check(jx, served, None, 0)


def test_mixed_trunk_never_norms_the_joint_batch(served, monkeypatch):
    """Every rmsnorm of the mixed step (ln1, ln2, qk-norm, the final norm)
    sees the decode rows or the prompt's, never both: on the card its f32
    mean sums in another order for 8 + 256 rows than for 8, so a shared
    norm would leave the standalone steps' bits (`attention.
    MIXED_PER_HALF`)."""
    _, _, tmodel, tparams = served
    cfg = tmodel.cfg
    seen = []
    norm = attention.rmsnorm

    def spy(params, x):
        seen.append(x.shape[1])
        return norm(params, x)

    monkeypatch.setattr(attention, "rmsnorm", spy)
    b, sp = 3, 16
    arena = tmodel.init_arena(b, 32, dtype=torch.float32)
    toks = torch.zeros((1, sp), dtype=torch.int32)
    toks[0, :11] = torch.arange(1, 12)
    TF.mixed_step(cfg, tparams, torch.tensor([4, 5, 6], dtype=torch.int32),
                  arena, torch.tensor([3, 0, 2], dtype=torch.int32), toks,
                  11, 1)
    per_layer = 2 + 2 * cfg.qk_norm
    assert sorted(set(seen)) == [b, sp]
    assert len(seen) == 2 * (per_layer * cfg.num_layers + 1)


_GEOMETRY = dict(max_batch=2, max_len=24, block_size=4, prefill_chunk=4)


@pytest.mark.parametrize("port", ["arena", "paged", "serialized"])
def test_engine_tokens_equal_jax_arena_engine(jx, served, port):
    """tests/test_server.py's staggered workload: the port's overlapped
    arena engine, its overlapped paged engine on a 6-block pool (which
    preempts) and its serialized arena engine each give the JAX arena
    engine's tokens (the reference at its default, overlapped)."""
    jmodel, jparams, tmodel, tparams = served
    vocab = tmodel.cfg.vocab_size
    want, jst = _run_staggered(
        jx.Engine(jmodel, jparams, cache_dtype=jx.jnp.float32, **_GEOMETRY),
        vocab)
    assert jst["overlap_mode"] == "fused" and jst["mixed_steps"] > 0
    kw = {"arena": {}, "paged": dict(paged=True, num_blocks=6),
          "serialized": dict(overlap=False)}[port]
    eng = Engine(tmodel, tparams, cache_dtype=torch.float32, **_GEOMETRY,
                 **kw)
    got, st = _run_staggered(eng, vocab)
    assert got == want
    assert eng.overlap == (port != "serialized")
    assert (st["mixed_steps"] > 0) == eng.overlap
    if port == "paged":
        assert eng.paged and st["preemptions"] > 0
        assert eng.free_blocks == eng.num_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_logits_within_margin(jx, arch):
    """bf16 logits of the arena, pool and mixed steps (the smoke config's
    own compute dtype, bf16 caches) within BF16_LOGIT_RTOL of max |logit|
    of the reference's; the port's f32 path, the control, lies outside
    it."""
    jmodel, jparams, tmodel, tparams = _models(jx, arch, "bfloat16")
    assert jmodel.cfg.compute_dtype == "bfloat16"
    f32 = build_model(dataclasses.replace(tmodel.cfg,
                                          compute_dtype="float32"))
    got = _serving_logit_errors(jx, jmodel, jparams, tmodel, tparams,
                                torch.bfloat16)
    control = _serving_logit_errors(jx, jmodel, jparams, f32, tparams,
                                    torch.float32)
    assert got <= BF16_LOGIT_RTOL < control, (got, control)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_cli_run_on_cpu(arch, capsys):
    """`launch.serve` (arena and --paged) and `launch.train` take the new
    ids at smoke size on the CPU; the paged run's tokens equal the
    arena's."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    argv = ["--arch", arch, "--smoke", "--requests", "4", "--max-batch",
            "2", "--prompt-len", "8", "--new-tokens", "6", "--device", "cpu"]
    arena = serve_cli.main(argv)
    paged = serve_cli.main(argv + ["--paged", "--block-size", "4"])
    assert paged["paged"] and paged["outputs"] == arena["outputs"]
    assert arena["stats"]["overlap_mode"] == "fused"
    out = train_cli.main(["--arch", arch, "--smoke", "--agents", "2",
                          "--walks", "1", "--steps", "2",
                          "--batch-per-agent", "1", "--seq", "16",
                          "--device", "cpu", "--log-every", "0"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert get_smoke(arch).name in capsys.readouterr().out
