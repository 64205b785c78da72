"""The encoder-decoder family (whisper-small) in the port against the JAX
reference, at smoke size on the CPU.

Both sides start from the reference's `encdec_init` (converted with
`params_from_jax`) and see inputs made with numpy. In f32 the pieces
(layernorm, cross_kv, cross_attention, bidir_attention, the decode
cross-attention) agree to 1e-5, the encoder's output, the loss (rtol
1e-5) and every gradient leaf (1e-4 of the leaf's largest |gradient|,
at least 1) too; prefill and 8 decode steps give logits and caches within
1e-5 and equal greedy tokens; one API-BCD superstep and one DP step
agree with the reference's as tests/test_torch_mla.py holds deepseek's.
Serving runs every attention through `kernels.ops` (the plain versions
here, the kernels on the card): the encoder and the cross-attention's
prefill through flash with causal=False, the decode cross-attention
through the decode kernel over the cached K/V.
"""
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.trainer import (  # noqa: E402
    make_dp_baseline_step, make_train_step)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention, build_model, encdec  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    arena_from_jax, flatten, params_from_jax, state_from_jax)
from repro_torch.serve import Engine  # noqa: E402

ARCH = "whisper-small"
RTOL, ATOL = 1e-5, 1e-5
GRAD_ATOL = 1e-4
A, M = 4, 2
# bf16 logits at whisper's smoke config, as a fraction of max |reference
# logit|, over a prefill and 8 decode steps. Measured on the CPU: the
# port's bf16 path 0.00926 of the reference's bf16 logits, its f32 path
# (the control) 0.00902, so at this size the logits cannot tell a stack
# run in another precision from the reference's own bf16 rounding (as
# recurrentgemma's, tests/test_torch_recurrentgemma.py); the f32 tests
# above hold the function. The limit is 1.4 times the reading.
BF16_LOGIT_RTOL = 0.013


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jax_ckpt
    from repro import optim as jax_optim
    from repro.configs import get_config as jax_get_config
    from repro.configs import get_smoke as jax_get_smoke
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.dist import trainer as jax_trainer
    from repro.models import attention as jax_attention
    from repro.models import build_model as jax_build_model
    from repro.models import encdec as jax_encdec
    from repro.models import layers as jax_layers
    from repro.serve import Engine as JaxEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ckpt=jax_ckpt, optim=jax_optim,
        get_config=jax_get_config, get_smoke=jax_get_smoke,
        TrainConfig=JaxTrainConfig, trainer=jax_trainer,
        attention=jax_attention, build_model=jax_build_model,
        encdec=jax_encdec, layers=jax_layers, Engine=JaxEngine)


def _np(jx, tree):
    return flatten(jx.jax.device_get(tree))


def _cfgs(jx, compute_dtype="float32"):
    return (dataclasses.replace(jx.get_smoke(ARCH),
                                compute_dtype=compute_dtype),
            dataclasses.replace(get_smoke(ARCH), compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def whisper(jx):
    """(reference model, its params, port model, the params converted),
    f32 compute."""
    jcfg, cfg = _cfgs(jx)
    jmodel = jx.build_model(jcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    return (jmodel, jparams, build_model(cfg),
            params_from_jax(jx.jax.device_get(jparams)))


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        shape)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return {"frames": frames, "tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _to(jx, batch):
    return ({k: jx.jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# the pieces, alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["layernorm", "rmsnorm"])
def test_make_norm_matches_reference(jx, norm_type):
    """layernorm in f32 with the biased variance, eps 1e-5; scales and
    biases that are not 1 and 0; a bf16 input returns bf16."""
    jinit, jnorm = jx.layers.make_norm(norm_type)
    init, norm = layers.make_norm(norm_type)
    d = 48
    p = {k: _rand(v.shape, i + 1, 0.5) + (1.0 if k == "scale" else 0.0)
         for i, (k, v) in enumerate(jinit(d, jx.jnp.float32).items())}
    assert set(p) == set(init((d,), torch.float32, "cpu"))
    x = _rand((3, 5, d), 4, 3.0) + 2.0
    want = jnorm({k: jx.jnp.asarray(v) for k, v in p.items()},
                 jx.jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(norm(tp, torch.from_numpy(x)), want)
    got = norm(tp, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def cross(jx):
    """(reference config, port config, reference cross params, the port's
    copy)."""
    jcfg, cfg = _cfgs(jx)
    jp = jx.attention.cross_init(jx.jax.random.PRNGKey(3), jcfg,
                                 jx.jnp.float32)
    return jcfg, cfg, jp, params_from_jax(jx.jax.device_get(jp))


def test_cross_init_shapes_and_scales(jx, cross):
    jcfg, cfg, jp, _ = cross
    got = attention.cross_init(torch.Generator().manual_seed(0), (3,), cfg,
                               torch.float32)
    want = _np(jx, jp)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: (3,) + v.shape for k, v in want.items()}
    d, hhd = cfg.d_model, cfg.num_heads * cfg.head_dim
    for k, fan_in in (("wq", d), ("wk", d), ("wv", d), ("wo", hhd)):
        assert abs(float(got[k].std()) * np.sqrt(fan_in) - 1.0) < 0.05, k


@pytest.mark.parametrize("kernel", [False, True], ids=["train", "serving"])
def test_cross_kv_and_cross_attention_match_reference(jx, cross, kernel):
    """S = 7 queries over T = 16 encoder rows (T != S, no mask): the
    training route (chunked attention) and the serving route (the flash
    kernel's plain version with causal=False)."""
    jcfg, cfg, jp, tp = cross
    enc = _rand((2, 16, cfg.d_model), 5)
    x = _rand((2, 7, cfg.d_model), 6)
    jk, jv = jx.attention.cross_kv(jp, jcfg, jx.jnp.asarray(enc))
    k, v = attention.cross_kv(tp, cfg, torch.from_numpy(enc))
    _close(k, jk)
    _close(v, jv)
    want = jx.attention.cross_attention(jp, jcfg, jx.jnp.asarray(x), jk, jv)
    _close(attention.cross_attention(tp, cfg, torch.from_numpy(x), k, v,
                                     kernel=kernel), want)


def test_cross_decode_matches_reference(jx, cross):
    """One token a row over the cached K/V, through the decode kernel's
    plain version with every row valid, against the reference's
    cross_attention at S = 1."""
    jcfg, cfg, jp, tp = cross
    ek = _rand((3, 16, cfg.num_heads, cfg.head_dim), 7)
    ev = _rand((3, 16, cfg.num_heads, cfg.head_dim), 8)
    x = _rand((3, 1, cfg.d_model), 9)
    want = jx.attention.cross_attention(jp, jcfg, jx.jnp.asarray(x),
                                        jx.jnp.asarray(ek),
                                        jx.jnp.asarray(ev))
    _close(attention.cross_decode(tp, cfg, torch.from_numpy(x),
                                  torch.from_numpy(ek), torch.from_numpy(ev)),
           want)


@pytest.mark.parametrize("kernel", [False, True], ids=["train", "serving"])
def test_bidir_attention_matches_reference(jx, kernel):
    """Encoder self-attention with rope and no causal mask."""
    jcfg, cfg = _cfgs(jx)
    jp = jx.attention.gqa_init(jx.jax.random.PRNGKey(4), jcfg,
                               jx.jnp.float32)
    tp = params_from_jax(jx.jax.device_get(jp))
    x = _rand((2, 16, cfg.d_model), 10)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want = jx.attention.bidir_attention(jp, jcfg, jx.jnp.asarray(x),
                                        jx.jnp.asarray(pos))
    _close(attention.bidir_attention(tp, cfg, torch.from_numpy(x),
                                     torch.from_numpy(pos.copy()),
                                     kernel=kernel), want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_init_keys_shapes_and_dtypes_match_reference(jx, whisper):
    """The port's own init at smoke size has the reference's leaves
    ("encoder.attn.wq", "decoder.cross.wk", "enc_norm.bias", "head", ...)
    with their shapes and dtypes."""
    _, jparams, model, _ = whisper
    want = _np(jx, jparams)
    got = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    assert {"encoder.attn.wq", "decoder.cross.wk", "decoder.ln_x.bias",
            "enc_norm.scale", "head"} <= set(got)


@pytest.mark.parametrize("kernel", [False, True], ids=["train", "serving"])
def test_encode_matches_reference(jx, whisper, kernel):
    jmodel, jparams, model, params = whisper
    frames = _rand((2, model.cfg.encoder_seq, model.cfg.d_model), 11)
    want = jx.encdec.encode(jmodel.cfg, jparams, jx.jnp.asarray(frames))
    _close(encdec.encode(model.cfg, params, torch.from_numpy(frames),
                         kernel=kernel), want)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_loss_and_every_gradient_match_reference(jx, whisper, remat):
    jmodel, jparams, model, params = whisper
    jb, tb = _to(jx, _batch(model.cfg, 2, 12, 12))
    (jloss, jmetrics), jgrads = jx.jax.value_and_grad(
        jmodel.train_loss, has_aux=True)(jparams, jb)
    jgrads = _np(jx, jgrads)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, metrics = model.train_loss(leaves, tb, remat=remat)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert float(metrics["aux"]) == 0.0
    assert set(grads) == set(jgrads)
    assert float(np.abs(jgrads["encoder.attn.wq"]).max()) > 0
    for k in sorted(jgrads):
        atol = GRAD_ATOL * max(1.0, float(np.abs(jgrads[k]).max()))
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k], rtol=0,
                                   atol=atol, err_msg=k)


def _caches_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        if name == "ptr":
            np.testing.assert_array_equal(got[name].numpy(), w)
        else:
            _close(got[name], w, what=name)


def test_prefill_and_decode_match_reference(jx, whisper):
    """A batched prefill with headroom (cache_len = S + 8), then 8 greedy
    decode steps, each side from the reference's tokens: logits and every
    cache leaf (the reference's cache converted by `arena_from_jax`)
    within 1e-5, equal greedy tokens."""
    jmodel, jparams, model, params = whisper
    jnp = jx.jnp
    b, s, steps = 2, 9, 8
    batch = _batch(model.cfg, b, s, 13)
    del batch["targets"]
    jb, tb = _to(jx, batch)
    jl, jc = jmodel.prefill(jparams, jb, cache_dtype=jnp.float32,
                            cache_len=s + steps)
    tl, tc = model.prefill(params, tb, cache_dtype=torch.float32,
                           cache_len=s + steps)
    _close(tl, jl)
    _caches_close(tc, arena_from_jax(_np(jx, jc)))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for i in range(steps):
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                    jnp.int32(s + i))
        tl, tc = model.decode_step(params, torch.from_numpy(tok), tc, s + i)
        _close(tl, jl)
        want = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), want)
        tok = want[:, None]
    _caches_close(tc, arena_from_jax(_np(jx, jc)))
    assert tc["ptr"].tolist() == [s + steps] * model.cfg.num_layers


def test_arena_from_jax_refuses_an_unknown_cache():
    with pytest.raises(ValueError, match="encoder-decoder"):
        arena_from_jax({"k": np.zeros(1), "v": np.zeros(1)})


def test_one_superstep_matches_reference(jx):
    """One API-BCD superstep of the reference's make_train_step and the
    port's from one state (A=4, M=2, 2 x 8 tokens and the frames an
    agent): loss rtol 1e-5; params, token and zhat within 1e-4, gacc
    within 1e-4 of its leaf's largest |value| where that passes 1."""
    jnp = jx.jnp
    jcfg, cfg = _cfgs(jx)
    jtcfg = jx.TrainConfig(num_agents=A, model_parallel=1, num_walks=M)
    jmodel = jx.build_model(jcfg)
    jstate = jx.trainer.init_train_state(jmodel, jtcfg,
                                         key=jx.jax.random.PRNGKey(0))
    state = state_from_jax(jx.jax.tree.map(np.array, jstate))
    toks, targs = next(agent_batches(cfg.vocab_size, A, 2, 8, seed=0))
    frames = _rand((A, 2, cfg.encoder_seq, cfg.d_model), 14)
    batch = {"tokens": toks, "targets": targs, "frames": frames}
    jstate, jmetrics = jx.jax.jit(jx.trainer.make_train_step(jmodel, jtcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0))
    state, metrics = make_train_step(
        build_model(cfg), TrainConfig(num_agents=A, num_walks=M))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=RTOL)
    for part in ("params", "token", "zhat", "gacc"):
        want = _np(jx, jstate[part])
        assert set(state[part]) == set(want)
        for k, v in want.items():
            atol = 1e-4 * (max(1.0, float(np.abs(v).max()))
                           if part == "gacc" else 1.0)
            np.testing.assert_allclose(state[part][k].numpy(), v, rtol=0,
                                       atol=atol, err_msg=f"{part}/{k}")


def test_one_dp_step_matches_reference(jx, whisper):
    """The DP baseline (sgd with momentum 0.9, constant 1e-2, the
    reference's optimizer and step without x64, as its jit runs them):
    loss rtol 1e-5, parameters and velocity after one step within 1e-5
    of the reference's."""
    jmodel, jparams, model, params = whisper
    jb, tb = _to(jx, _batch(model.cfg, 2, 8, 15))
    with jx.jax.enable_x64(False):
        jopt = jx.optim.sgd(momentum=0.9)
        jstep = jx.jax.jit(jx.trainer.make_dp_baseline_step(
            jmodel, jopt, jx.optim.constant(1e-2)))
        jnew, jost, jm = jstep(jparams, jopt.init(jparams), jb, 0)
    opt = optim.sgd(momentum=0.9)
    step = make_dp_baseline_step(model, opt, optim.constant(1e-2))
    new, ost, m = step(params, opt.init(params), tb, 0)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=RTOL)
    for got, want in ((new, _np(jx, jnew)), (ost, _np(jx, jost))):
        assert set(got) == set(want)
        for k, w in want.items():
            _close(got[k], w, rtol=0, atol=1e-5, what=k)


def test_checkpoint_round_trips_and_reference_reads_it(jx, tmp_path):
    """A whisper smoke API-BCD state (f32): the port's checkpoint loads
    back bitwise into a template of zeros, and the reference's
    load_checkpoint reads the same files into its own state bitwise."""
    jcfg, cfg = _cfgs(jx)
    jtcfg = jx.TrainConfig(num_agents=2, model_parallel=1, num_walks=1)
    jstate = jx.trainer.init_train_state(jx.build_model(jcfg), jtcfg,
                                         key=jx.jax.random.PRNGKey(1))
    jstate = jx.jax.tree.map(np.array, jstate)
    state = state_from_jax(jstate)
    state["token"] = {k: torch.randn(v.shape, generator=torch.Generator()
                                     .manual_seed(2))
                      for k, v in state["token"].items()}
    ckpt.save_checkpoint(str(tmp_path), state, step=5,
                         metadata={"arch": cfg.name})
    like = {part: {k: torch.zeros_like(v) for k, v in leaves.items()}
            for part, leaves in state.items()}
    got, step = ckpt.load_checkpoint(str(tmp_path), like)
    assert step == 5
    for part in state:
        for k, v in state[part].items():
            assert got[part][k].dtype == v.dtype == torch.float32
            assert torch.equal(got[part][k], v), f"{part}/{k}"
    zeros = jx.jax.tree.map(jx.jnp.zeros_like, jstate)
    jgot, jstep = jx.ckpt.load_checkpoint(str(tmp_path), zeros)
    assert jstep == 5
    for part in state:
        flat = _np(jx, jgot[part])
        assert set(flat) == set(state[part])
        for k, w in flat.items():
            assert w.dtype == np.float32
            np.testing.assert_array_equal(w, state[part][k].numpy(),
                                          err_msg=f"{part}/{k}")
    assert os.path.isfile(os.path.join(str(tmp_path), "meta.json"))


def _bf16_logit_error(jx, jmodel, jparams, model, params, cache_dtype):
    """max |port - reference| / max |reference| over a batched prefill's
    logits and 8 decode steps' (the reference in bf16 compute and cache),
    each side continuing from the reference's tokens."""
    jnp = jx.jnp
    b, s, steps = 2, 9, 8
    batch = _batch(model.cfg, b, s, 16)
    del batch["targets"]
    jb, tb = _to(jx, batch)
    worst = 0.0

    def err(tl, jl):
        nonlocal worst
        want = np.asarray(jl, np.float32)
        worst = max(worst, float(np.abs(tl.float().numpy() - want).max())
                    / float(np.abs(want).max()))

    jl, jc = jmodel.prefill(jparams, jb, cache_len=s + steps)
    tl, tc = model.prefill(params, tb, cache_dtype=cache_dtype,
                           cache_len=s + steps)
    err(tl, jl)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                    jnp.int32(s + i))
        tl, tc = model.decode_step(params, torch.from_numpy(tok), tc, s + i)
        err(tl, jl)
    return worst


def test_bf16_serving_logits_within_share_of_reference(jx):
    """whisper's smoke config in its own bf16 compute (bf16 caches): the
    port's logits lie within BF16_LOGIT_RTOL of the reference's largest
    |logit|."""
    jmodel = jx.build_model(jx.get_smoke(ARCH))
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    params = params_from_jax(jx.jax.device_get(jparams))
    cfg = get_smoke(ARCH)
    assert cfg.compute_dtype == "bfloat16"
    bf16 = _bf16_logit_error(jx, jmodel, jparams, build_model(cfg), params,
                             torch.bfloat16)
    assert bf16 <= BF16_LOGIT_RTOL, bf16


# ---------------------------------------------------------------------------
# the engine, the CLI and the full config
# ---------------------------------------------------------------------------


def test_engine_refuses_whisper_as_the_reference_does(jx, whisper):
    jmodel, jparams, model, params = whisper
    with pytest.raises(NotImplementedError, match="slot-arena"):
        jx.Engine(jmodel, jparams)
    with pytest.raises(NotImplementedError, match="slot-arena"):
        Engine(model, params)
    assert model.init_arena is None and model.mixed_step_tokens is None


def test_serve_cli_runs_the_raw_loop_on_cpu(capsys):
    """`launch.serve --arch whisper-small` goes to `serve_raw`: one
    batched prefill with random frames, then greedy decode steps; every
    row gets prefill's token and one a step, and a second run gives the
    same tokens."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "3", "--prompt-len",
            "6", "--new-tokens", "5", "--device", "cpu"]
    out = serve_cli.main(argv)
    assert "raw prefill/decode loop" in capsys.readouterr().out
    assert np.asarray(out["tokens"]).shape == (3, 6)
    assert out["prefix"] == 0 and out["peak_bytes"] is None
    assert serve_cli.main(argv)["tokens"] == out["tokens"]


def test_serve_cli_layers_cut_both_stacks():
    """--layers 1 keeps one decoder and one encoder layer at full width."""
    args = serve_cli.parse_args(["--arch", ARCH, "--smoke", "--layers", "1",
                                 "--device", "cpu"])
    _, cfg, _, params = serve_cli.build(args)
    assert cfg.num_layers == cfg.encoder_layers == 1
    assert params["encoder.attn.wq"].shape[0] == 1
    assert params["decoder.cross.wq"].shape[0] == 1


def test_full_config_init_shapes_match_reference_without_memory(jx):
    """whisper-small's full config: the port's init traced under
    FakeTensorMode (no storage) has the leaves and shapes the reference's
    `jax.eval_shape` gives, 12 + 12 layers of d 768."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    jmodel = jx.build_model(jx.get_config(ARCH))
    want = flatten(jx.jax.tree.map(
        lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape),
        jx.jax.eval_shape(jmodel.init, jx.jax.random.PRNGKey(0))))
    with FakeTensorMode():
        got = build_model(get_config(ARCH)).init(
            torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert tuple(got["decoder.cross.wk"].shape) == (12, 768, 768)


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_encdec_serving_on_card_matches_cpu(cuda):
    """The smoke config in f32 from one set of parameters: prefill and 8
    decode steps on the card (flash non-causal for the encoder and the
    cross-attention, decode over the cross K/V) within 1e-4 of the CPU's
    plain versions, equal greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = {k: v.to(cuda) for k, v in cpu.items()}
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)),
        "frames": torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}
    outs = []
    for dev, p in (("cpu", cpu), (cuda, card)):
        lg, c = model.prefill(p, {k: v.to(dev) for k, v in batch.items()},
                              cache_dtype=torch.float32, cache_len=17)
        seq = [lg.cpu()]
        tok = lg[:, -1].argmax(-1)[:, None].int()
        for i in range(8):
            lg, c = model.decode_step(p, tok, c, 9 + i)
            seq.append(lg.cpu())
            tok = lg[:, -1].argmax(-1)[:, None].int()
        outs.append(torch.cat(seq, dim=1))
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4
    assert torch.equal(outs[0].argmax(-1), outs[1].argmax(-1))
