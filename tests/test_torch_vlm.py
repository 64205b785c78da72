"""The VLM family (phi-3-vision-4.2b) in the port against the JAX
reference, at smoke size on the CPU.

phi-3-vision is the dense decoder-only stack whose `train_loss` and
`prefill` take a batch's patch embeddings [B, P, D] (the stub vision
frontend) as a prefix: the loss skips the P prefix positions, and decode
continues at position P + prompt length. Both sides start from the
reference's `model.init` (converted with `params_from_jax`) and see
inputs made with numpy, in f32: loss (rtol 1e-5), every gradient leaf
(1e-4 of the leaf's largest |gradient|, at least 1), logits and caches
(1e-5) agree, greedy tokens are equal. The engine serves text-only
prompts (as the reference's does), arena and pool, with the reference's
arena engine's tokens. The full config's head_dim is 96, the smoke
config's 32: the serving checks also run the smoke config with head_dim
raised to 96, the width the attention kernels take on the card.
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
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.trainer import make_train_step  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    arena_from_jax, flatten, params_from_jax, state_from_jax)
from repro_torch.serve import Engine, probe_family_caps  # noqa: E402
from test_torch_mixed import _run_staggered  # noqa: E402

ARCH = "phi-3-vision-4.2b"
RTOL, ATOL = 1e-5, 1e-5
GRAD_ATOL = 1e-4
# bf16 logits at phi-3-vision's smoke config (patches, prefill and 8
# decode steps, bf16 caches), as a fraction of max |reference logit|:
# the port's bf16 path lies within it and its f32 path (the control) does
# not. Measured on the CPU (the port's bf16 against the reference's bf16,
# then the f32 control): 0.01287 / 0.01445; the limit sits between them.
BF16_LOGIT_RTOL = 0.0136


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as jax_get_smoke
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.dist import trainer as jax_trainer
    from repro.models import build_model as jax_build_model
    from repro.serve import Engine as JaxEngine
    from repro.serve.engine import probe_family_caps as jax_probe
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_smoke=jax_get_smoke,
        TrainConfig=JaxTrainConfig, trainer=jax_trainer,
        build_model=jax_build_model, Engine=JaxEngine, probe=jax_probe)


def _np(jx, tree):
    return flatten(jx.jax.device_get(tree))


def _models(jx, compute_dtype="float32", **change):
    """(reference model, its params, port model, the params converted)
    of the smoke config with `change`."""
    jcfg = dataclasses.replace(jx.get_smoke(ARCH),
                               compute_dtype=compute_dtype, **change)
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype=compute_dtype,
                              **change)
    jmodel = jx.build_model(jcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    return (jmodel, jparams, build_model(cfg),
            params_from_jax(jx.jax.device_get(jparams)))


@pytest.fixture(scope="module")
def phi3(jx):
    return _models(jx)


def _batch(cfg, b, s, seed, patches=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if patches:
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _to(jx, batch):
    return ({k: jx.jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def test_init_keys_shapes_and_dtypes_match_reference(jx, phi3):
    _, jparams, model, _ = phi3
    want = _np(jx, jparams)
    got = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())


@pytest.mark.parametrize("patches", [True, False],
                         ids=["patches", "text_only"])
def test_train_loss_and_every_gradient_match_reference(jx, phi3, patches):
    """With the patch prefix the loss covers the text positions only."""
    jmodel, jparams, model, params = phi3
    jb, tb = _to(jx, _batch(model.cfg, 2, 10, 1, patches))
    (jloss, _), jgrads = jx.jax.value_and_grad(
        jmodel.train_loss, has_aux=True)(jparams, jb)
    jgrads = _np(jx, jgrads)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = model.train_loss(leaves, tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    assert set(grads) == set(jgrads)
    for k in sorted(jgrads):
        atol = GRAD_ATOL * max(1.0, float(np.abs(jgrads[k]).max()))
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k], rtol=0,
                                   atol=atol, err_msg=k)


def test_patches_change_the_loss(phi3):
    """The prefix reaches the text's logits (attention sees it)."""
    _, _, model, params = phi3
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(model.cfg, 2, 10, 2).items()}
    with_p, _ = model.train_loss(params, batch)
    without, _ = model.train_loss(params, {k: v for k, v in batch.items()
                                           if k != "patches"})
    assert abs(float(with_p) - float(without)) > 1e-4


@pytest.mark.parametrize("head_dim", [32, 96], ids=["smoke", "hd96"])
def test_prefill_with_patches_then_decode_matches_reference(jx, head_dim):
    """Prefill of P patches + 7 tokens with headroom, then 8 greedy decode
    steps at positions P + 7 + i from the reference's tokens: logits and
    every cache leaf within 1e-5, equal tokens."""
    jmodel, jparams, model, params = _models(jx, head_dim=head_dim)
    jnp = jx.jnp
    b, s, steps = 2, 7, 8
    p = model.cfg.num_patches
    batch = _batch(model.cfg, b, s, 3)
    del batch["targets"]
    jb, tb = _to(jx, batch)
    jl, jc = jmodel.prefill(jparams, jb, cache_dtype=jnp.float32,
                            cache_len=p + s + steps)
    tl, tc = model.prefill(params, tb, cache_dtype=torch.float32,
                           cache_len=p + s + steps)
    _close(tl, jl)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                    jnp.int32(p + s + i))
        tl, tc = model.decode_step(params, torch.from_numpy(tok), tc,
                                   p + s + i)
        _close(tl, jl)
    for got, want in zip(tc, arena_from_jax(jx.jax.device_get(jc))):
        assert set(got) == set(want)
        for name in want:
            _close(got[name], want[name], name)
    assert tc[0]["ptr"].tolist() == [p + s + steps] * model.cfg.num_layers


def test_family_caps_equal_reference(jx, phi3):
    """phi-3-vision serves text-only prompts from the engine as a dense
    stack does: padding, paging, chunked prefill, the mixed step."""
    jmodel, _, model, _ = phi3
    caps = probe_family_caps(model, capacity=32)
    jcaps = jx.probe(jmodel, max_batch=2, capacity=32)
    assert dataclasses.astuple(caps) == dataclasses.astuple(jcaps) == (
        True, True, True, True)


_GEOMETRY = dict(max_batch=2, max_len=24, block_size=4, prefill_chunk=4)


@pytest.mark.parametrize("paged", [False, True], ids=["arena", "paged"])
def test_engine_tokens_equal_reference_engine(jx, phi3, paged):
    """tests/test_server.py's staggered text-only workload: the port's
    overlapped arena engine and its paged engine on a 6-block pool (which
    preempts) give the reference's arena engine's tokens."""
    jmodel, jparams, model, params = phi3
    vocab = model.cfg.vocab_size
    want, _ = _run_staggered(
        jx.Engine(jmodel, jparams, cache_dtype=jx.jnp.float32, **_GEOMETRY),
        vocab)
    eng = Engine(model, params, cache_dtype=torch.float32, **_GEOMETRY,
                 **(dict(paged=True, num_blocks=6) if paged else {}))
    got, st = _run_staggered(eng, vocab)
    assert got == want
    assert eng.paged == paged and st["mixed_steps"] > 0
    if paged:
        assert st["preemptions"] > 0 and eng.free_blocks == eng.num_blocks


def test_one_superstep_with_patches_matches_reference(jx):
    """One API-BCD superstep (A=4, M=2, 2 x 8 tokens behind the patches an
    agent) of the reference's make_train_step and the port's from one
    state: loss rtol 1e-5, params, token and zhat within 1e-4, gacc within
    1e-4 of its leaf's largest |value| where that passes 1."""
    jnp = jx.jnp
    a, m = 4, 2
    jmodel, _, model, _ = _models(jx)
    cfg = model.cfg
    jtcfg = jx.TrainConfig(num_agents=a, model_parallel=1, num_walks=m)
    jstate = jx.trainer.init_train_state(jmodel, jtcfg,
                                         key=jx.jax.random.PRNGKey(0))
    state = state_from_jax(jx.jax.tree.map(np.array, jstate))
    toks, targs = next(agent_batches(cfg.vocab_size, a, 2, 8, seed=0))
    patches = np.random.default_rng(4).standard_normal(
        (a, 2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    batch = {"tokens": toks, "targets": targs, "patches": patches}
    jstate, jmetrics = jx.jax.jit(jx.trainer.make_train_step(jmodel, jtcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0))
    state, metrics = make_train_step(
        model, TrainConfig(num_agents=a, num_walks=m))(
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


def _bf16_logit_error(jx, jmodel, jparams, model, params, cache_dtype):
    """max |port - reference| / max |reference| over a prefill with patches
    and 8 decode steps (the reference in bf16 compute and cache), each
    side continuing from the reference's tokens."""
    jnp = jx.jnp
    b, s, steps = 2, 9, 8
    p = model.cfg.num_patches
    batch = _batch(model.cfg, b, s, 5)
    del batch["targets"]
    jb, tb = _to(jx, batch)
    worst = 0.0

    def err(tl, jl):
        nonlocal worst
        want = np.asarray(jl, np.float32)
        worst = max(worst, float(np.abs(tl.float().numpy() - want).max())
                    / float(np.abs(want).max()))

    jl, jc = jmodel.prefill(jparams, jb, cache_len=p + s + steps)
    tl, tc = model.prefill(params, tb, cache_dtype=cache_dtype,
                           cache_len=p + s + steps)
    err(tl, jl)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                    jnp.int32(p + s + i))
        tl, tc = model.decode_step(params, torch.from_numpy(tok), tc,
                                   p + s + i)
        err(tl, jl)
    return worst


def test_bf16_serving_logits_within_share_of_reference(jx):
    """phi-3-vision's smoke config in its own bf16 compute: the port's
    logits lie within BF16_LOGIT_RTOL of the reference's largest |logit|,
    and the port's f32 path, the control, does not."""
    jmodel, jparams, model, params = _models(jx, "bfloat16")
    bf16 = _bf16_logit_error(jx, jmodel, jparams, model, params,
                             torch.bfloat16)
    f32 = _bf16_logit_error(
        jx, jmodel, jparams,
        build_model(dataclasses.replace(model.cfg, compute_dtype="float32")),
        params, torch.float32)
    assert bf16 <= BF16_LOGIT_RTOL < f32, (bf16, f32)


def test_serve_cli_runs_the_raw_loop_on_cpu(capsys):
    """`launch.serve --arch phi-3-vision-4.2b` goes to `serve_raw`: the
    patch prefix in front of each prompt, decode after it."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "3", "--prompt-len",
            "6", "--new-tokens", "4", "--device", "cpu"]
    out = serve_cli.main(argv)
    assert "raw prefill/decode loop" in capsys.readouterr().out
    assert np.asarray(out["tokens"]).shape == (3, 5)
    assert out["prefix"] == get_smoke(ARCH).num_patches


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_prefill_with_patches_on_card_matches_cpu_at_hd96(cuda):
    """The smoke config in f32 with head_dim 96: prefill with patches
    (flash at hd 96) and 8 decode steps (decode at hd 96) on the card
    within 1e-4 of the CPU's plain versions, equal greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32",
                              head_dim=96)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = {k: v.to(cuda) for k, v in cpu.items()}
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)),
        "patches": torch.from_numpy(rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32))}
    start = cfg.num_patches + 9
    outs = []
    for dev, p in (("cpu", cpu), (cuda, card)):
        lg, c = model.prefill(p, {k: v.to(dev) for k, v in batch.items()},
                              cache_dtype=torch.float32,
                              cache_len=start + 8)
        seq = [lg.cpu()]
        tok = lg[:, -1].argmax(-1)[:, None].int()
        for i in range(8):
            lg, c = model.decode_step(p, tok, c, start + i)
            seq.append(lg.cpu())
            tok = lg[:, -1].argmax(-1)[:, None].int()
        outs.append(torch.cat(seq, dim=1))
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4
    assert torch.equal(outs[0].argmax(-1), outs[1].argmax(-1))
