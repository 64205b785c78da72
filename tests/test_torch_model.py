"""Parity of the port's dense GQA train path with the JAX reference.

Both sides start from the same parameters (the reference's init,
converted with `params_from_jax`) and the same batch made with numpy.
In f32 the loss and every gradient leaf must agree to rtol 1e-4 /
atol 1e-5 (only the order of f32 sums differs).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import attention, build_model, layers  # noqa: E402
from repro_torch.models.convert import flatten, params_from_jax  # noqa: E402

ARCH = "qwen2-0.5b"


def _configs(compute_dtype):
    return (dataclasses.replace(jax_get_smoke(ARCH),
                                compute_dtype=compute_dtype),
            dataclasses.replace(get_smoke(ARCH), compute_dtype=compute_dtype))


def _batch(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jax_loss_and_grads(jcfg, toks, targs):
    model = jax_build_model(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targs)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        model.train_loss, has_aux=True))(params, batch)
    return params, float(loss), flatten(jax.device_get(grads))


def _torch_loss_and_grads(tcfg, params, toks, targs):
    model = build_model(tcfg)
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(targs)}

    # torch.autograd.grad, as the trainer takes it: train_loss checkpoints
    # its layers, which torch.func.grad does not run
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = model.train_loss(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def test_train_loss_and_every_gradient_leaf_match_f32():
    jcfg, tcfg = _configs("float32")
    toks, targs = _batch(jcfg.vocab_size)
    jparams, jloss, jgrads = _jax_loss_and_grads(jcfg, toks, targs)
    params = params_from_jax(jax.device_get(jparams))
    assert set(params) == set(jgrads)
    loss, grads = _torch_loss_and_grads(tcfg, params, toks, targs)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4, atol=1e-5)
    for k in sorted(jgrads):
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_train_loss_matches_bf16():
    # bf16 matmuls round at other places in XLA and in PyTorch on the CPU,
    # so the bf16 loss agrees only to ~2e-2
    jcfg, tcfg = _configs("bfloat16")
    toks, targs = _batch(jcfg.vocab_size, seed=1)
    model = jax_build_model(jcfg)
    jparams = model.init(jax.random.PRNGKey(1))
    jloss, _ = jax.jit(model.train_loss)(jparams, {
        "tokens": jnp.asarray(toks), "targets": jnp.asarray(targs)})
    params = params_from_jax(jax.device_get(jparams))
    loss, _ = build_model(tcfg).train_loss(
        params, {"tokens": torch.from_numpy(toks),
                 "targets": torch.from_numpy(targs)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)


def test_param_keys_and_shapes_match_reference_init():
    jcfg, tcfg = _configs("float32")
    jparams = flatten(jax.device_get(
        jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    params = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    assert all(v.dtype == torch.float32 for v in params.values())


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_attention_matches(window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 2, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    want = jax_attention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    got = attention.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_unported_family_raises():
    """A family that neither package's configs name raises; every family
    the reference builds is ported."""
    cfg = dataclasses.replace(get_smoke(ARCH), family="bogus")
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg)


def _port_config(jcfg):
    """The reference's ArchConfig as the port's (the schemas are one)."""
    from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

    fields = dataclasses.asdict(jcfg)
    for name, cls in (("moe", MoEConfig), ("mla", MLAConfig)):
        if fields[name] is not None:
            fields[name] = cls(**fields[name])
    return ArchConfig(**fields)


@pytest.mark.parametrize("arch", ["whisper-small", "phi-3-vision-4.2b"])
def test_unported_reference_archs_raise(arch):
    """The last two architectures ported, whisper-small (audio
    encoder-decoder) and phi-3-vision (vision frontend), now build from
    the reference's configs, full and smoke, and their inits have the
    reference's leaf names and shapes: the port's init traced under
    FakeTensorMode (no storage: phi-3-vision is 15 GB in f32) against the
    reference's `jax.eval_shape`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs import get_config as jax_get_config

    for jcfg in (jax_get_config(arch), jax_get_smoke(arch)):
        model = build_model(_port_config(jcfg))
        assert model.cfg.family == jcfg.family
        want = flatten(jax.tree.map(
            lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape),
            jax.eval_shape(jax_build_model(jcfg).init,
                           jax.random.PRNGKey(0))))
        with FakeTensorMode():
            got = model.init(torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}


def test_dbrx_builds():
    from repro_torch.configs import get_config

    for cfg in (get_config("dbrx-132b"), get_smoke("dbrx-132b")):
        assert build_model(cfg).cfg is cfg


def test_deepseek_builds():
    """deepseek-v2-236b (MLA over the MoE with shared experts), full
    config and smoke, from the port's registry and from the reference's
    config alike."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    for cfg in (get_config("deepseek-v2-236b"),
                get_smoke("deepseek-v2-236b")):
        model = build_model(cfg)
        assert model.cfg is cfg and cfg.mla is not None
        assert model.init_pool is None
    for jcfg in (jax_get_config("deepseek-v2-236b"),
                 jax_get_smoke("deepseek-v2-236b")):
        assert build_model(_port_config(jcfg)).cfg.mla is not None
