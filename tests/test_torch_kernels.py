"""The port's prox update against the JAX reference, and the Hopper kernel
against its plain version.

On the CPU the port's plain `ref.prox_update` is held against the JAX
kernel (Pallas, interpret mode) and the JAX oracle: rtol 1e-6 / atol
1e-7 in f32, and at most one bf16 ulp on a bf16 x_new. The CUDA cases
need the card (marker `cuda`); they import no JAX, so they also run where
JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels.py tests/test_torch_port_rules.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.prox_update import prox_update_cuda  # noqa: E402

KW = dict(tau=0.1, rho=20.0, num_walks=2, num_agents=4)
# sizes on both sides of the reference's 1024-lane tiling, and ragged ones
SHAPES = [(1024,), (3, 1000), (7, 129), (2, 3, 5), (4, 24, 8, 40)]


@pytest.fixture
def jx():
    """The JAX reference's prox update: (kernel via ops, oracle)."""
    pytest.importorskip("jax")
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    return jax_ops, jax_ref


def _inputs(shape, seed):
    """x, g, zsum at the scales the trainer feeds the update: parameters
    ~0.05, gradients ~0.01, token sums ~0.1. (The JAX kernel in interpret
    mode is up to 1 ulp of x_new off the JAX oracle; at unit-scale x that
    ulp, through the cancellation in x_new - x, exceeds atol on delta.)"""
    rng = np.random.default_rng(seed)
    x, g, z = (scale * rng.standard_normal(shape).astype(np.float32)
               for scale in (0.05, 0.01, 0.1))
    return x, g, z


def _bf16_ulp(v):
    """Spacing of bf16 values at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_jax_f32(jx, shape):
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    x, g, z = _inputs(shape, seed=len(shape))
    xn, d = ref.prox_update(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(z), **KW)
    assert xn.dtype == torch.float32 and d.dtype == torch.float32
    args = tuple(jnp.asarray(a, jnp.float32) for a in (x, g, z))
    for jxn, jd in (jax_ops.prox_update(*args, interpret=True, **KW),
                    jax_ref.prox_update(*args, **KW)):
        np.testing.assert_allclose(xn.numpy(), np.asarray(jxn), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("shape", [(3, 1000), (2, 3, 5)])
def test_ref_matches_jax_bf16_x(jx, shape):
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    x, g, z = _inputs(shape, seed=7)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xn, d = ref.prox_update(xt, torch.from_numpy(g), torch.from_numpy(z),
                            **KW)
    assert xn.dtype == torch.bfloat16 and d.dtype == torch.float32
    jx_in = jnp.asarray(xt.float().numpy(), jnp.bfloat16)
    jg, jz = jnp.asarray(g, jnp.float32), jnp.asarray(z, jnp.float32)
    got = xn.float().numpy()
    for jxn, jd in (jax_ops.prox_update(jx_in, jg, jz, interpret=True, **KW),
                    jax_ref.prox_update(jx_in, jg, jz, **KW)):
        assert jxn.dtype == jnp.bfloat16
        want = np.asarray(jxn.astype(jnp.float32))
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-7)


def test_tree_matches_jax(jx):
    jax_ops, _ = jx
    import jax.numpy as jnp
    leaves = {"a": _inputs((5, 7), 1), "b": _inputs((1030,), 2)}
    new, delta = ops.prox_update_tree(
        *({k: torch.from_numpy(v[j]) for k, v in leaves.items()}
          for j in range(3)), **KW)
    jnew, jdelta = jax_ops.prox_update_tree(
        *({k: jnp.asarray(v[j], jnp.float32) for k, v in leaves.items()}
          for j in range(3)), interpret=True, **KW)
    for k in leaves:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(delta[k].numpy(), np.asarray(jdelta[k]),
                                   rtol=1e-6, atol=1e-7)


def test_ops_sends_cpu_tensors_to_ref_without_launching():
    x, g, z = (torch.from_numpy(a) for a in _inputs((3, 5), 3))
    before = prox_update_cuda.launches
    got = ops.prox_update(x, g, z, **KW)
    want = ref.prox_update(x, g, z, **KW)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert prox_update_cuda.launches == before


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("numel", [1, 7, 1024, 1000003])
def test_kernel_matches_plain_version_on_card(cuda, dtype, numel):
    gen = torch.Generator(device=cuda).manual_seed(numel)
    x, g, z = (torch.randn(numel, generator=gen, device=cuda)
               for _ in range(3))
    x = x.to(dtype)
    before = prox_update_cuda.launches
    xn, d = ops.prox_update(x, g, z, **KW)
    torch.cuda.synchronize()
    assert prox_update_cuda.launches == before + 1
    rxn, rd = ref.prox_update(x, g, z, **KW)
    # same IEEE operations in the same order: bitwise equal
    assert torch.equal(xn, rxn) and torch.equal(d, rd)
    # unaligned (offset) views take the scalar path
    xn2, d2 = ops.prox_update(x[1:], g[1:], z[1:], **KW)
    rxn2, rd2 = ref.prox_update(x[1:], g[1:], z[1:], **KW)
    assert torch.equal(xn2, rxn2) and torch.equal(d2, rd2)
