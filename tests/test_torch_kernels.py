"""The port's kernels' plain versions against the JAX reference, and the
Hopper kernels against their plain versions.

On the CPU the port's plain `ref.prox_update` is held against the JAX
kernel (Pallas, interpret mode) and the JAX oracle: rtol 1e-6 / atol
1e-7 in f32, and at most one bf16 ulp on a bf16 x_new. The plain
attention versions (`ref.attention`, `ref.decode_attention`) are held
against the JAX Pallas kernels in interpret mode and the JAX oracles at
the reference's own tolerances (1e-5 in f32, 3e-2 in bf16), and against
the model's jnp `chunked_attention` at 2e-4. The decode kernel's split-and-
combine arithmetic (`ref.decode_attention_split`, chunks of
`split_rows(T, KV, hd)` rows) is held against `ref.decode_attention` and
the JAX kernel in interpret mode. The plain paged and ring decode
versions (`ref.decode_attention_paged`, `ref.decode_attention_ring`) are
held against the JAX Pallas kernels in interpret mode and the JAX oracles
at 1e-6 in f32 (within one bf16 ulp in bf16), and the paged kernel's
split arithmetic for the pool layouts (`ref.decode_attention_paged_split`,
chunks of `paged_split_rows(hd)` rows) against them, the JAX kernels and
oracles at 1e-5 (one bf16 ulp + 1e-5 in bf16), at every split and tile
edge and bitwise under a wider table and alone. The plain WKV recurrence
(`ref.rwkv6`) and the plain RG-LRU recurrence (`ref.rglru`) are held
against the JAX oracles and TPU kernels in `tests/test_torch_rwkv.py` and
`tests/test_torch_recurrentgemma.py`; here their CUDA kernels are held
against them. The
CUDA cases need the card (marker `cuda`); they import no JAX, so they
also run where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels.py tests/test_torch_port_rules.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.kernels import tickets as ticket_pool  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, num_splits, split_rows)
from repro_torch.kernels.decode_attention_paged import (  # noqa: E402
    decode_attention_paged_cuda, decode_attention_ring_cuda, paged_num_splits,
    paged_split_rows)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.prox_update import prox_update_cuda  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    CHUNKED_MIN_STEPS, rwkv6_scan_cuda)

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


# ---- attention: plain versions against the JAX kernels and oracles ----

ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _attn_inputs(seed, shapes, dtype):
    """numpy f32 arrays (bf16-rounded for bf16) and their torch tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return [t.float().numpy() for t in ts], ts


@pytest.mark.parametrize("s,t,h,kv,hd,window", [
    (256, 256, 4, 2, 64, 0),       # GQA
    (256, 256, 4, 1, 32, 64),      # MQA sliding window
    (96, 96, 2, 2, 64, 0),         # not a multiple of the block
])
def test_flash_plain_matches_jax_kernel_and_oracle(jx, s, t, h, kv, hd,
                                                   window):
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    b = 2
    (q, k, v), (tq, tk, tv) = _attn_inputs(
        1, [(b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)], "float32")
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, hd)
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in (q, k, v))
    kern = jax_ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                   block_q=64, block_k=64, interpret=True)
    oracle = jax_ref.attention(jq.transpose(0, 2, 1, 3),
                               jk.transpose(0, 2, 1, 3),
                               jv.transpose(0, 2, 1, 3), causal=True,
                               window=window).transpose(0, 2, 1, 3)
    for want in (kern, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("window", [0, 48])
def test_flash_plain_matches_model_chunked_attention(window):
    """The reference's model path (jnp chunked_attention, several chunks)
    and the port's prefill kernel's plain version compute one function."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention
    b, s, kv, g, hd = 2, 128, 2, 3, 32
    (q, k, v), (tq, tk, tv) = _attn_inputs(
        2, [(b, s, kv, g, hd), (b, s, kv, hd), (b, s, kv, hd)], "float32")
    want = chunked_attention(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                             causal=True, window=window, q_chunk=64,
                             kv_chunk=64)
    got = ops.flash_attention(tq.reshape(b, s, kv * g, hd), tk, tv,
                              causal=True, window=window)
    np.testing.assert_allclose(got.reshape(b, s, kv, g, hd).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,t,h,kv,hd", [
    (65, 130, 4, 2, 64),     # cross-attention: S != T, both cut mid-tile
    (17, 150, 4, 4, 96),     # hd 96 (phi-3-vision's), every head its own
    (96, 96, 2, 2, 96),      # an encoder's square, unmasked case at hd 96
])
def test_flash_plain_noncausal_matches_jax_kernel_and_oracle(jx, s, t, h, kv,
                                                             hd):
    """causal=False (the whisper encoder and cross-attention's prefill):
    every query attends to every key, T != S."""
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    b = 2
    (q, k, v), (tq, tk, tv) = _attn_inputs(
        12, [(b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)], "float32")
    got = ops.flash_attention(tq, tk, tv, causal=False)
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in (q, k, v))
    kern = jax_ops.flash_attention(jq, jk, jv, causal=False, block_q=64,
                                   block_k=64, interpret=True)
    oracle = jax_ref.attention(jq.transpose(0, 2, 1, 3),
                               jk.transpose(0, 2, 1, 3),
                               jv.transpose(0, 2, 1, 3),
                               causal=False).transpose(0, 2, 1, 3)
    for want in (kern, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_kernel_and_oracle(jx, dtype):
    """Per-row lengths: slot-arena decode, every row at its own depth."""
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    b, t, h, kv, hd = 3, 384, 4, 2, 64
    (q, k, v), (tq, tk, tv) = _attn_inputs(
        8, [(b, h, hd), (b, t, kv, hd), (b, t, kv, hd)], dtype)
    lengths = np.array([1, 200, 384], np.int32)
    got = ops.decode_attention(tq, tk, tv, lengths=torch.from_numpy(lengths))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, hd)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    kern = jax_ops.decode_attention(jq, jk, jv, lengths=jnp.asarray(lengths),
                                    block_k=128, interpret=True)
    oracle = jax_ref.decode_attention(jq, jk.transpose(0, 2, 1, 3),
                                      jv.transpose(0, 2, 1, 3),
                                      valid_len=jnp.asarray(lengths))
    for want in (kern, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=ATOL[dtype], atol=ATOL[dtype])


def test_decode_plain_ignores_rows_past_the_length():
    """Garbage (even NaN) past a row's length does not reach the output,
    as in the kernel, which zeroes those V rows."""
    (q, k, v), (tq, tk, tv) = _attn_inputs(
        9, [(2, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32)], "float32")
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    want = ops.decode_attention(tq, tk, tv, lengths=lengths)
    tk[0, 5:], tv[0, 5:] = float("nan"), float("inf")
    got = ops.decode_attention(tq, tk, tv, lengths=lengths)
    assert torch.equal(got, want)


# ---- the decode kernel's split-and-combine arithmetic, on the CPU ----

SPLIT_CASES = [(4, 2, 64, 700), (10, 1, 256, 2100), (8, 2, 32, 1000)]


@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
def test_split_rows_is_a_multiple_of_64_from_t_kv_and_hd_only(hd):
    """The decode kernel's chunk: a multiple of 64 rows, at least 128, at
    most 32 blocks a batch row, and a function of (T, KV, hd) alone, so a
    row's grid and arithmetic cannot depend on the batch."""
    import inspect
    assert list(inspect.signature(split_rows).parameters) == ["t", "kv", "hd"]
    for t in (1, 63, 64, 65, 128, 129, 512, 700, 2048, 4096, 32768):
        for kv in (1, 2, 8, 64):
            rows = split_rows(t, kv, hd)
            splits = num_splits(t, kv, hd)
            assert rows % 64 == 0 and rows >= 128, (t, kv, rows)
            assert splits == max(1, -(-t // rows)) and splits <= 32
            assert kv * splits <= max(32, kv), (t, kv, splits)
    # the serving shapes: qwen2 (2 kv heads of 64), recurrentgemma (1 of 256)
    assert num_splits(512, 2, 64) == 4 and num_splits(2048, 1, 256) == 16


def _split_case(seed, h, kv, hd, t, dtype):
    """Rows at every edge of a chunk and a tile: lengths 0, 1, 63, 64, 65,
    R, R + 1 and T (T not a multiple of R)."""
    rows = split_rows(t, kv, hd)
    assert t % rows and num_splits(t, kv, hd) > 2
    lengths = np.array([0, 1, 63, 64, 65, rows, rows + 1, t], np.int32)
    b = len(lengths)
    arrs, ts = _attn_inputs(seed, [(b, h, hd), (b, t, kv, hd),
                                   (b, t, kv, hd)], dtype)
    return arrs, ts, lengths, rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,hd,t", SPLIT_CASES)
def test_split_combine_plain_matches_plain_decode(dtype, h, kv, hd, t):
    _, (tq, tk, tv), lengths, rows = _split_case(11, h, kv, hd, t, dtype)
    lens = torch.from_numpy(lengths)
    got = ref.decode_attention_split(tq, tk, tv, lengths=lens,
                                     split_rows=rows)
    want = ref.decode_attention(tq, tk, tv, lengths=lens)
    assert got.dtype == tq.dtype and got.shape == want.shape
    assert torch.equal(got[0], torch.zeros_like(got[0]))     # length 0
    got, want = got.float().numpy(), want.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:   # both round one f32 value once, summed in another order
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_combine_plain_matches_jax_kernel(jx, dtype):
    """Against the TPU kernel in interpret mode and the JAX oracle, with
    chunks wholly past a row's length (every row but the last). At length
    0 the TPU kernel, which zeroes invalid V rows, gives 0, and the oracle
    the mean of V: that row is held against the kernel only."""
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    h, kv, hd, t = SPLIT_CASES[0]
    (q, k, v), (tq, tk, tv), lengths, rows = _split_case(12, h, kv, hd, t,
                                                         dtype)
    got = ref.decode_attention_split(tq, tk, tv,
                                     lengths=torch.from_numpy(lengths),
                                     split_rows=rows)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    kern = jax_ops.decode_attention(jq, jk, jv, lengths=jnp.asarray(lengths),
                                    block_k=128, interpret=True)
    oracle = jax_ref.decode_attention(jq, jk.transpose(0, 2, 1, 3),
                                      jv.transpose(0, 2, 1, 3),
                                      valid_len=jnp.asarray(lengths))
    for want, first in ((kern, 0), (oracle, 1)):
        np.testing.assert_allclose(got[first:].float().numpy(),
                                   np.asarray(want, np.float32)[first:],
                                   rtol=ATOL[dtype], atol=ATOL[dtype])


def test_ops_sends_cpu_attention_to_ref_without_launching():
    (_, _, _), (tq, tk, tv) = _attn_inputs(
        3, [(1, 16, 4, 32), (1, 16, 2, 32), (1, 16, 2, 32)], "float32")
    lengths = torch.tensor([7], dtype=torch.int32)
    before = (flash_attention_cuda.launches, decode_attention_cuda.launches)
    assert torch.equal(ops.flash_attention(tq, tk, tv),
                       ref.attention(tq, tk, tv))
    assert torch.equal(ops.decode_attention(tq[:, 0], tk, tv, lengths=lengths),
                       ref.decode_attention(tq[:, 0], tk, tv, lengths=lengths))
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == before


# ---- paged and ring decode: plain versions against the JAX kernels ----


def _paged_inputs(seed, b, h, kv, hd, bs, nb, dtype):
    (q, kp, vp), (tq, tkp, tvp) = _attn_inputs(
        seed, [(b, h, hd), (nb, bs, kv, hd), (nb, bs, kv, hd)], dtype)
    return (q, kp, vp), (tq, tkp, tvp)


def _close_to_jax(got, wants, dtype):
    """1e-6 in f32; in bf16 within one bf16 ulp (+1e-6) of each JAX
    output, since both round one f32 result to bf16."""
    got = got.float().numpy()
    for want in wants:
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-6).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax_kernel_and_oracle(jx, dtype):
    """Rows own disjoint random blocks; the trailing entries of short rows
    point at the null block (the shapes of the reference's own test)."""
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    b, h, kv, hd, bs, w = 3, 4, 2, 64, 8, 6
    nb = 1 + b * w
    (q, kp, vp), (tq, tkp, tvp) = _paged_inputs(9, b, h, kv, hd, bs, nb,
                                                dtype)
    rng = np.random.default_rng(9)
    tables = (rng.permutation(nb - 1) + 1)[:b * w].reshape(b, w)
    lengths = np.asarray([1, 19, w * bs], np.int32)
    for i, n in enumerate(lengths):
        tables[i, (int(n) + bs - 1) // bs:] = 0
    tables = tables.astype(np.int32)
    got = ops.decode_attention_paged(tq, tkp, tvp, torch.from_numpy(tables),
                                     lengths=torch.from_numpy(lengths))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, hd)
    jdt = getattr(jnp, dtype)
    jq, jkp, jvp = (jnp.asarray(a, jdt) for a in (q, kp, vp))
    jt, jl = jnp.asarray(tables), jnp.asarray(lengths)
    _close_to_jax(got, [
        jax_ops.decode_attention_paged(jq, jkp, jvp, jt, jl, interpret=True),
        jax_ref.decode_attention_paged(jq, jkp, jvp, jt, jl)], dtype)


def test_paged_plain_with_identity_table_is_the_linear_plain():
    """An identity block table over the same caches cut into blocks: the
    paged plain version computes exactly the linear one."""
    b, t, h, kv, hd, bs = 2, 256, 4, 2, 64, 64
    _, (tq, tk, tv) = _attn_inputs(
        10, [(b, h, hd), (b, t, kv, hd), (b, t, kv, hd)], "float32")
    lengths = torch.tensor([100, 256], dtype=torch.int32)
    w = t // bs
    null = torch.zeros(1, bs, kv, hd)
    pk = torch.cat([null, tk.reshape(b * w, bs, kv, hd)])
    pv = torch.cat([null, tv.reshape(b * w, bs, kv, hd)])
    tables = 1 + torch.arange(b * w, dtype=torch.int32).reshape(b, w)
    assert torch.equal(
        ops.decode_attention_paged(tq, pk, pv, tables, lengths=lengths),
        ops.decode_attention(tq, tk, tv, lengths=lengths))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_plain_matches_jax_kernel_and_oracle(jx, dtype):
    """Unwrapped, part-filled and fully wrapped rows with per-row table
    rotations (the shapes of the reference's own test)."""
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    b, h, kv, hd, bs, window = 3, 4, 2, 64, 8, 40
    w = (window + bs - 1) // bs
    nb = 1 + b * w
    (q, kp, vp), (tq, tkp, tvp) = _paged_inputs(11, b, h, kv, hd, bs, nb,
                                                dtype)
    rng = np.random.default_rng(11)
    tables = (rng.permutation(nb - 1) + 1)[:b * w].reshape(b, w).astype(
        np.int32)
    lengths = np.asarray([1, 25, 100], np.int32)
    starts = np.asarray([0, 2, 4], np.int32)
    got = ops.decode_attention_ring(
        tq, tkp, tvp, torch.from_numpy(tables),
        ring_starts=torch.from_numpy(starts),
        lengths=torch.from_numpy(lengths), window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, hd)
    jdt = getattr(jnp, dtype)
    jq, jkp, jvp = (jnp.asarray(a, jdt) for a in (q, kp, vp))
    args = (jnp.asarray(tables), jnp.asarray(starts), jnp.asarray(lengths))
    _close_to_jax(got, [
        jax_ops.decode_attention_ring(jq, jkp, jvp, *args, window=window,
                                      interpret=True),
        jax_ref.decode_attention_ring(jq, jkp, jvp, *args, window=window)],
        dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["linear", "paged", "ring"])
def test_hd96_decode_plain_matches_jax_kernels(jx, dtype, layout):
    """head_dim 96 (phi-3-vision's): the plain linear, paged and ring
    decode versions against the TPU kernels in interpret mode and the JAX
    oracles, 4 heads over 4 (phi-3's G = 1) and 8 over 4."""
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    jdt = getattr(jnp, dtype)
    b, kv, hd = 3, 4, 96
    rng = np.random.default_rng(13)
    for h in (4, 8):
        if layout == "linear":
            t = 200
            (q, k, v), (tq, tk, tv) = _attn_inputs(
                13 + h, [(b, h, hd), (b, t, kv, hd), (b, t, kv, hd)], dtype)
            lengths = np.array([1, 97, t], np.int32)
            got = ops.decode_attention(tq, tk, tv,
                                       lengths=torch.from_numpy(lengths))
            jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
            wants = [jax_ops.decode_attention(
                jq, jk, jv, lengths=jnp.asarray(lengths), block_k=128,
                interpret=True), jax_ref.decode_attention(
                jq, jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3),
                valid_len=jnp.asarray(lengths))]
            for want in wants:      # the reference's own tolerances
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(want, np.float32),
                                           rtol=ATOL[dtype], atol=ATOL[dtype])
            continue
        bs, w, window = 8, 6, 40
        nb = 1 + b * w
        (q, kp, vp), (tq, tkp, tvp) = _paged_inputs(13 + h, b, h, kv, hd,
                                                    bs, nb, dtype)
        tables = (rng.permutation(nb - 1) + 1)[:b * w].reshape(b, w).astype(
            np.int32)
        jq, jkp, jvp = (jnp.asarray(a, jdt) for a in (q, kp, vp))
        if layout == "paged":
            lengths = np.asarray([1, 19, w * bs], np.int32)
            got = ops.decode_attention_paged(
                tq, tkp, tvp, torch.from_numpy(tables),
                lengths=torch.from_numpy(lengths))
            args = (jnp.asarray(tables), jnp.asarray(lengths))
            _close_to_jax(got, [
                jax_ops.decode_attention_paged(jq, jkp, jvp, *args,
                                               interpret=True),
                jax_ref.decode_attention_paged(jq, jkp, jvp, *args)], dtype)
        else:
            lengths = np.asarray([1, 25, 100], np.int32)
            starts = np.asarray([0, 2, 4], np.int32)
            got = ops.decode_attention_ring(
                tq, tkp, tvp, torch.from_numpy(tables),
                ring_starts=torch.from_numpy(starts),
                lengths=torch.from_numpy(lengths), window=window)
            args = (jnp.asarray(tables), jnp.asarray(starts),
                    jnp.asarray(lengths))
            _close_to_jax(got, [
                jax_ops.decode_attention_ring(jq, jkp, jvp, *args,
                                              window=window, interpret=True),
                jax_ref.decode_attention_ring(jq, jkp, jvp, *args,
                                              window=window)], dtype)


def test_ring_plain_rotation_invariant_and_degenerate_paged():
    """Rotating (table, start) together leaves the plain ring bitwise
    unchanged, and while no row has wrapped the ring is the paged plain
    version with the same table."""
    b, h, kv, hd, bs, window = 2, 4, 2, 64, 8, 32
    w = window // bs
    nb = 1 + b * w
    _, (tq, tkp, tvp) = _paged_inputs(12, b, h, kv, hd, bs, nb, "float32")
    rng = np.random.default_rng(12)
    ring = (rng.permutation(nb - 1) + 1)[:b * w].reshape(b, w)
    lengths = torch.tensor([17, 77], dtype=torch.int32)
    zeros = torch.zeros(b, dtype=torch.int32)
    base = ops.decode_attention_ring(
        tq, tkp, tvp, torch.from_numpy(ring.astype(np.int32)),
        ring_starts=zeros, lengths=lengths, window=window)
    for s in range(1, w):
        rot = torch.from_numpy(np.roll(ring, s, axis=1).astype(np.int32))
        out = ops.decode_attention_ring(
            tq, tkp, tvp, rot, ring_starts=torch.full((b,), s,
                                                      dtype=torch.int32),
            lengths=lengths, window=window)
        assert torch.equal(out, base)
    short = torch.tensor([9, 32], dtype=torch.int32)
    tables = torch.from_numpy(ring.astype(np.int32))
    assert torch.equal(
        ops.decode_attention_ring(tq, tkp, tvp, tables, ring_starts=zeros,
                                  lengths=short, window=window),
        ops.decode_attention_paged(tq, tkp, tvp, tables, lengths=short))


def test_ring_plain_with_a_table_narrower_than_the_ring(jx):
    """The engine slices a ring's table to the pow2 width of its live
    rows, narrower than the ring while no row holds more than W * bs
    tokens: the rows then attend to their W * bs slots at most, as in the
    JAX oracle (whose TPU kernel asserts W * bs >= window)."""
    _, jax_ref = jx
    import jax.numpy as jnp
    b, h, kv, hd, bs, window = 3, 4, 2, 64, 8, 32
    (q, kp, vp), (tq, tkp, tvp) = _paged_inputs(14, b, h, kv, hd, bs, 7,
                                                "float32")
    tables = np.array([[3, 5], [6, 0], [0, 0]], np.int32)    # W * bs = 16
    lengths = np.array([16, 7, 40], np.int32)    # row 2: dead, drifted
    zeros = np.zeros(b, np.int32)
    got = ops.decode_attention_ring(
        tq, tkp, tvp, torch.from_numpy(tables),
        ring_starts=torch.from_numpy(zeros),
        lengths=torch.from_numpy(lengths), window=window)
    want = jax_ref.decode_attention_ring(
        *(jnp.asarray(a, jnp.float32) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(zeros), jnp.asarray(lengths),
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert torch.equal(got, ops.decode_attention_paged(
        tq, tkp, tvp, torch.from_numpy(tables),
        lengths=torch.from_numpy(np.minimum(lengths, window))))


def test_ops_sends_cpu_paged_attention_to_ref_without_launching():
    _, (tq, tkp, tvp) = _paged_inputs(13, 2, 4, 2, 32, 4, 5, "float32")
    tables = torch.tensor([[1, 3], [4, 0]], dtype=torch.int32)
    lengths = torch.tensor([7, 3], dtype=torch.int32)
    starts = torch.tensor([1, 0], dtype=torch.int32)
    before = (decode_attention_paged_cuda.launches,
              decode_attention_ring_cuda.launches)
    assert torch.equal(
        ops.decode_attention_paged(tq, tkp, tvp, tables, lengths=lengths),
        ref.decode_attention_paged(tq, tkp, tvp, tables, lengths=lengths))
    kw = dict(ring_starts=starts, lengths=lengths, window=8)
    assert torch.equal(ops.decode_attention_ring(tq, tkp, tvp, tables, **kw),
                       ref.decode_attention_ring(tq, tkp, tvp, tables, **kw))
    assert (decode_attention_paged_cuda.launches,
            decode_attention_ring_cuda.launches) == before


# ---- the paged and ring kernel's split arithmetic, on the CPU ----

# (layout, bs, W, window): the ring's window binds inside the table
POOL_SPLIT_CASES = [("paged", 4, 80, 0), ("paged", 8, 40, 0),
                    ("paged", 16, 20, 0), ("paged", 3, 100, 0),
                    ("ring", 16, 20, 300), ("ring", 8, 40, 320)]


@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
def test_paged_split_rows_is_a_multiple_of_64_from_hd_only(hd):
    """The paged kernel's chunk: a multiple of 64 rows, at least 128 and
    8192 K values of a head, a function of hd alone (never of the
    table's width, which the engine changes as rows come and go, of the
    batch or of the lengths); at qwen2's widths it is the linear kernel's
    chunk at the arena's 512 rows, so an identity table can reproduce the
    linear kernel bitwise."""
    import inspect
    assert list(inspect.signature(paged_split_rows).parameters) == ["hd"]
    rows = paged_split_rows(hd)
    assert rows % 64 == 0 and rows >= 128 and rows * hd >= 8192
    for cap in (1, 63, 64, 65, rows, rows + 1, 4096, 40 * rows + 5):
        assert paged_num_splits(cap, hd) == max(1, -(-cap // rows))
    assert paged_split_rows(64) == split_rows(512, 2, 64) == 128
    assert paged_num_splits(512, 64) == 4 and paged_num_splits(4096, 64) == 32


def _pool_split_case(seed, layout, bs, w, window, dtype, h=4, kv=2, hd=64):
    """A pool, random disjoint tables [B, W] (trailing entries of short
    paged rows on the null block), random ring starts, and one row at each
    split and tile edge: lengths 0, 1, 63, 64, 65, R, R + 1, the cap and
    past the cap (a ring row past its window has wrapped)."""
    rows = paged_split_rows(hd)
    cap = w * bs if layout == "paged" else min(window, w * bs)
    lengths = np.array([0, 1, 63, 64, 65, rows, rows + 1, cap, cap + 37],
                       np.int32)
    b = len(lengths)
    nb = 1 + b * w
    (q, kp, vp), (tq, tkp, tvp) = _paged_inputs(seed, b, h, kv, hd, bs, nb,
                                                dtype)
    rng = np.random.default_rng(seed)
    tables = (rng.permutation(nb - 1) + 1)[:b * w].reshape(b, w)
    starts = rng.integers(0, w, b).astype(np.int32)
    if layout == "paged":
        for i, n in enumerate(lengths):
            tables[i, (int(n) + bs - 1) // bs:] = 0
        starts = None
    return ((q, kp, vp), (tq, tkp, tvp), tables.astype(np.int32), starts,
            lengths, rows)


def _pool_split(tq, tkp, tvp, tables, starts, lengths, rows, window):
    """The plain split arithmetic for the pool layouts, numpy in."""
    ring = {} if starts is None else dict(
        ring_starts=torch.from_numpy(starts), window=window)
    return ref.decode_attention_paged_split(
        tq, tkp, tvp, torch.from_numpy(tables),
        lengths=torch.from_numpy(lengths), split_rows=rows, **ring)


def _pool_plain(tq, tkp, tvp, tables, starts, lengths, window):
    """The plain (unsplit) paged or ring version, numpy in."""
    if starts is None:
        return ref.decode_attention_paged(tq, tkp, tvp,
                                          torch.from_numpy(tables),
                                          lengths=torch.from_numpy(lengths))
    return ref.decode_attention_ring(
        tq, tkp, tvp, torch.from_numpy(tables),
        ring_starts=torch.from_numpy(starts),
        lengths=torch.from_numpy(lengths), window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,bs,w,window", POOL_SPLIT_CASES)
def test_pool_split_plain_at_split_and_tile_edges(dtype, layout, bs, w,
                                                  window):
    """Every edge of a chunk and a 64-row tile, for block sizes that do
    and do not divide 64, against the plain paged and ring versions: f32
    to 1e-5, bf16 within one bf16 ulp + 1e-5 (both round one f32 value
    once, summed in another order); a row of length 0 gives 0."""
    _, (tq, tkp, tvp), tables, starts, lengths, rows = _pool_split_case(
        bs + w, layout, bs, w, window, dtype)
    got = _pool_split(tq, tkp, tvp, tables, starts, lengths, rows, window)
    want = _pool_plain(tq, tkp, tvp, tables, starts, lengths, window)
    assert got.dtype == tq.dtype and got.shape == want.shape
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    got, want = got.float().numpy(), want.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_pool_split_plain_matches_jax_kernel_and_oracle(jx, dtype, layout):
    """The split arithmetic for the pool layouts against the TPU kernels in
    interpret mode and the JAX oracles, with rows of several chunks (f32 to
    1e-5; bf16 within one bf16 ulp + 1e-5). The row of length 0 is held
    against the kernel only: the JAX oracles average V there."""
    jax_ops, jax_ref = jx
    import jax.numpy as jnp
    bs, w, window = 16, 20, 300
    (q, kp, vp), (tq, tkp, tvp), tables, starts, lengths, rows = \
        _pool_split_case(15, layout, bs, w, window, dtype)
    got = _pool_split(tq, tkp, tvp, tables, starts, lengths, rows, window)
    jdt = getattr(jnp, dtype)
    jq, jkp, jvp = (jnp.asarray(a, jdt) for a in (q, kp, vp))
    jt, jl = jnp.asarray(tables), jnp.asarray(lengths)
    if layout == "paged":
        wants = [jax_ops.decode_attention_paged(jq, jkp, jvp, jt, jl,
                                                interpret=True),
                 jax_ref.decode_attention_paged(jq, jkp, jvp, jt, jl)]
    else:
        js = jnp.asarray(starts)
        wants = [jax_ops.decode_attention_ring(jq, jkp, jvp, jt, js, jl,
                                               window=window, interpret=True),
                 jax_ref.decode_attention_ring(jq, jkp, jvp, jt, js, jl,
                                               window=window)]
    for want, first in zip(wants, (0, 1)):
        want = np.asarray(want, np.float32)[first:]
        g = got[first:].float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)
        else:
            assert np.all(np.abs(g - want) <= _bf16_ulp(want) + 1e-5)


@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_pool_split_plain_is_bitwise_invariant_to_width_and_batch(layout):
    """A row's chunks do not depend on the table's width or the batch: its
    output is bitwise the same under a table of width W and of 2W (the
    extra entries null; a ring in its unrotated order, starts 0), and
    alone or in the batch."""
    bs, w, window = 8, 40, 320
    _, (tq, tkp, tvp), tables, starts, lengths, rows = _pool_split_case(
        16, layout, bs, w, window, "float32")
    base = _pool_split(tq, tkp, tvp, tables, starts, lengths, rows, window)
    flat = tables
    if starts is not None:
        flat = ref.ring_order(torch.from_numpy(tables),
                               torch.from_numpy(starts)).int().numpy()
    wide = np.concatenate([flat, np.zeros_like(flat)], axis=1)
    zeros = None if starts is None else np.zeros_like(starts)
    # past the cap the wider table holds more rows: those rows differ
    keep = lengths <= w * bs
    got = _pool_split(tq, tkp, tvp, wide, zeros, lengths, rows, window)
    assert torch.equal(got[keep], base[keep])
    for i in range(len(lengths)):
        one = None if starts is None else starts[i:i + 1]
        alone = _pool_split(tq[i:i + 1], tkp, tvp, tables[i:i + 1], one,
                            lengths[i:i + 1], rows, window)
        assert torch.equal(alone[0], base[i]), i


def test_ring_split_plain_rotation_invariant_and_narrow_table(jx):
    """Rotating (table, start) together leaves the split arithmetic
    bitwise unchanged; a table narrower than the ring (W * bs < window)
    caps the rows at W * bs, as the JAX oracle does."""
    _, jax_ref = jx
    import jax.numpy as jnp
    bs, w, window = 8, 40, 320
    _, (tq, tkp, tvp), tables, starts, lengths, rows = _pool_split_case(
        17, "ring", bs, w, window, "float32")
    base = _pool_split(tq, tkp, tvp, tables, starts, lengths, rows, window)
    for s in (1, w // 2, w - 1):
        rot = np.roll(tables, s, axis=1)
        out = _pool_split(tq, tkp, tvp, rot, (starts + s) % w, lengths, rows,
                          window)
        assert torch.equal(out, base)
    narrow = tables[:, :20]       # W * bs = 160 < window
    (q, kp, vp), _, _, _, _, _ = _pool_split_case(17, "ring", bs, w, window,
                                                  "float32")
    starts = starts % 20
    got = _pool_split(tq, tkp, tvp, narrow, starts, lengths, rows, window)
    want = jax_ref.decode_attention_ring(
        *(jnp.asarray(a, jnp.float32) for a in (q, kp, vp)),
        jnp.asarray(narrow), jnp.asarray(starts), jnp.asarray(lengths),
        window=window)
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(want)[1:],
                               rtol=1e-5, atol=1e-5)


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


def _bf16_close(got, want):
    """f32 accumulation in both: at most ~1 bf16 ulp of the output apart
    (2 ulp allowed: the two round their f32 sums in another order)."""
    want = want.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    return bool(((got.float() - want).abs() <= 2 * ulp + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kv,hd,window", [
    (256, 14, 2, 64, 0),      # the serving prefill's shape
    (96, 4, 2, 32, 0),        # ragged tile, smoke head_dim
    (200, 4, 1, 128, 64),     # MQA sliding window
    (200, 10, 1, 256, 0),     # recurrentgemma-2b's prefill (10:1 heads of 256)
    (300, 10, 1, 256, 128),   # ... with a window that binds
    (300, 32, 32, 96, 0),     # phi-3-vision's 32 heads of 96
])
def test_flash_kernel_matches_plain_version_on_card(cuda, dtype, s, h, kv,
                                                    hd, window):
    gen = torch.Generator(device=cuda).manual_seed(s + h)
    q = torch.randn((1, s, h, hd), generator=gen, device=cuda).to(dtype)
    # k and v as views of a fused [1, s, 2, kv, hd] buffer: strided input
    kvbuf = torch.randn((1, s, 2, kv, hd), generator=gen, device=cuda).to(dtype)
    k, v = kvbuf[:, :, 0], kvbuf[:, :, 1]
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = ref.attention(q, k, v, causal=True, window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,hd", [
    (8, 512, 14, 2, 64),      # the serving decode's shape
    (3, 100, 4, 2, 32),       # smoke head_dim, ragged tile
    (2, 300, 16, 2, 128),     # 8 heads of 128 per kv head
    (8, 2048, 10, 1, 256),    # recurrentgemma-2b: G * hd = 2560, full ring
    (3, 700, 10, 1, 256),     # ... ragged tile
    (4, 1280, 32, 32, 96),    # phi-3-vision: G = 1, hd 96
    (3, 1500, 12, 12, 64),    # whisper's cross-attention K/V
])
def test_decode_kernel_matches_plain_version_on_card(cuda, dtype, b, t, h,
                                                     kv, hd):
    gen = torch.Generator(device=cuda).manual_seed(b * t)
    q = torch.randn((b, h, hd), generator=gen, device=cuda).to(dtype)
    # k and v as one layer of an [L, B, T, KV, hd] arena
    arena = torch.randn((3, 2, b, t, kv, hd), generator=gen,
                        device=cuda).to(dtype)
    k, v = arena[1, 0], arena[1, 1]
    lengths = torch.randint(0, t + 1, (b,), generator=gen, device=cuda,
                            dtype=torch.int32)
    lengths[0] = t
    before = decode_attention_cuda.launches
    got = ops.decode_attention(q, k, v, lengths=lengths)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    want = ref.decode_attention(q, k, v, lengths=lengths)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_close(got, want)


def _flash_operands(cuda, seed, b, s, h, kv, hd, dtype):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda).to(dtype)
    kvbuf = torch.randn((b, s, 2, kv, hd), generator=gen,
                        device=cuda).to(dtype)
    return q, kvbuf[:, :, 0], kvbuf[:, :, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("s", [1, 15, 17, 65])
def test_flash_kernel_cuts_fragments_and_tiles_on_card(cuda, s, hd):
    """bf16 (the tensor-core body): prompts that cut the 16-row MMA
    fragments and the 64-row tiles, at every head_dim."""
    h, kv = (10, 1) if hd == 256 else (4, 2)
    q, k, v = _flash_operands(cuda, s * hd, 2, s, h, kv, hd, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_kernel_close(got, ref.attention(q, k, v, causal=True),
                         torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,h,kv,hd", [
    (1500, 1500, 12, 12, 64),   # whisper's encoder: 1500 is no tile multiple
    (200, 1500, 12, 12, 64),    # whisper's cross-attention prefill
    (1, 1500, 12, 12, 64),      # one query row
    (17, 17, 4, 2, 64),         # a cut 16-row fragment
    (65, 130, 4, 2, 96),        # S != T at hd 96, both cut mid-tile
])
def test_flash_kernel_noncausal_matches_plain_version_on_card(cuda, dtype, s,
                                                              t, h, kv, hd):
    """causal=False: no tile skipped, the keys' tail masked in the last
    tile only; a row's result alone equals it in the batch."""
    gen = torch.Generator(device=cuda).manual_seed(s + t + hd)
    q = torch.randn((2, s, h, hd), generator=gen, device=cuda).to(dtype)
    kvbuf = torch.randn((2, t, 2, kv, hd), generator=gen,
                        device=cuda).to(dtype)
    k, v = kvbuf[:, :, 0], kvbuf[:, :, 1]
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    _assert_kernel_close(got, ref.attention(q, k, v, causal=False), dtype)
    alone = ops.flash_attention(q[1:], k[1:], v[1:], causal=False)
    assert torch.equal(alone[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_kernel_at_hd96_on_card(cuda, dtype):
    """The ring kernel at head_dim 96 (G = 1): unwrapped, part-filled and
    wrapped rows against the plain version, bitwise under a rotation."""
    b, h, kv, hd, bs, window = 4, 8, 8, 96, 16, 256
    w = window // bs
    gen = torch.Generator(device=cuda).manual_seed(96)
    q, kp, vp, tables = _card_pool(cuda, gen, b, h, kv, hd, bs, w, dtype)
    lengths = torch.tensor([1, 131, window, 3 * window + 5],
                           dtype=torch.int32, device=cuda)
    zeros = torch.zeros(b, dtype=torch.int32, device=cuda)
    base = ops.decode_attention_ring(q, kp, vp, tables, ring_starts=zeros,
                                     lengths=lengths, window=window)
    torch.cuda.synchronize()
    _assert_kernel_close(base, ref.decode_attention_ring(
        q, kp, vp, tables, ring_starts=zeros, lengths=lengths,
        window=window), dtype)
    rot = torch.roll(tables, 5, dims=1).contiguous()
    out = ops.decode_attention_ring(q, kp, vp, rot,
                                    ring_starts=torch.full_like(zeros, 5),
                                    lengths=lengths, window=window)
    assert torch.equal(out, base) and _tickets_are_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("window", [40, 100])
def test_flash_kernel_window_ending_mid_tile_on_card(cuda, dtype, hd,
                                                     window):
    """Windows whose edge falls inside a 64-row tile and inside a warp's
    16 rows, over 150 positions."""
    h, kv = (10, 1) if hd == 256 else (4, 2)
    q, k, v = _flash_operands(cuda, window + hd, 1, 150, h, kv, hd, dtype)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    _assert_kernel_close(
        got, ref.attention(q, k, v, causal=True, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_kernel_row_alone_equals_row_in_batch_on_card(cuda, dtype, hd):
    h, kv = (10, 1) if hd == 256 else (14, 2)
    q, k, v = _flash_operands(cuda, hd, 8, 200, h, kv, hd, dtype)
    batch = ops.flash_attention(q, k, v, causal=True, window=64)
    for i in (0, 5):
        alone = ops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    causal=True, window=64)
        assert torch.equal(alone[0], batch[i])


def _split_operands(cuda, seed, h, kv, hd, t, dtype):
    """Decode operands whose lengths sit at every chunk and tile edge: 0,
    1, 63, 64, 65, R, R + 1 and T (T not a multiple of R), in an arena."""
    rows = split_rows(t, kv, hd)
    lengths = torch.tensor([0, 1, 63, 64, 65, rows, rows + 1, t],
                           dtype=torch.int32, device=cuda)
    b = lengths.numel()
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, h, hd), generator=gen, device=cuda).to(dtype)
    arena = torch.randn((2, 2, b, t, kv, hd), generator=gen,
                        device=cuda).to(dtype)
    return q, arena[1, 0], arena[1, 1], lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,hd,t", SPLIT_CASES)
def test_decode_kernel_split_edges_on_card(cuda, dtype, h, kv, hd, t):
    q, k, v, lengths = _split_operands(cuda, t, h, kv, hd, t, dtype)
    assert t % split_rows(t, kv, hd) and num_splits(t, kv, hd) > 2
    got = ops.decode_attention(q, k, v, lengths=lengths)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))     # length 0
    _assert_kernel_close(got, ref.decode_attention(q, k, v, lengths=lengths),
                         dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,hd,t", SPLIT_CASES[:2])
def test_decode_kernel_row_alone_equals_row_in_batch_on_card(cuda, dtype, h,
                                                             kv, hd, t):
    q, k, v, lengths = _split_operands(cuda, t + 1, h, kv, hd, t, dtype)
    batch = ops.decode_attention(q, k, v, lengths=lengths)
    for i in range(lengths.numel()):
        alone = ops.decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                     lengths=lengths[i:i + 1])
        assert torch.equal(alone[0], batch[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_back_to_back_calls_are_bitwise_equal_on_card(cuda,
                                                                    dtype):
    """The last split of each row resets its ticket counter: a second
    launch combines exactly as the first (else no block would combine)."""
    h, kv, hd, t = SPLIT_CASES[1]
    q, k, v, lengths = _split_operands(cuda, 3, h, kv, hd, t, dtype)
    first = ops.decode_attention(q, k, v, lengths=lengths)
    second = ops.decode_attention(q, k, v, lengths=lengths)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _bf16_within_one_ulp(got, want):
    """|kernel - plain| <= 1 bf16 ulp of plain + 1e-5: both accumulate in
    f32 (in another order) and round once."""
    want = want.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    return bool(((got.float() - want).abs() <= ulp + 1e-5).all())


def _assert_kernel_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_within_one_ulp(got, want)


def _card_pool(cuda, gen, b, h, kv, hd, bs, w, dtype):
    """q, and k/v pools as layer 1 of a [2, NB, bs, KV, hd] stack, with
    disjoint random tables of width w (NB = 1 + b * w + 3)."""
    nb = 1 + b * w + 3
    q = torch.randn((b, h, hd), generator=gen, device=cuda).to(dtype)
    stack = torch.randn((2, 2, nb, bs, kv, hd), generator=gen,
                        device=cuda).to(dtype)
    perm = torch.randperm(nb - 1, generator=gen, device=cuda) + 1
    tables = perm[:b * w].reshape(b, w).to(torch.int32).contiguous()
    return q, stack[0, 1], stack[1, 1], tables


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,hd,bs,w", [
    (8, 14, 2, 64, 16, 32),   # the serving decode's shape (<= 512 tokens)
    (3, 4, 2, 32, 8, 6),      # smoke head_dim, ragged tile
    (2, 16, 2, 128, 4, 40),   # 8 heads of 128 per kv head, tiny blocks
    (3, 10, 1, 256, 16, 8),   # G * hd = 2560 (the shared decode body)
    (2, 14, 2, 64, 16, 300),  # 38 splits of 128 rows (more than 32)
    (3, 32, 32, 96, 16, 20),  # phi-3-vision: G = 1, hd 96, 3 splits
])
def test_paged_kernel_matches_plain_version_on_card(cuda, dtype, b, h, kv,
                                                    hd, bs, w):
    """Lengths from 0 to past the table (a dead row drifted beyond W * bs
    attends to the whole table, as in the plain version); the kernel also
    matches the plain form of its split arithmetic, and leaves the ticket
    counters at 0."""
    gen = torch.Generator(device=cuda).manual_seed(b * w + hd)
    q, kp, vp, tables = _card_pool(cuda, gen, b, h, kv, hd, bs, w, dtype)
    lengths = torch.randint(0, w * bs + 1, (b,), generator=gen, device=cuda,
                            dtype=torch.int32)
    lengths[0] = w * bs
    lengths[-1] = w * bs + 37
    before = (decode_attention_paged_cuda.launches,
              decode_attention_cuda.launches)
    got = ops.decode_attention_paged(q, kp, vp, tables, lengths=lengths)
    torch.cuda.synchronize()
    assert decode_attention_paged_cuda.launches == before[0] + 1
    assert decode_attention_cuda.launches == before[1]
    want = ref.decode_attention_paged(q, kp, vp, tables, lengths=lengths)
    _assert_kernel_close(got, want, dtype)
    _assert_kernel_close(got, ref.decode_attention_paged_split(
        q, kp, vp, tables, lengths=lengths,
        split_rows=paged_split_rows(hd)), dtype)
    assert _tickets_are_zero()


def _tickets_are_zero():
    """The decode kernels' shared ticket counters, all back at 0."""
    return all(not bool(t.any()) for t in ticket_pool.TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,window", [(16, 256), (8, 40), (16, 4600)])
def test_ring_kernel_matches_plain_and_is_rotation_invariant_on_card(
        cuda, dtype, bs, window):
    """Unwrapped, part-filled and wrapped rows (a window of 4600 takes 36
    splits); rotating (table, start) together leaves the kernel's output
    bitwise unchanged."""
    b, h, kv, hd = 4, 14, 2, 64
    w = -(-window // bs)
    gen = torch.Generator(device=cuda).manual_seed(window)
    q, kp, vp, tables = _card_pool(cuda, gen, b, h, kv, hd, bs, w, dtype)
    lengths = torch.tensor([1, window // 2 + 3, window, 3 * window + 5],
                           dtype=torch.int32, device=cuda)
    zeros = torch.zeros(b, dtype=torch.int32, device=cuda)
    before = decode_attention_ring_cuda.launches
    base = ops.decode_attention_ring(q, kp, vp, tables, ring_starts=zeros,
                                     lengths=lengths, window=window)
    torch.cuda.synchronize()
    assert decode_attention_ring_cuda.launches == before + 1
    want = ref.decode_attention_ring(q, kp, vp, tables, ring_starts=zeros,
                                     lengths=lengths, window=window)
    _assert_kernel_close(base, want, dtype)
    for s in (1, w // 2, w - 1):
        rot = torch.roll(tables, s, dims=1).contiguous()
        starts = torch.full((b,), s, dtype=torch.int32, device=cuda)
        out = ops.decode_attention_ring(q, kp, vp, rot, ring_starts=starts,
                                        lengths=lengths, window=window)
        assert torch.equal(out, base)
    assert _tickets_are_zero()


def _card_pool_split_case(cuda, seed, layout, bs, w, window, dtype):
    """_pool_split_case's operands (14 query heads over 2 kv heads of 64)
    on the card."""
    _, (tq, tkp, tvp), tables, starts, lengths, rows = _pool_split_case(
        seed, layout, bs, w, window, {torch.float32: "float32",
                                      torch.bfloat16: "bfloat16"}[dtype],
        h=14)
    ring = {} if starts is None else dict(
        ring_starts=torch.from_numpy(starts).to(cuda), window=window)
    return ((tq.to(cuda), tkp.to(cuda), tvp.to(cuda)),
            torch.from_numpy(tables).to(cuda),
            torch.from_numpy(lengths).to(cuda), ring, rows)


def _pool_kernel(q, kp, vp, tables, lengths, ring):
    if ring:
        return ops.decode_attention_ring(q, kp, vp, tables, lengths=lengths,
                                         **ring)
    return ops.decode_attention_paged(q, kp, vp, tables, lengths=lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,bs,w,window", POOL_SPLIT_CASES)
def test_pool_kernel_split_edges_on_card(cuda, dtype, layout, bs, w, window):
    """Rows at every split and tile edge (lengths 0, 1, 63, 64, 65, R,
    R + 1, the cap, past it), block sizes 3, 4, 8 and 16: the kernel
    against the plain paged or ring version and the plain form of its
    split arithmetic; a row of length 0 gives 0; the tickets end at 0."""
    (q, kp, vp), tables, lengths, ring, rows = _card_pool_split_case(
        cuda, bs + w, layout, bs, w, window, dtype)
    got = _pool_kernel(q, kp, vp, tables, lengths, ring)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    if ring:
        want = ref.decode_attention_ring(q, kp, vp, tables, lengths=lengths,
                                         **ring)
    else:
        want = ref.decode_attention_paged(q, kp, vp, tables, lengths=lengths)
    _assert_kernel_close(got, want, dtype)
    _assert_kernel_close(got, ref.decode_attention_paged_split(
        q, kp, vp, tables, lengths=lengths, split_rows=rows, **ring), dtype)
    assert _tickets_are_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_pool_kernel_bitwise_invariant_to_width_and_batch_on_card(
        cuda, dtype, layout):
    """A row's output is bitwise the same under a table of width W and of
    2W (the extra entries null; a ring in unrotated order, starts 0), alone
    and in the batch of 9, and in two calls; the tickets end at 0."""
    bs, w, window = 8, 40, 320
    (q, kp, vp), tables, lengths, ring, _ = _card_pool_split_case(
        cuda, 16, layout, bs, w, window, dtype)
    base = _pool_kernel(q, kp, vp, tables, lengths, ring)
    assert torch.equal(_pool_kernel(q, kp, vp, tables, lengths, ring), base)
    flat = tables
    wide_ring = {}
    if ring:
        flat = ref.ring_order(tables, ring["ring_starts"]).int()
        wide_ring = dict(ring_starts=torch.zeros_like(ring["ring_starts"]),
                         window=window)
    wide = torch.cat([flat, torch.zeros_like(flat)], dim=1).contiguous()
    keep = lengths <= w * bs
    got = _pool_kernel(q, kp, vp, wide, lengths, wide_ring)
    assert torch.equal(got[keep], base[keep])
    for i in range(lengths.numel()):
        one = {k: (v[i:i + 1] if torch.is_tensor(v) else v)
               for k, v in ring.items()}
        alone = _pool_kernel(q[i:i + 1], kp, vp, tables[i:i + 1].contiguous(),
                             lengths[i:i + 1], one)
        assert torch.equal(alone[0], base[i]), i
    torch.cuda.synchronize()
    assert _tickets_are_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_with_identity_table_equals_linear_kernel(cuda, dtype):
    """The arena cut into blocks of 16 under an identity table: the paged
    kernel and the linear decode kernel agree within one bf16 ulp (they
    share one body, one tile order and, at R = 128 rows a split, one
    chunking and combine)."""
    b, t, h, kv, hd, bs = 8, 512, 14, 2, 64, 16
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((b, h, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, t, kv, hd), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=cuda,
                            dtype=torch.int32)
    w = t // bs
    null = torch.zeros((1, bs, kv, hd), dtype=dtype, device=cuda)
    pk, pv = (torch.cat([null, x.reshape(b * w, bs, kv, hd)]) for x in (k, v))
    tables = (1 + torch.arange(b * w, device=cuda)).reshape(b, w).to(
        torch.int32)
    paged = ops.decode_attention_paged(q, pk, pv, tables, lengths=lengths)
    linear = ops.decode_attention(q, k, v, lengths=lengths)
    assert _bf16_within_one_ulp(paged, linear)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_kernel_with_a_table_narrower_than_the_ring_on_card(cuda,
                                                                 dtype):
    """W * bs < window (the engine's table before any row outgrows it):
    rows attend to min(length, window, W * bs) slots, as the plain
    version; a dead row's drifted length stops at the table."""
    b, h, kv, hd, bs, window = 3, 14, 2, 64, 8, 256
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, kp, vp, tables = _card_pool(cuda, gen, b, h, kv, hd, bs, 2, dtype)
    tables[2] = 0
    lengths = torch.tensor([16, 9, 300], dtype=torch.int32, device=cuda)
    zeros = torch.zeros(b, dtype=torch.int32, device=cuda)
    got = ops.decode_attention_ring(q, kp, vp, tables, ring_starts=zeros,
                                    lengths=lengths, window=window)
    want = ref.decode_attention_ring(q, kp, vp, tables, ring_starts=zeros,
                                     lengths=lengths, window=window)
    _assert_kernel_close(got, want, dtype)


def _rwkv_close(got, want):
    """|kernel - plain| <= 1e-5 * rms(plain) + 1e-4 * |plain|, in f32 on
    both sides (bf16 inputs convert exactly): the sums run in another
    order (the chunked body also in another form, `ref.rwkv6_chunked`),
    the state carries each step's rounding into the next, and an output
    near zero is a cancelling sum of 64 terms of the outputs' size, so the
    absolute term scales with the outputs' RMS."""
    want = want.float()
    tol = 1e-5 * want.pow(2).mean().sqrt() + 1e-4 * want.abs()
    return bool(((got.float() - want).abs() <= tol).all())


# the reference's own bound on its chunked form against its sequential
# scan (tests/test_torch_rwkv.py CHUNKED_ATOL): at strong decays the
# chunked form's exponents lose what the sequential products keep
STRONG_DECAY_ATOL = 1e-3


def _rwkv_operands(cuda, gen, b, h, s, hd, dtype, strided, w0=-2.0):
    """r, k, v [B,H,S,hd] in dtype (strided: transposed views of one
    [B,S,3,H,hd] buffer, the model's layout), f32 decays exp(-exp(w0 +
    0.5 z)) (w0 = -2 is the model's initial decay), u at 0.1 and a
    unit-normal incoming state."""
    def draw(shape):
        return torch.randn(shape, generator=gen, device=cuda)
    if strided:
        qkv = draw((b, s, 3, h, hd)).to(dtype)
        r, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        w = draw((b, s, h, hd)).transpose(1, 2)
    else:
        r, k, v = (draw((b, h, s, hd)).to(dtype) for _ in range(3))
        w = draw((b, h, s, hd))
    w = torch.exp(-torch.exp(w0 + 0.5 * w))
    u = (0.1 * draw((h, hd))).to(dtype)
    return r, k, v, w, u, draw((b, h, hd, hd))


def test_wkv_body_depends_on_s_alone():
    """The step body below CHUNKED_MIN_STEPS, the chunked body of CHUNK
    steps (the source's one chunk length) from there on; the scratch
    covers whole chunks."""
    from repro_torch.kernels import build
    from repro_torch.kernels import rwkv6_scan as wkv
    src = (build.CSRC / "rwkv6_scan.cu").read_text()
    assert f"constexpr int kChunk = {wkv.CHUNK};" in src
    assert wkv.CHUNK == 64 and wkv.CHUNKED_MIN_STEPS > 1
    assert wkv.body(1) == wkv.body(wkv.CHUNKED_MIN_STEPS - 1) == 0
    assert wkv.body(wkv.CHUNKED_MIN_STEPS) == wkv.body(4096) == wkv.CHUNK
    assert wkv.scratch_floats(2, 3, 65, 64, 64) == 2 * 3 * 2 * (
        64 * 64 + 64 * 64 + 64)


# (b, s): decode, a prompt of 77, one S on each side of the chunked body's
# threshold, a chunk boundary, the model's prefill, and a long prompt on
# chunk bounds
WKV_CASES = [(5, 1), (2, 77), (2, CHUNKED_MIN_STEPS - 1),
             (2, CHUNKED_MIN_STEPS), (2, 128), (1, 200), (1, 4096)]
WKV_IDS = ["decode", "prefill", "below-threshold", "threshold",
           "chunk-boundary", "model-prefill", "long"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("b,s", WKV_CASES, ids=WKV_IDS)
@pytest.mark.parametrize("strided", [False, True],
                         ids=["contiguous", "model-layout"])
def test_rwkv6_kernel_matches_plain_version_on_card(cuda, dtype, hd, b, s,
                                                    strided):
    """Output and final state, from a nonzero state, against the plain
    version; the state is overwritten in place and returned."""
    gen = torch.Generator(device=cuda).manual_seed(hd * s + b)
    r, k, v, w, u, state = _rwkv_operands(cuda, gen, b, 3, s, hd, dtype,
                                          strided)
    got_state = state.clone()
    before = rwkv6_scan_cuda.launches
    out, returned = ops.rwkv6_scan(r, k, v, w, u, got_state)
    torch.cuda.synchronize()
    assert rwkv6_scan_cuda.launches == before + 1
    assert returned is got_state
    assert out.dtype == torch.float32 and out.shape == (b, 3, s, hd)
    want, want_state = ref.rwkv6(r, k, v, w, u, state)
    assert _rwkv_close(out, want)
    assert _rwkv_close(got_state, want_state)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w0", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("s", [200, 1024])
def test_rwkv6_kernel_at_strong_decays_on_card(cuda, dtype, w0, s):
    """Decays exp(-exp(w0 + 0.5 z)) far below the model's: the chunked
    body against the plain sequential loop within STRONG_DECAY_ATOL,
    output and final state, and its arithmetic (`ref.rwkv6_chunked`) on
    the same inputs within RWKV's rule."""
    gen = torch.Generator(device=cuda).manual_seed(int(10 * w0) + s)
    r, k, v, w, u, state = _rwkv_operands(cuda, gen, 1, 4, s, 64, dtype,
                                          True, w0=w0)
    got_state = state.clone()
    out, _ = ops.rwkv6_scan(r, k, v, w, u, got_state)
    torch.cuda.synchronize()
    want, want_state = ref.rwkv6(r, k, v, w, u, state)
    assert float((out - want).abs().max()) <= STRONG_DECAY_ATOL
    assert float((got_state - want_state).abs().max()) <= STRONG_DECAY_ATOL
    form, form_state = ref.rwkv6_chunked(r, k, v, w, u, state)
    assert _rwkv_close(out, form) and _rwkv_close(got_state, form_state)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_kernel_in_pieces_equals_one_pass_on_card(cuda, dtype):
    """A prompt cut in pieces (at 1, 40 and 95 of 130 steps: the pieces take
    the step body, the whole prompt the chunked body), the state carried
    in place, agrees with one pass under RWKV's rule; from a zero state
    the kernel is the plain version from none."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    r, k, v, w, u, state = _rwkv_operands(cuda, gen, 2, 4, 130, 64, dtype,
                                          True)
    whole_state = state.clone()
    whole, _ = ops.rwkv6_scan(r, k, v, w, u, whole_state)
    cuts = (0, 1, 40, 95, 130)
    pieces = [ops.rwkv6_scan(r[:, :, a:z], k[:, :, a:z], v[:, :, a:z],
                             w[:, :, a:z], u, state)[0]
              for a, z in zip(cuts, cuts[1:])]
    assert _rwkv_close(torch.cat(pieces, dim=2), whole)
    assert _rwkv_close(state, whole_state)
    out0, final0 = ops.rwkv6_scan(r, k, v, w, u, torch.zeros_like(state))
    want0, wfinal0 = ref.rwkv6(r, k, v, w, u)
    assert _rwkv_close(out0, want0) and _rwkv_close(final0, wfinal0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64])
def test_rwkv6_kernel_in_chunk_aligned_pieces_is_bitwise_on_card(cuda, dtype,
                                                                  hd):
    """Cut at chunk edges into three pieces that each take the chunked
    body (the last one ragged), the state carried in place: every chunk
    sees the same inputs and the same incoming state, so the pieces equal
    one pass bitwise, and each row alone equals its row in the batch."""
    from repro_torch.kernels.rwkv6_scan import CHUNK
    gen = torch.Generator(device=cuda).manual_seed(17 + hd)
    step = CHUNK * -(-CHUNKED_MIN_STEPS // CHUNK)   # whole chunks, chunked
    s = 3 * step - 7
    r, k, v, w, u, state = _rwkv_operands(cuda, gen, 2, 4, s, hd, dtype,
                                          True)
    whole_state = state.clone()
    whole, _ = ops.rwkv6_scan(r, k, v, w, u, whole_state)
    cuts = (0, step, 2 * step, s)
    carried = state.clone()
    pieces = [ops.rwkv6_scan(r[:, :, a:z], k[:, :, a:z], v[:, :, a:z],
                             w[:, :, a:z], u, carried)[0]
              for a, z in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(pieces, dim=2), whole)
    assert torch.equal(carried, whole_state)
    alone_state = state[1:].clone()
    alone, _ = ops.rwkv6_scan(r[1:], k[1:], v[1:], w[1:], u, alone_state)
    assert torch.equal(alone, whole[1:])
    assert torch.equal(alone_state, whole_state[1:])


@pytest.mark.cuda
def test_rwkv6_kernel_back_to_back_calls_are_bitwise_equal_on_card(cuda):
    """The chunked body's ticket counters are back at 0 after a call: a
    second call on the same inputs gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    r, k, v, w, u, state = _rwkv_operands(cuda, gen, 3, 5, 300, 64,
                                          torch.bfloat16, True)
    firsts = [ops.rwkv6_scan(r, k, v, w, u, state.clone()) for _ in range(2)]
    assert torch.equal(firsts[0][0], firsts[1][0])
    assert torch.equal(firsts[0][1], firsts[1][1])
    from repro_torch.kernels.tickets import TICKETS
    assert int(TICKETS[r.device].abs().sum()) == 0


def _rglru_operands(cuda, gen, b, s, w, dtype, strided):
    """The fused RG-LRU's inputs in dtype: gate products at the scale of
    He-initialised projections, xa at unit scale, b_a and b_i at 0.5, lamb
    spread over (-1, 3) with one channel past softplus's threshold of 20,
    and a unit-normal f32 incoming state; strided: ga, gi and xa as views
    of one [B, S, 3, W'] buffer, W' the next multiple of 8 (16-byte
    aligned strides, channels past W unread)."""
    def draw(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    if strided:
        wide = -(-w // 8) * 8
        buf = draw(b, s, 3, wide).to(dtype)
        ga, gi, xa = (buf[:, :, i, :w] for i in range(3))
    else:
        ga, gi, xa = (draw(b, s, w).to(dtype) for _ in range(3))
    b_a, b_i = ((0.5 * draw(w)).to(dtype) for _ in range(2))
    lamb = (-1.0 + 4.0 * torch.rand(w, generator=gen, device=cuda))
    lamb[w // 2] = 25.0
    return ga, gi, b_a, b_i, lamb.to(dtype), xa, draw(b, w)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w,strided", [
    (1, 200, 2560, False),    # recurrentgemma-2b's prefill
    (8, 1, 2560, False),      # ... and decode step
    (3, 37, 300, True),       # W not a multiple of the block, strided
], ids=["prefill", "decode", "ragged-strided"])
def test_rglru_kernel_matches_plain_version_on_card(cuda, out_dtype, b, s,
                                                    w, strided):
    """Bitwise: the kernel computes the gates, the decay and the scale
    with PyTorch's ops in their order and roundings, and each step's
    product and sum as the plain version's two ops; the output is in the
    inputs' dtype (`out_dtype`) and the state is overwritten in place."""
    gen = torch.Generator(device=cuda).manual_seed(b * s + w)
    *args, state = _rglru_operands(cuda, gen, b, s, w, out_dtype, strided)
    got_state = state.clone()
    before = rglru_scan_cuda.launches
    out, returned = ops.rglru_scan(*args, got_state)
    torch.cuda.synchronize()
    assert rglru_scan_cuda.launches == before + 1
    assert returned is got_state
    assert out.dtype == out_dtype and out.shape == (b, s, w)
    want, want_state = ref.rglru_gated(*args, state)
    assert torch.equal(out, want)
    assert torch.equal(got_state, want_state)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_in_pieces_equals_one_pass_on_card(cuda, out_dtype):
    """A prompt cut at 1, 16, 40, 64 and 95 of 130 steps (the kernel walks
    tiles of 64), the state carried in place, is bitwise one pass; from a
    zero state it is the plain version from none."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    ga, gi, b_a, b_i, lamb, xa, state = _rglru_operands(
        cuda, gen, 2, 130, 2560, out_dtype, True)
    whole_state = state.clone()
    whole, _ = ops.rglru_scan(ga, gi, b_a, b_i, lamb, xa, whole_state)
    cuts = (0, 1, 16, 40, 64, 95, 130)
    pieces = [ops.rglru_scan(ga[:, x:z], gi[:, x:z], b_a, b_i, lamb,
                             xa[:, x:z], state)[0]
              for x, z in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(pieces, dim=1), whole)
    assert torch.equal(state, whole_state)
    out0, final0 = ops.rglru_scan(ga, gi, b_a, b_i, lamb, xa,
                                  torch.zeros_like(state))
    want0, wfinal0 = ref.rglru_gated(ga, gi, b_a, b_i, lamb, xa)
    assert torch.equal(out0, want0) and torch.equal(final0, wfinal0)
