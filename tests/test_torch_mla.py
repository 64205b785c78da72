"""MLA (DeepSeek-V2's multi-head latent attention) in the port against
the JAX reference, at small sizes on the CPU: each `mla_*` function, the
latent caches on the arena and the pool, both mixed steps, deepseek-v2's
smoke config (MLA over the MoE with a shared expert) and a dense MLA
stack at `tests/test_server.py`'s `_mla_cfg` shape.

Both sides start from the reference's parameters (`params_from_jax`),
caches (`arena_from_jax`) and pools (`pool_from_jax`), see inputs made
with numpy and run in f32 unless a test says otherwise. The functions
agree to rtol 1e-5 / atol 1e-6 (out and caches: only the order of f32
sums differs), the model's loss, aux and gradients, one API-BCD superstep
and the serving engines as the MoE family's tests hold them. MLA's cores
are plain PyTorch on every device (the reference's are jnp outside any
Pallas kernel), so no kernel is on these paths.

The card tests (marker `cuda`) import no JAX: they hold `mla_decode` on
the card against the CPU and a decode step against its repeat.
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
from repro_torch.configs.base import ArchConfig, MLAConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.trainer import make_train_step  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    arena_from_jax, flatten, params_from_jax, pool_from_jax, state_from_jax)
from repro_torch.serve import Engine, probe_family_caps  # noqa: E402

ARCH = "deepseek-v2-236b"
RTOL, ATOL = 1e-5, 1e-6         # the functions alone: f32 sum orders
LOSS_RTOL = 1e-5
# gradients and serving logits: within 1e-5 of the leaf's (or the
# logits') scale
GRAD_ATOL = 1e-5
SLOTS, CAPACITY = 3, 32
# bf16 serving logits at deepseek's smoke config, as a fraction of max
# |reference logit|: the port's bf16 path lies within it and its f32 path
# (the control) does not. Measured on the CPU (the port's bf16 against
# the reference's bf16, then the f32 control): 0.01435 / 0.01837; the
# limit sits between them.
BF16_LOGIT_RTOL = 0.016
# (prompt_len, budget, arrival_step), as tests/test_server.py's _STAGGER
_STAGGER = [(9, 6, 0), (5, 8, 0), (7, 5, 2), (4, 7, 3), (6, 6, 5)]


@pytest.fixture(scope="module")
def jx():
    """The JAX reference (absent on the card's machine: only the `cuda`
    tests run there)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as jax_get_smoke
    from repro.configs.base import ArchConfig as JaxArchConfig
    from repro.configs.base import MLAConfig as JaxMLAConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.dist import trainer as jax_trainer
    from repro.models import attention as jax_attention
    from repro.models import build_model as jax_build_model
    from repro.serve import Engine as JaxEngine
    from repro.serve.engine import probe_family_caps as jax_probe
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_smoke=jax_get_smoke, ArchConfig=JaxArchConfig,
        MLAConfig=JaxMLAConfig, TrainConfig=JaxTrainConfig,
        trainer=jax_trainer, attention=jax_attention,
        build_model=jax_build_model, Engine=JaxEngine, probe=jax_probe)


def _np(jx, tree):
    return flatten(jx.jax.device_get(tree))


# tests/test_server.py's _mla_cfg: a dense MLA stack (head_dim 16)
_MLA_ARCH = dict(name="mla-overlap-t", family="dense", source="test",
                 num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                 d_ff=128, vocab_size=256, tie_embeddings=True)
_MLA = dict(kv_lora_rank=16, q_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)


def _mla_cfgs(jx, **change):
    """(reference config, port config) of the dense MLA stack, in f32."""
    arch = dict(_MLA_ARCH, compute_dtype="float32", **change)
    return (jx.ArchConfig(**arch, mla=jx.MLAConfig(**_MLA)),
            ArchConfig(**arch, mla=MLAConfig(**_MLA)))


# ---------------------------------------------------------------------------
# each mla_* function against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer(jx):
    """(reference config, port config, reference layer params, the port's
    copy): one MLA layer of the dense stack."""
    jcfg, cfg = _mla_cfgs(jx)
    jparams = jx.attention.mla_init(jx.jax.random.PRNGKey(4), jcfg,
                                    jx.jnp.float32)
    return jcfg, cfg, jparams, params_from_jax(jx.jax.device_get(jparams))


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _caches_close(got, want, skip_null=False):
    """Every leaf of a cache or pool layer; skip_null leaves the pool's
    block 0 out (dead rows and out-of-range chunk entries all write it,
    with an undefined winner on both sides)."""
    assert set(got) == set(want)
    lo = 1 if skip_null else 0
    for name, w in want.items():
        w = np.asarray(w)
        if name == "ptr":
            np.testing.assert_array_equal(got[name].numpy(), w)
        else:
            _close(got[name][lo:], w[lo:])


def test_mla_init_keys_fan_ins_and_scales(jx, layer):
    """Keys and shapes of the reference's mla_init, and each leaf's std
    within 10 % of its He scale 1/sqrt(fan-in): D for wq_a and wkv_a,
    q_lora for wq_b, r for wk_b and wv_b, H*v for wo; unit norm scales."""
    _, cfg, _, want = layer
    got = A.mla_init(torch.Generator().manual_seed(0), (), cfg,
                     torch.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    m, h = cfg.mla, cfg.num_heads
    fan_in = {"wq_a": cfg.d_model, "wkv_a": cfg.d_model,
              "wq_b": m.q_lora_rank, "wk_b": m.kv_lora_rank,
              "wv_b": m.kv_lora_rank, "wo": h * m.v_head_dim}
    for k, v in got.items():
        if k in fan_in:
            assert abs(float(v.std()) * fan_in[k] ** 0.5 - 1) < 0.1, k
        else:
            assert torch.equal(v, torch.ones_like(v)), k


def test_mla_prefill_matches_reference(jx, layer):
    jcfg, cfg, jparams, params = layer
    x = _x(2, 11, cfg.d_model, 1)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    jout, (jckv, jkpe) = jx.attention.mla_prefill(
        jparams, jcfg, jx.jnp.asarray(x), jx.jnp.asarray(pos))
    out, (ckv, kpe) = A.mla_prefill(params, cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()))
    for got, want in ((out, jout), (ckv, jckv), (kpe, jkpe)):
        _close(got, want)


def _latent_cache(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    m = cfg.mla
    return {"ckv": rng.standard_normal((b, t, m.kv_lora_rank)).astype(
                np.float32),
            "kpe": rng.standard_normal((b, t, m.qk_rope_head_dim)).astype(
                np.float32)}


@pytest.mark.parametrize("ptr", [5, (3, 9, 0)], ids=["scalar", "per_row"])
def test_mla_decode_matches_reference(jx, layer, ptr):
    """Three steps over a ring of 8 slots: every row at depth 5 (scalar
    ptr), or rows at 3, 9 (wrapped) and 0 (per-row ptr); out and the
    cache (ptr exact) after each step."""
    jcfg, cfg, jparams, params = layer
    jnp = jx.jnp
    b, t = 3, 8
    cache = _latent_cache(cfg, b, t, 2)
    ptr = np.asarray(ptr, np.int32)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    jcache["ptr"] = jnp.asarray(ptr)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tcache["ptr"] = torch.from_numpy(ptr.copy())
    for step in range(3):
        x = _x(b, 1, cfg.d_model, 10 + step)
        pos = np.broadcast_to(ptr + step, (b,)).reshape(b, 1).astype(np.int32)
        jout, jcache = jx.attention.mla_decode(jparams, jcfg,
                                               jnp.asarray(x), jcache,
                                               jnp.asarray(pos))
        out, tcache = A.mla_decode(params, cfg, torch.from_numpy(x), tcache,
                                   torch.from_numpy(pos.copy()))
        _close(out, jout)
        _caches_close(tcache, jcache)
    assert int(tcache["ptr"].max()) > t or ptr.ndim == 0


def _pool(cfg, nb, bs, seed):
    return _latent_cache(cfg, nb + 1, bs, seed)


@pytest.mark.parametrize("ctx_len,table", [
    (0, (3, 1, 5, 0)), (5, (3, 1, 5, 0)), (6, (2, 4))],
    ids=["ctx0", "ctx5", "tail_past_table"])
def test_mla_prefill_paged_matches_reference(jx, layer, ctx_len, table):
    """One chunk of 4 (its last entry a pad) against a pool of 7 blocks of
    4: with no context, with 5 tokens of context, and with a chunk whose
    tail lies past the table (routed to the null block)."""
    jcfg, cfg, jparams, params = layer
    jnp = jx.jnp
    pool = _pool(cfg, 7, 4, 3)
    table = np.asarray(table, np.int32)
    x = _x(1, 4, cfg.d_model, 4)
    jout, jpool = jx.attention.mla_prefill_paged(
        jparams, jcfg, jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in pool.items()},
        jnp.asarray(table), jnp.int32(ctx_len))
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    out, tpool = A.mla_prefill_paged(params, cfg, torch.from_numpy(x), tpool,
                                     torch.from_numpy(table), ctx_len)
    _close(out, jout)
    _caches_close(tpool, jpool, skip_null=True)


def test_mla_decode_paged_matches_reference(jx, layer):
    """Three rows over a pool of 9 blocks of 4, two steps: rows at 6 and
    11 tokens, and a dead row (zeroed table, length 0) on the null
    block."""
    jcfg, cfg, jparams, params = layer
    jnp = jx.jnp
    pool = _pool(cfg, 9, 4, 5)
    tables = np.array([[2, 7, 0, 0], [0, 0, 0, 0], [1, 4, 9, 3]], np.int32)
    lengths = np.array([6, 0, 11], np.int32)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    for step in range(2):
        x = _x(3, 1, cfg.d_model, 20 + step)
        jout, jpool = jx.attention.mla_decode_paged(
            jparams, jcfg, jnp.asarray(x), jpool, jnp.asarray(tables),
            jnp.asarray(lengths))
        out, tpool = A.mla_decode_paged(params, cfg, torch.from_numpy(x),
                                        tpool, torch.from_numpy(tables),
                                        torch.from_numpy(lengths))
        _close(out[[0, 2]], np.asarray(jout)[[0, 2]])
        _caches_close(tpool, jpool, skip_null=True)
        lengths = lengths + np.array([1, 0, 1], np.int32)


def test_mla_mixed_matches_reference(jx, layer):
    """Decode rows 0 and 2 of an arena of 3 (ptr 5 and 12, a ring of 8
    that wrapped) and a 6-token prompt, padded to 8, prefilled into dead
    slot 1: out and every arena leaf."""
    jcfg, cfg, jparams, params = layer
    jnp = jx.jnp
    nd, t, sp, p_len = 3, 8, 8, 6
    cache = _latent_cache(cfg, nd, t, 6)
    ptr = np.array([5, 2, 12], np.int32)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    jcache["ptr"] = jnp.asarray(ptr)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tcache["ptr"] = torch.from_numpy(ptr.copy())
    x = _x(1, nd + sp, cfg.d_model, 7)
    pos_d, pos_p = ptr[None], np.arange(sp, dtype=np.int32)[None]
    jout, jcache = jx.attention.mla_mixed(
        jparams, jcfg, jnp.asarray(x), nd, jnp.asarray(pos_d),
        jnp.asarray(pos_p), jcache, jnp.int32(p_len), jnp.int32(1))
    out, tcache = A.mla_mixed(params, cfg, torch.from_numpy(x), nd,
                              torch.from_numpy(pos_d.copy()),
                              torch.from_numpy(pos_p), tcache, p_len, 1)
    _close(out, jout)
    _caches_close(tcache, jcache)
    assert int(tcache["ptr"][1]) == p_len


def test_mla_mixed_paged_matches_reference(jx, layer):
    """Decode rows 0 and 2 (6 and 11 tokens) and dead row 1 over a pool of
    12 blocks of 4, and the second chunk of 4 (ctx 4) of a prompt
    streaming into its private table: out and every real block."""
    jcfg, cfg, jparams, params = layer
    jnp = jx.jnp
    nd, c, ctx_len = 3, 4, 4
    pool = _pool(cfg, 12, 4, 8)
    tables = np.array([[2, 7, 0, 0], [0, 0, 0, 0], [1, 4, 9, 3]], np.int32)
    lengths = np.array([6, 0, 11], np.int32)
    c_table = np.array([10, 11, 12, 0], np.int32)
    x = _x(1, nd + c, cfg.d_model, 9)
    pos_d = lengths[None]
    pos_p = (ctx_len + np.arange(c, dtype=np.int32))[None]
    jout, jpool = jx.attention.mla_mixed_paged(
        jparams, jcfg, jnp.asarray(x), nd, jnp.asarray(pos_d),
        jnp.asarray(pos_p), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(tables), jnp.asarray(lengths), jnp.int32(ctx_len),
        jnp.asarray(c_table))
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    out, tpool = A.mla_mixed_paged(
        params, cfg, torch.from_numpy(x), nd, torch.from_numpy(pos_d.copy()),
        torch.from_numpy(pos_p), tpool, torch.from_numpy(tables),
        torch.from_numpy(lengths), ctx_len, torch.from_numpy(c_table))
    _close(out[:, [0, 2, 3, 4, 5, 6]], np.asarray(jout)[:, [0, 2, 3, 4, 5, 6]])
    _caches_close(tpool, jpool, skip_null=True)


# ---------------------------------------------------------------------------
# init, the caches' conversion, the caps
# ---------------------------------------------------------------------------


def _models(jx, jcfg, cfg, seed=0, window=0):
    """(reference model, its params, port model, the params converted)."""
    jmodel = jx.build_model(jcfg, window=window)
    jparams = jmodel.init(jx.jax.random.PRNGKey(seed))
    return jmodel, jparams, build_model(cfg, window=window), params_from_jax(
        jx.jax.device_get(jparams))


@pytest.fixture(scope="module")
def deepseek(jx):
    """deepseek-v2's smoke config in f32 on both sides."""
    return _models(jx, dataclasses.replace(jx.get_smoke(ARCH),
                                           compute_dtype="float32"),
                   dataclasses.replace(get_smoke(ARCH),
                                       compute_dtype="float32"))


@pytest.fixture(scope="module")
def dense_mla(jx):
    """The dense MLA stack in f32 on both sides."""
    return _models(jx, *_mla_cfgs(jx))


@pytest.mark.parametrize("which", ["deepseek", "dense_mla"])
def test_init_keys_shapes_and_scales_match_reference(jx, request, which):
    """transformer_init has the reference's leaves and shapes (MLA's under
    segments.0.attn, deepseek's experts and shared expert under
    segments.0.moe), each leaf's std within 10 % of the reference's."""
    _, jparams, model, _ = request.getfixturevalue(which)
    want = _np(jx, jparams)
    got = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert "segments.0.attn.wkv_a" in got and "segments.0.attn.wq" not in got
    assert ("segments.0.moe.shared.w_down" in got) == (which == "deepseek")
    for k, v in want.items():
        if v.std() > 0:
            assert abs(float(got[k].float().std()) / float(v.std()) - 1) \
                < 0.1, k
        else:
            assert float(got[k].float().std()) == 0, k


@pytest.mark.parametrize("which", ["deepseek", "dense_mla"])
def test_latent_arena_and_pool_convert_from_reference(jx, request, which):
    """arena_from_jax takes the reference's {ckv, kpe, ptr} and
    pool_from_jax its {ckv, kpe}: shapes and dtypes equal the port's own
    init_arena and init_pool (deepseek has no pool: the reference's
    raises for "moe")."""
    jmodel, _, model, _ = request.getfixturevalue(which)
    jnp = jx.jnp
    got = arena_from_jax(jx.jax.device_get(jmodel.init_arena(
        SLOTS, CAPACITY, dtype=jnp.bfloat16)))
    want = model.init_arena(SLOTS, CAPACITY)
    m = model.cfg.mla
    assert [{k: (tuple(v.shape), v.dtype) for k, v in seg.items()}
            for seg in got] == [
        {k: (tuple(v.shape), v.dtype) for k, v in seg.items()}
        for seg in want] == [
        {"ckv": ((2, SLOTS, CAPACITY, m.kv_lora_rank), torch.bfloat16),
         "kpe": ((2, SLOTS, CAPACITY, m.qk_rope_head_dim), torch.bfloat16),
         "ptr": ((2, SLOTS), torch.int32)}]
    if which == "deepseek":
        assert model.init_pool is None
        return
    got = pool_from_jax(jx.jax.device_get(jmodel.init_pool(
        6, 4, dtype=jnp.float32)))
    want = model.init_pool(6, 4, dtype=torch.float32)
    assert [{k: (tuple(v.shape), v.dtype) for k, v in seg.items()}
            for seg in got] == [
        {k: (tuple(v.shape), v.dtype) for k, v in seg.items()}
        for seg in want] == [
        {"ckv": ((2, 7, 4, m.kv_lora_rank), torch.float32),
         "kpe": ((2, 7, 4, m.qk_rope_head_dim), torch.float32)}]


@pytest.mark.parametrize("case,want", [
    ("dense", (True, True, True, True)),
    ("windowed", (False, False, False, False)),
    ("windowed_wide", (True, False, False, True)),
    ("deepseek", (False, False, False, False))])
def test_family_caps_equal_reference(jx, case, want):
    """FamilyCaps at capacity 32, the port's probe beside the reference's:
    the dense MLA stack gets everything; with a window of 16 nothing (its
    init_pool raises, and the ring cuts padding); with a window of 64
    (past the capacity) the arena pads and overlaps but nothing pages;
    deepseek (moe) nothing."""
    if case == "deepseek":
        jcfg, cfg = jx.get_smoke(ARCH), get_smoke(ARCH)
    else:
        jcfg, cfg = _mla_cfgs(jx)
    window = {"windowed": 16, "windowed_wide": 64}.get(case, 0)
    jcaps = jx.probe(jx.build_model(jcfg, window=window), max_batch=2,
                     capacity=CAPACITY)
    caps = probe_family_caps(build_model(cfg, window=window),
                             capacity=CAPACITY)
    assert dataclasses.astuple(caps) == dataclasses.astuple(jcaps) == want


@pytest.mark.parametrize("how", ["override", "config"])
def test_init_pool_refuses_windowed_mla(jx, how):
    """A windowed MLA model's init_pool raises, with the reference's
    reason, whether the window is the model's override or the config's
    own; the engine then serves it from the arena."""
    _, cfg = _mla_cfgs(jx)
    if how == "config":
        cfg = dataclasses.replace(cfg, attn_window=16)
    model = build_model(cfg, window=16 if how == "override" else 0)
    with pytest.raises(NotImplementedError, match="GQA-only"):
        model.init_pool(4, 4)
    with pytest.raises(NotImplementedError, match="windowed-MLA"):
        TF.init_pool(cfg, 4, 4, window=16)
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                 max_batch=2, max_len=CAPACITY, paged=True)
    assert not eng.paged and not eng.overlap


# ---------------------------------------------------------------------------
# deepseek's smoke config: loss, aux, gradients, the superstep
# ---------------------------------------------------------------------------


def _batch(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_loss_aux_and_every_gradient_match_reference(jx, deepseek,
                                                           remat):
    """loss, nll and aux (nonzero) within rtol 1e-5; every gradient leaf,
    MLA's and the router's included, within 1e-5 of its leaf's largest
    |gradient| (at least 1)."""
    jmodel, jparams, model, params = deepseek
    toks, targs = _batch(model.cfg.vocab_size, 2, 24, 5)
    jnp = jx.jnp
    (jloss, jmetrics), jgrads = jx.jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, b, remat=remat), has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targs)})
    jgrads = _np(jx, jgrads)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, metrics = model.train_loss(
        leaves, {"tokens": torch.from_numpy(toks),
                 "targets": torch.from_numpy(targs)}, remat=remat)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert float(metrics["aux"]) > 0
    for got, want in ((loss, jloss), (metrics["nll"], jmetrics["nll"]),
                      (metrics["aux"], jmetrics["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert set(grads) == set(jgrads)
    assert float(np.abs(jgrads["segments.0.attn.wkv_a"]).max()) > 0
    for k in sorted(jgrads):
        atol = GRAD_ATOL * max(1.0, float(np.abs(jgrads[k]).max()))
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k], rtol=0,
                                   atol=atol, err_msg=k)


def test_one_superstep_matches_reference(jx):
    """One API-BCD superstep of the reference's make_train_step and the
    port's from one state (A=4, M=2, 2 x 16 tokens an agent): loss and aux
    rtol 1e-5; params, token and zhat within 1e-4, gacc within 1e-4 of its
    leaf's largest |value| where that passes 1 (chip_smoke phase 37's
    rule); 20 leaves (3 top-level, 2 norms, 8 MLA, 7 MoE)."""
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
    assert len(state["params"]) == 20
    toks, targs = next(agent_batches(cfg.vocab_size, a, 2, 16, seed=0))
    jstate, jmetrics = jx.jax.jit(jx.trainer.make_train_step(jmodel, jtcfg))(
        jstate, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targs)},
        jnp.int32(0))
    state, metrics = make_train_step(
        build_model(cfg), TrainConfig(num_agents=a, num_walks=m))(
        state, {"tokens": torch.from_numpy(toks),
                "targets": torch.from_numpy(targs)}, 0)
    for name in ("loss", "aux"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=LOSS_RTOL)
    assert float(metrics["aux"]) > 0
    for part in ("params", "token", "zhat", "gacc"):
        want = _np(jx, jstate[part])
        assert set(state[part]) == set(want)
        for k, v in want.items():
            atol = 1e-4 * (max(1.0, float(np.abs(v).max()))
                           if part == "gacc" else 1.0)
            np.testing.assert_allclose(state[part][k].numpy(), v, rtol=0,
                                       atol=atol, err_msg=f"{part}/{k}")


# ---------------------------------------------------------------------------
# serving against the reference's engines
# ---------------------------------------------------------------------------


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


def _drain(eng, max_steps=800):
    """Every finished request by uid; a livelock fails instead of
    hanging the suite."""
    done = {}
    for _ in range(max_steps):
        for r in eng.step():
            done[r.uid] = r
        if not (eng.pending or eng.num_active):
            return done
    raise AssertionError(f"engine did not drain in {max_steps} steps")


def test_deepseek_engine_matches_reference_with_mid_flight_admission(
        jx, deepseek):
    """The port's copy of tests/test_server.py's other-families check on
    deepseek: a request admitted mid-flight gets the tokens of the
    reference's engine serving it alone, from the serialized arena, every
    prompt prefilled at its exact length (prefill_shapes == {5, 7})."""
    jmodel, jparams, model, params = deepseek
    a, b = (p for p in np.random.default_rng(14).integers(
        0, model.cfg.vocab_size, (2, 7)))
    a = a[:5]
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
    assert not eng.paged and not eng.overlap


def test_deepseek_arena_caches_and_logits_match_reference(jx, deepseek):
    """prefill_into_slot at exact lengths into slots 0 and 2 and 6
    decode_rows steps: logits within 1e-5 of their scale, and the
    reference's latent arena, converted with arena_from_jax, equal to the
    port's (ckv, kpe within 1e-5, ptr exact)."""
    jmodel, jparams, model, params = deepseek
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
    for name in ("ckv", "kpe"):
        close(arena[0][name][:, [0, 2]], want[name][:, [0, 2]].numpy())


def test_paged_longer_than_slot_matches_reference(jx, dense_mla):
    """tests/test_server.py's test_engine_paged_longer_than_slot_mla on
    the port: 9 + 18 tokens past a slot of 16, through a pool of blocks of
    4 and chunks of 4, with another request in flight: the reference
    paged engine's tokens, every block returned."""
    jmodel, jparams, model, params = dense_mla
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, model.cfg.vocab_size, (9,))
    other = rng.integers(0, model.cfg.vocab_size, (5,))
    outs = []
    for eng in (jx.Engine(jmodel, jparams, max_batch=2, max_len=16,
                          paged=True, block_size=4, prefill_chunk=4,
                          cache_dtype=jx.jnp.float32),
                Engine(model, params, max_batch=2, max_len=16, paged=True,
                       block_size=4, prefill_chunk=4,
                       cache_dtype=torch.float32)):
        assert eng.paged
        uid = eng.submit(prompt, max_new_tokens=18)
        eng.submit(other, max_new_tokens=8)
        done = {r.uid: r.output.tolist() for r in eng.run()}
        outs.append(done[uid])
        assert eng.free_blocks == eng.num_blocks
    assert outs[0] == outs[1] and len(outs[1]) == 18


def test_paged_preemption_matches_reference(jx, dense_mla):
    """tests/test_server.py's test_engine_paged_preemption_bit_identity_mla
    on the port: two requests whose worst case (5 blocks each) overflows a
    pool of 7; the younger is preempted and recomputed, and both get the
    reference's tokens (its own arena run's)."""
    jmodel, jparams, model, params = dense_mla
    rng = np.random.default_rng(31)
    pa, pb = (rng.integers(0, model.cfg.vocab_size, (6,)) for _ in range(2))
    refs = []
    for p in (pa, pb):
        r = jx.Engine(jmodel, jparams, max_batch=2, max_len=32,
                      cache_dtype=jx.jnp.float32)
        r.submit(p, max_new_tokens=15)
        refs.append(r.run()[0].output.tolist())
    eng = Engine(model, params, max_batch=2, max_len=32, paged=True,
                 block_size=4, num_blocks=7, prefill_chunk=4,
                 cache_dtype=torch.float32)
    ua = eng.submit(pa, max_new_tokens=15)
    ub = eng.submit(pb, max_new_tokens=15)
    done = _drain(eng)
    assert eng.num_preemptions >= 1 and done[ub].preemptions >= 1
    assert [done[ua].output.tolist(), done[ub].output.tolist()] == refs
    assert eng.free_blocks == eng.num_blocks


def _run_staggered(engine, vocab):
    """Drive `_STAGGER` through `engine`; returns (outputs in submit
    order, final stats)."""
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, vocab, (int(n),)), int(b))
            for n, b, _ in _STAGGER]
    outs, uids, nxt, step_i = {}, [], 0, 0
    while nxt < len(reqs) or engine.num_active or engine.pending:
        assert step_i < 400, "the engine did not drain"
        while nxt < len(reqs) and _STAGGER[nxt][2] <= step_i:
            p, b = reqs[nxt]
            uids.append(engine.submit(p, max_new_tokens=b))
            nxt += 1
        for r in engine.step():
            outs[r.uid] = r.output.tolist()
        step_i += 1
    return [outs[u] for u in uids], engine.stats


@pytest.mark.parametrize("paged", [False, True], ids=["arena", "paged"])
def test_overlap_vs_serialized_matches_reference(jx, dense_mla, paged):
    """tests/test_server.py's test_overlap_vs_serialized_bit_identity, mla
    cases, on the port: the staggered workload (the pool starved at 6
    blocks, so both schedulers preempt) gives the reference's serialized
    tokens overlapped and serialized, with mixed steps and overlapped
    admissions in the overlapped run."""
    jmodel, jparams, model, params = dense_mla
    kw = dict(max_batch=2, max_len=24, paged=paged, block_size=4,
              prefill_chunk=4, num_blocks=6 if paged else None)
    want, _ = _run_staggered(jx.Engine(jmodel, jparams, overlap=False,
                                       cache_dtype=jx.jnp.float32, **kw),
                             model.cfg.vocab_size)
    ser, st_s = _run_staggered(Engine(model, params, overlap=False,
                                      cache_dtype=torch.float32, **kw),
                               model.cfg.vocab_size)
    ov, st_o = _run_staggered(Engine(model, params, overlap=True,
                                     cache_dtype=torch.float32, **kw),
                              model.cfg.vocab_size)
    assert ov == ser == want
    assert st_o["overlap_mode"] == "fused"
    assert st_o["mixed_steps"] > 0 and st_o["overlapped_admissions"] > 0
    assert st_s["mixed_steps"] == st_s["overlapped_admissions"] == 0
    if paged:
        assert st_s["preemptions"] > 0 and st_o["preemptions"] > 0


def test_decode_row_batched_equals_the_row_alone(dense_mla):
    """A decode row's logits do not depend on the other rows: bitwise
    equal in an arena whose other slots hold other requests and in one
    where they are empty."""
    _, _, model, params = dense_mla
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
    """deepseek's smoke config in its own bf16 compute: the port's logits
    lie within BF16_LOGIT_RTOL of the reference's largest |logit|, and the
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
# the CLIs on the CPU, and the full config
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


def test_serve_cli_names_the_windowed_mla_reason(capsys):
    """A windowed dense MLA config (one the registry does not hold, given
    to `launch.serve.serve`) with --paged serves from the arena, each
    prompt at its exact length, and names its reason."""
    cfg = dataclasses.replace(ArchConfig(**_MLA_ARCH, mla=MLAConfig(**_MLA)),
                              attn_window=8)
    argv = ["--requests", "2", "--max-batch", "2", "--prompt-len", "12",
            "--new-tokens", "3", "--device", "cpu", "--paged"]
    out = serve_cli.serve(serve_cli.parse_args(argv), cfg=cfg)
    assert not out["paged"] and out["prefill_shapes"] == [12]
    assert ("cannot page (windowed MLA has no windowed arena family)"
            in capsys.readouterr().out)


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
    """deepseek-v2-236b itself builds, cut by --layers as the serving CLI
    cuts it; its widths cut here too (the dtype and the leaves are all
    this checks)."""
    full = get_config(ARCH)
    model = build_model(full)
    assert model.init_pool is None and full.param_dtype == "bfloat16"
    args = serve_cli.parse_args(["--arch", ARCH, "--layers", "4"])
    assert args.layers == 4
    cfg = dataclasses.replace(
        full, num_layers=1, layer_types=("moe",), d_model=64, num_heads=4,
        num_kv_heads=4, vocab_size=64,
        moe=dataclasses.replace(full.moe, num_experts=8, d_ff_expert=32),
        mla=MLAConfig(kv_lora_rank=16, q_lora_rank=24, qk_nope_head_dim=8,
                      qk_rope_head_dim=4, v_head_dim=8))
    params = TF.transformer_init(cfg, torch.Generator().manual_seed(0))
    assert {v.dtype for v in params.values()} == {torch.bfloat16}
    assert params["segments.0.attn.wq_b"].shape == (1, 24, 4 * 12)
    assert params["segments.0.moe.w_gate"].shape == (1, 8, 64, 32)


# ---------------------------------------------------------------------------
# on the card (no JAX)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mla_decode_on_card_matches_cpu(cuda, monkeypatch):
    """f32 (TF32 off): three absorbed decode steps over a ring of 8 that
    wraps, per-row ptr, out and cache within 1e-5."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = ArchConfig(**_MLA_ARCH, mla=MLAConfig(**_MLA))
    params = A.mla_init(torch.Generator().manual_seed(0), (), cfg,
                        torch.float32)
    cache = {k: torch.from_numpy(v) for k, v in
             _latent_cache(cfg, 3, 8, 2).items()}
    cache["ptr"] = torch.tensor([3, 9, 0], dtype=torch.int32)
    card = {k: v.to(cuda) for k, v in cache.items()}
    pcard = {k: v.to(cuda) for k, v in params.items()}
    for step in range(3):
        x = torch.from_numpy(_x(3, 1, cfg.d_model, 10 + step))
        pos = (cache["ptr"] + 0).reshape(3, 1)
        want, _ = A.mla_decode(params, cfg, x, cache, pos)
        got, _ = A.mla_decode(pcard, cfg, x.to(cuda), card, pos.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
        for k in cache:
            torch.testing.assert_close(card[k].cpu(), cache[k], rtol=0,
                                       atol=1e-5)


@pytest.mark.cuda
def test_decode_step_on_card_repeats_bitwise(cuda):
    """bf16 deepseek smoke config on the card: a decode step over 3 live
    rows run twice on copies of one arena gives the same logits bitwise."""
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
