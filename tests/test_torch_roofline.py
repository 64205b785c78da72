"""Cost accounting of the port (`repro_torch.utils.roofline`,
`kernels.costs`, the specs of `models.model`) against the JAX reference
and against PERF.md §6, on the CPU.

  * INPUT_SHAPES and get_train equal the reference's, field for field;
  * for all 10 architectures and 4 shapes, input_specs and cache_specs
    (fake tensors) give the reference's keys, shapes and dtypes
    (`jax.eval_shape`), the caches mapped as `convert.arena_from_jax`
    maps them;
  * parameter counts, expert counts, active_params and model_flops at
    full width equal the reference's numbers exactly;
  * each `costs` formula reproduces PERF.md §6's bound column within 1 %
    at the shapes the column states;
  * one decoder layer of qwen2 and one MoE layer of dbrx's smoke config
    count the closed forms written out here;
  * a smoke superstep, prefill and decode step count the same FLOPs and
    bytes on the CPU and on fake tensors, and the dry run's superstep
    count (one agent's gradient A times) equals the whole step's.

The reference is imported inside a fixture, so that the file collects
without JAX.
"""
import dataclasses
import math
import os
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,  # noqa: E402
                                 get_smoke, get_train)
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.dist.trainer import init_train_state  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.model import (cache_specs, input_specs,  # noqa: E402
                                      param_specs)
from repro_torch.utils import roofline as RL  # noqa: E402

ARCHS = list(ARCH_IDS)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: configs, specs, roofline helpers and the dry
    run's expert count (its module sets XLA_FLAGS at import, which is
    undone here)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import configs as RC
    from repro.dist.trainer import init_train_state
    from repro.models import build_model as jax_build_model
    from repro.models import model as RM
    from repro.utils import roofline as RR
    with mock.patch.dict(os.environ):
        from repro.launch.dryrun import _expert_param_count
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, configs=RC, model=RM, roofline=RR,
        build_model=jax_build_model, init_train_state=init_train_state,
        expert_param_count=_expert_param_count)


def _window(cfg, shape):
    """The dry run's long-context window, as the reference's."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return cfg.long_context_window
    return 0


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------


def test_input_shapes_equal_the_reference(jx):
    assert list(INPUT_SHAPES) == list(jx.configs.INPUT_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jx.configs.INPUT_SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_get_train_equals_the_reference(jx, arch):
    """Every field the port's TrainConfig keeps (the mesh-only ones come
    with the multi-device slice) equals the reference's."""
    mine, theirs = get_train(arch), jx.configs.get_train(arch)
    fields = [f.name for f in dataclasses.fields(mine)]
    assert set(fields) <= {f.name for f in dataclasses.fields(theirs)}
    assert {f: getattr(mine, f) for f in fields} == {
        f: getattr(theirs, f) for f in fields}


def _cache_layout(tree):
    """The reference's cache pytree as `arena_from_jax` maps it: recurrent
    leaves in f32, ptr in int32."""
    out = {}
    segs = [tree] if isinstance(tree, dict) else list(tree)
    for si, seg in enumerate(segs):
        names = set(seg)
        recurrent = names in ({"shift", "wkv", "cm_shift"}, {"conv", "h"})
        for name, leaf in seg.items():
            dtype = str(leaf.dtype)
            if recurrent:
                dtype = "float32"
            elif name == "ptr":
                dtype = "int32"
            key = name if isinstance(tree, dict) else f"{si}.{name}"
            out[key] = (tuple(leaf.shape), dtype)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_equal_the_reference(jx, arch):
    cfg, jcfg = get_config(arch), jx.configs.get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        jshape = jx.configs.INPUT_SHAPES[name]
        window = _window(cfg, shape)
        mine = input_specs(cfg, shape, window)
        theirs = jx.model.input_specs(jcfg, jshape, window)
        assert set(mine) == set(theirs), (arch, name)
        for k in mine:
            assert tuple(mine[k].shape) == tuple(theirs[k].shape), (arch, k)
            assert _dtype_name(mine[k].dtype) == str(theirs[k].dtype)
            assert costs.is_fake(mine[k])
        if shape.kind != "decode":
            continue
        mine_c = cache_specs(cfg, shape, window)
        theirs_c = jx.model.cache_specs(jcfg, jshape, window)
        assert type(mine_c) is type(theirs_c) or (
            isinstance(mine_c, list) and isinstance(theirs_c, list))
        segs = [mine_c] if isinstance(mine_c, dict) else mine_c
        got = {}
        for si, seg in enumerate(segs):
            for leaf, t in seg.items():
                assert costs.is_fake(t)
                key = leaf if isinstance(mine_c, dict) else f"{si}.{leaf}"
                got[key] = (tuple(t.shape), _dtype_name(t.dtype))
        assert got == _cache_layout(theirs_c), (arch, name)


def test_vlm_text_must_follow_the_patch_prefix(jx):
    cfg = get_config("phi-3-vision-4.2b")
    jcfg = jx.configs.get_config("phi-3-vision-4.2b")
    short = ShapeConfig("short", cfg.num_patches, 2, "train")
    with pytest.raises(AssertionError, match="patch prefix"):
        jx.model.input_specs(jcfg, short)
    with pytest.raises(ValueError, match="patch prefix"):
        input_specs(cfg, short)
    ok = input_specs(cfg, dataclasses.replace(short,
                                              seq_len=cfg.num_patches + 1))
    assert tuple(ok["tokens"].shape) == (2, 1)


def test_specs_allocate_nothing():
    """deepseek-v2-236b's 239 B parameters as fake tensors."""
    p = param_specs(get_config("deepseek-v2-236b"))
    assert RL.count_params(p) > 2e11
    assert all(costs.is_fake(t) for t in p.values())


# ---------------------------------------------------------------------------
# counts at full width against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(jx, arch):
    cfg, jcfg = get_config(arch), jx.configs.get_config(arch)
    params = param_specs(cfg)
    jparams = jx.jax.eval_shape(jx.build_model(jcfg).init,
                                jx.jax.ShapeDtypeStruct((2,), jx.jnp.uint32))
    n, jn = RL.count_params(params), jx.roofline.count_params(jparams)
    e, je = (dryrun._expert_param_count(params),
             jx.expert_param_count(jparams))
    assert (n, e) == (jn, je)
    act = RL.active_params(cfg, n, e)
    assert act == jx.roofline.active_params(jcfg, jn, je)
    for name, shape in INPUT_SHAPES.items():
        assert RL.model_flops(cfg, shape, n, act) == \
            jx.roofline.model_flops(jcfg, jx.configs.INPUT_SHAPES[name],
                                    jn, act)
    # the train state's count: the agent axis in front, one replica counted
    tcfg, jtcfg = get_train(arch), jx.configs.get_train(arch)
    a = tcfg.num_agents
    with FakeTensorMode():
        state = init_train_state(build_model(cfg), tcfg,
                                 torch.Generator())
    jstate = jx.init_train_state(jx.build_model(jcfg), jtcfg)
    assert RL.count_params(state["params"]) // a == \
        jx.roofline.count_params(jstate["params"]) // a
    assert dryrun._expert_param_count(state["params"]) // a == \
        jx.expert_param_count(jstate["params"]) // a


def test_qwen2_has_the_published_parameter_count():
    assert RL.count_params(param_specs(get_config("qwen2-0.5b"))) == \
        494_032_768


# ---------------------------------------------------------------------------
# kernel formulas against PERF.md §6's bound column
# ---------------------------------------------------------------------------

BF, F32 = torch.bfloat16, torch.float32


def _t(shape, dtype=BF):
    return torch.empty(shape, dtype=dtype)


def _lengths(values):
    return torch.tensor(values, dtype=torch.int32)


# (label, cost function of fake tensors, PERF.md §6's bound ms)
PERF_BOUNDS = [
    ("flash S 256 (bytes)", lambda: costs.flash_attention(
        _t((1, 256, 14, 64)), _t((1, 256, 2, 64)), _t((1, 256, 2, 64))),
     0.000313),
    ("flash S 2048", lambda: costs.flash_attention(
        _t((1, 2048, 14, 64)), _t((1, 2048, 2, 64)), _t((1, 2048, 2, 64))),
     0.00760),
    ("flash S 3000 window 2048", lambda: costs.flash_attention(
        _t((1, 3000, 10, 256)), _t((1, 3000, 1, 256)),
        _t((1, 3000, 1, 256)), window=2048), 0.0419),
    ("flash whisper 1500^2 non-causal", lambda: costs.flash_attention(
        _t((1, 1500, 12, 64)), _t((1, 1500, 12, 64)), _t((1, 1500, 12, 64)),
        causal=False), 0.00699),
    ("flash phi-3 hd 96", lambda: costs.flash_attention(
        _t((1, 1224, 32, 96)), _t((1, 1224, 32, 96)), _t((1, 1224, 32, 96))),
     0.00931),
    ("decode whisper cross K/V", lambda: costs.decode_attention(
        _t((8, 12, 64)), _t((8, 1500, 12, 64)), _t((8, 1500, 12, 64)),
        lengths=_t((8,), torch.int32)), 0.01101),
    ("prox w_gate f32", lambda: costs.prox_update(
        _t((4, 24, 896, 4864), F32), _t((4, 24, 896, 4864), F32),
        _t((4, 24, 896, 4864), F32)), 2.498),
    ("prox w_gate bf16 x", lambda: costs.prox_update(
        _t((4, 24, 896, 4864)), _t((4, 24, 896, 4864), F32),
        _t((4, 24, 896, 4864), F32)), 1.998),
    ("prox embed f32", lambda: costs.prox_update(
        _t((4, 151936, 896), F32), _t((4, 151936, 896), F32),
        _t((4, 151936, 896), F32)), 3.251),
    ("wkv [1,32,200,64]", lambda: costs.rwkv6_scan(
        _t((1, 32, 200, 64)), _t((1, 32, 200, 64)), _t((1, 32, 200, 64)),
        _t((1, 32, 200, 64), F32), _t((32, 64)), _t((1, 32, 64, 64), F32)),
     0.00203),
    ("wkv [1,32,200,64] f32", lambda: costs.rwkv6_scan(
        *(_t((1, 32, 200, 64), F32),) * 4, _t((32, 64), F32),
        _t((1, 32, 64, 64), F32)), 0.00276),
    ("wkv decode [8,32,1,64]", lambda: costs.rwkv6_scan(
        *(_t((8, 32, 1, 64)),) * 3, _t((8, 32, 1, 64), F32), _t((32, 64)),
        _t((8, 32, 64, 64), F32)), 0.00257),
    ("wkv S 4096", lambda: costs.rwkv6_scan(
        *(_t((1, 32, 4096, 64)),) * 3, _t((1, 32, 4096, 64), F32),
        _t((32, 64)), _t((1, 32, 64, 64), F32)), 0.0354),
    ("wkv backward [2,32,256,64]", lambda: costs.rwkv6_scan_bwd(
        *(_t((2, 32, 256, 64)),) * 3, _t((2, 32, 256, 64), F32),
        _t((32, 64)), _t((2, 32, 64, 64), F32), _t((2, 32, 256, 64), F32)),
     0.01402),
    ("rg-lru [1,200,2560]", lambda: costs.rglru_scan(
        _t((1, 200, 2560)), _t((1, 200, 2560)), *(_t((2560,)),) * 3,
        _t((1, 200, 2560)), _t((1, 2560), F32)), 0.00123),
    ("rg-lru S 4096", lambda: costs.rglru_scan(
        _t((1, 4096, 2560)), _t((1, 4096, 2560)), *(_t((2560,)),) * 3,
        _t((1, 4096, 2560)), _t((1, 2560), F32)), 0.0251),
    ("rg-lru backward [2,256,2560]", lambda: costs.rglru_scan_bwd(
        _t((2, 256, 2560)), _t((2, 256, 2560)), *(_t((2560,)),) * 3,
        _t((2, 256, 2560)), _t((2, 2560), F32), _t((2, 256, 2560))),
     0.00785),
]


@pytest.mark.parametrize("label,cost_fn,bound_ms", PERF_BOUNDS,
                         ids=[c[0] for c in PERF_BOUNDS])
def test_cost_formula_reproduces_the_perf_bound(label, cost_fn, bound_ms):
    with FakeTensorMode():
        cost = cost_fn()
    got = RL.bound_seconds(cost) * 1e3
    assert got == pytest.approx(bound_ms, rel=0.01), (label, got)


def test_decode_costs_count_the_lengths_of_real_tensors():
    """Real lengths are read (rows past the capacity clamp to it); a fake
    tensor counts every row at the capacity."""
    q, k = torch.zeros(3, 4, 32), torch.zeros(3, 10, 2, 32)
    got = costs.decode_attention(q, k, k, lengths=_lengths([0, 4, 12]))
    assert got.flops == 4 * 32 * 4 * (0 + 4 + 10)
    assert got.bytes == 2 * 3 * 4 * 32 * 4 + 2 * 14 * 2 * 32 * 4 + 4 * 3
    with FakeTensorMode():
        fq, fk = torch.zeros(3, 4, 32), torch.zeros(3, 10, 2, 32)
        fake = costs.decode_attention(fq, fk, fk,
                                      lengths=_lengths([0, 4, 12]))
    assert fake.flops == 4 * 32 * 4 * 30
    pool = torch.zeros(9, 4, 2, 32)
    tables = torch.zeros(3, 2, dtype=torch.int32)
    paged = costs.decode_attention_paged(q, pool, pool, tables,
                                         lengths=_lengths([1, 5, 20]))
    assert paged.flops == 4 * 32 * 4 * (1 + 5 + 8)
    assert paged.bytes == (2 * 3 * 4 * 32 * 4 + 2 * 14 * 2 * 32 * 4
                           + 4 * (3 + 1 + 2 + 2))
    ring = costs.decode_attention_ring(q, pool, pool, tables,
                                       lengths=_lengths([1, 5, 20]),
                                       window=6)
    assert ring.flops == 4 * 32 * 4 * (1 + 5 + 6)


def test_attended_pairs_equal_a_brute_force_count():
    for s, t, causal, window in [(7, 7, True, 0), (7, 7, True, 3),
                                 (5, 9, False, 0), (9, 5, True, 0),
                                 (9, 5, True, 2), (6, 6, False, 2)]:
        i = np.arange(s)[:, None]
        j = np.arange(t)[None]
        keep = np.ones((s, t), bool)
        if causal:
            keep &= j <= i
        if window:
            keep &= j > i - window
        assert costs.attended_pairs(s, t, causal, window) == keep.sum()


# ---------------------------------------------------------------------------
# closed forms of one layer
# ---------------------------------------------------------------------------


def test_one_qwen2_decoder_layer_counts_its_closed_form():
    """One full-width qwen2 layer in prefill mode, bf16, B = 1, S = 128:
    q, k, v, o and the three MLP products move operands and results and
    do 2 M N K each, the flash kernel 4 H hd (attended pairs) and its
    q, k, v and output, the cache write its K and V twice; norms, rope
    and the biases move nothing."""
    cfg = get_config("qwen2-0.5b")
    b, s, d = 1, 128, cfg.d_model
    h, kv, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    m, e = b * s, 2                        # rows, bytes an element
    with FakeTensorMode():
        params = TF._cast(cfg, param_specs(cfg))
        lp = TF._layers(params, 0, cfg.num_layers)[0]
        x = torch.empty((b, s, d), dtype=BF)
        pos = torch.arange(s)[None]
        seg = TF.init_cache(cfg, b, s)[0]
        with RL.StepCost() as cost:
            TF._attn_block(cfg, lp, x, pos, "prefill", seg, 0, None, 0)
    products = [(m, d, h * hd), (m, d, kv * hd), (m, d, kv * hd),
                (m, h * hd, d), (m, d, f), (m, d, f), (m, f, d)]
    pairs = s * (s + 1) // 2
    flops = (sum(2 * i * j * k for i, j, k in products)
             + 4 * b * h * hd * pairs)
    nbytes = (sum((i * j + j * k + i * k) * e for i, j, k in products)
              + (2 * m * h * hd + 2 * m * kv * hd) * e          # flash
              + 2 * 2 * m * kv * hd * e)                        # cache
    assert cost.flops == flops
    assert cost.bytes == nbytes
    assert cost.by_kernel() == {"flash_attention": {
        "calls": 1, "flops": 4 * b * h * hd * pairs,
        "bytes": (2 * m * h * hd + 2 * m * kv * hd) * e}}


def test_one_moe_layer_counts_its_closed_form():
    """dbrx's smoke MoE layer on x [2, 16, D] bf16: the router product;
    the bucket places' gather (int64), the slot scatter (int64), the
    dispatch gather of G cap rows an expert, the three expert products
    over E, the combine gather of k rows a token."""
    cfg = get_smoke("dbrx-132b")
    b, s, d = 2, 16, cfg.d_model
    mo = cfg.moe
    ex, k, f = mo.num_experts, mo.top_k, mo.d_ff_expert
    t = b * s
    cap = max(math.ceil(s * k / ex * mo.capacity_factor), 4)
    rows = ex * b * cap
    e = 2
    with FakeTensorMode():
        params = TF._cast(cfg, param_specs(cfg))
        lp = TF._layers(params, 0, cfg.num_layers)[0]
        x = torch.empty((b, s, d), dtype=BF)
        with RL.StepCost() as cost:
            MOE.moe_apply(lp["moe"], cfg, x, with_aux=False)
    gc = b * cap
    flops = 2 * t * d * ex + 2 * 2 * ex * gc * d * f + 2 * ex * gc * f * d
    nbytes = ((t * d + d * ex + t * ex) * e                   # router
              + 2 * t * k * 8                                 # places
              + 2 * t * k * 8                                 # slot scatter
              + 2 * rows * d * e                              # dispatch
              + 2 * (ex * gc * d + ex * d * f + ex * gc * f) * e
              + (ex * gc * f + ex * f * d + ex * gc * d) * e
              + 2 * t * k * d * e)                            # combine
    assert cost.flops == flops
    assert cost.bytes == nbytes
    assert not cost.kernels


# ---------------------------------------------------------------------------
# the same step counts the same on the CPU and on fake tensors
# ---------------------------------------------------------------------------

FAMILIES = ["qwen2-0.5b", "rwkv6-1.6b", "recurrentgemma-2b", "dbrx-132b",
            "deepseek-v2-236b", "whisper-small", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_step_counts_equal_on_cpu_and_fake(arch, kind):
    """The smoke config's step, f32 parameters and bf16 compute, on real
    CPU tensors (the plain versions run, paused) and on fake tensors (no
    plain version runs): equal FLOPs by unit and equal bytes; the dry
    run's count (a superstep: one agent's gradient A times) equals
    both."""
    cfg = get_smoke(arch)
    shape = ShapeConfig(f"smoke_{kind}", 24 + cfg.num_patches, 2, kind)
    combo = dryrun.make_combo(cfg, shape, train=TrainConfig(
        num_agents=2, num_walks=1, tau=0.05, rho=20.0))
    inputs = dryrun.step_inputs(combo, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    with RL.StepCost() as real:
        dryrun.run_step(combo, inputs)
    with FakeTensorMode():
        with RL.StepCost() as fake:
            dryrun.run_step(combo, dryrun.step_inputs(combo))
        counted, _ = dryrun.count_step(combo, dryrun.step_inputs(combo))
    assert real.flops > 0 and real.bytes > 0
    assert fake.ops_by_unit() == real.ops_by_unit()
    assert fake.bytes == real.bytes
    assert fake.by_kernel() == real.by_kernel()
    assert (counted.flops, counted.bytes) == (real.flops, real.bytes)
    # every kernel of the step was recorded
    if kind != "train" and arch not in ("deepseek-v2-236b",):
        assert real.kernels


def test_no_plain_version_runs_on_fake_tensors(monkeypatch):
    """On fake tensors `ops` returns shapes: the plain versions are not
    called (they would raise here)."""
    from repro_torch.kernels import ops, ref

    def boom(*a, **k):
        raise AssertionError("plain version ran on fake tensors")

    for name in ("attention", "decode_attention", "rwkv6", "rglru_gated",
                 "prox_update", "rwkv6_bwd", "rglru_gated_bwd"):
        monkeypatch.setattr(ref, name, boom)
    with FakeTensorMode():
        q, kv = _t((1, 8, 4, 32)), _t((1, 8, 2, 32))
        assert ops.flash_attention(q, kv, kv).shape == q.shape
        d = ops.decode_attention(q[:, 0], kv, kv,
                                 lengths=torch.ones(1, dtype=torch.int32))
        assert d.shape == (1, 4, 32)
        r = _t((1, 4, 8, 32))
        state = _t((1, 4, 32, 32), F32)
        out, st = ops.rwkv6_scan(r, r, r, r.float(), _t((4, 32)), state)
        assert out.shape == r.shape and out.dtype == F32 and st is state
        xa = _t((1, 8, 16))
        w = _t((16,))
        out, _ = ops.rglru_scan(xa, xa, w, w, w, xa, _t((1, 16), F32))
        assert out.shape == xa.shape and out.dtype == BF
        x = _t((4, 4), F32)
        xn, delta = ops.prox_update(x, x, x, tau=0.1, rho=20.0, num_walks=2,
                                    num_agents=4)
        assert xn.shape == x.shape and delta.dtype == F32
        leaves = [t.requires_grad_() for t in (r.clone(), r.clone(),
                                               r.clone(), r.float(),
                                               _t((4, 32)))]
        out = ops.rwkv6_scan_train(*leaves)
        grads = torch.autograd.grad(out.sum(), leaves)
        assert [g.shape for g in grads] == [t.shape for t in leaves]


def test_counting_pauses_the_plain_version():
    """On real CPU tensors the plain attention runs (full S x S scores),
    yet the count is the kernel's formula and nothing else."""
    q, kv = torch.randn(1, 64, 4, 32), torch.randn(1, 64, 2, 32)
    from repro_torch.kernels import ops
    with RL.StepCost() as cost:
        ops.flash_attention(q, kv, kv)
    want = costs.flash_attention(q, kv, kv)
    assert (cost.flops, cost.bytes) == (want.flops, want.bytes)
    assert costs.OPEN is None


def test_one_count_at_a_time():
    with RL.StepCost():
        with pytest.raises(RuntimeError, match="already open"):
            RL.StepCost().__enter__()
    assert costs.OPEN is None


def test_roofline_terms_and_peaks():
    rl = RL.Roofline({"bf16": 989e12, "f32": 67e12}, 3.35e12)
    assert rl.compute_s == pytest.approx(2.0)
    assert rl.memory_s == pytest.approx(1.0)
    assert rl.dominant == "compute" and rl.chips == 1
    assert rl.collective_bytes == 0 and rl.collective_s == 0
    d = rl.as_dict()
    for key in ("flops", "hbm_bytes", "collective_bytes", "chips",
                "compute_s", "memory_s", "collective_s", "dominant"):
        assert key in d
    assert RL.peak_flops("bfloat16") == 989e12
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        assert RL.peak_flops(torch.float32) == 67e12
        torch.backends.cuda.matmul.allow_tf32 = True
        assert RL.peak_flops(torch.float32) == 495e12
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert RL.mfu(989e12, 2.0, "bfloat16") == pytest.approx(0.5)
