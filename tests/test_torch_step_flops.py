"""A step's product FLOPs in the port (`utils.roofline.StepCost`'s aten
count) against the reference's own counter (`repro.utils.hlo_flops.
analyze` over the compiled HLO of the same step), on the CPU.

For every architecture's smoke config, a superstep and a prefill are
counted on both sides at the same shapes. The port's aten count leaves
out its kernels' records (`kernels.costs`), so where the reference does a
kernel's work with products, or the two do the same work differently,
the reference's count is the port's plus a difference by design, which
`_by_design` writes out:

  * prefill attention: the reference's plain chunked attention multiplies
    over the whole S x T rectangle; the port sends each GQA layer to the
    flash kernel, whose record counts the causal triangle;
  * the WKV recurrence: the reference's scan does r . S as a product at
    every step; the port's recurrence is the WKV kernel;
  * MoE: the reference dispatches and combines through GShard's one-hot
    einsums; the port moves tokens by index;
  * whisper's training: the port checkpoints each encoder and decoder
    layer, the reference's encdec does not; with remat=False the counts
    are equal.

The prox update does no product on either side. The reference is
imported inside a fixture, so that the file collects without JAX.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_smoke  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.utils import roofline as RL  # noqa: E402

TRAIN = dict(num_agents=2, num_walks=1, tau=0.05, rho=20.0)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import configs as RC
    from repro.dist.trainer import init_train_state, make_train_step
    from repro.models import build_model
    from repro.models import model as RM
    from repro.utils.hlo_flops import analyze

    def hlo_flops(arch, shape):
        """analyze()'s FLOPs of the reference's jitted step at `shape`."""
        cfg = RC.get_smoke(arch)
        model = build_model(cfg)
        batch = RM.input_specs(cfg, RC.base.ShapeConfig(
            shape.name, shape.seq_len, shape.global_batch, shape.kind))
        if shape.kind == "train":
            tcfg = RC.base.TrainConfig(**TRAIN)
            a = tcfg.num_agents
            batch = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                (a, s.shape[0] // a) + s.shape[1:], s.dtype), batch)
            lowered = jax.jit(make_train_step(model, tcfg)).lower(
                init_train_state(model, tcfg), batch,
                jax.ShapeDtypeStruct((), jnp.int32))
        else:
            params = jax.eval_shape(model.init,
                                    jax.ShapeDtypeStruct((2,), jnp.uint32))
            lowered = jax.jit(model.prefill).lower(params, batch)
        return analyze(lowered.compile().as_text())["flops"]

    return hlo_flops


def _shape(cfg, kind):
    return ShapeConfig(f"smoke_{kind}", 24 + cfg.num_patches, 2, kind)


def _aten_flops(arch, kind, remat=None):
    """The port's aten product FLOPs of the whole step on fake tensors
    (remat: the encdec train_loss's, where it is given)."""
    cfg = get_smoke(arch)
    combo = dryrun.make_combo(cfg, _shape(cfg, kind),
                              train=TrainConfig(**TRAIN))
    model = combo.model
    if remat is not None:
        model = dataclasses.replace(model, train_loss=functools.partial(
            model.train_loss, remat=remat))
    with FakeTensorMode():
        inputs = dryrun.step_inputs(combo)
        with RL.StepCost() as cost:
            dryrun.run_step(combo, inputs, model=model)
    return sum(cost.flops_by_unit.values())


def _by_design(cfg, shape):
    """The reference's HLO product FLOPs less the port's aten FLOPs, for
    the reasons the module's docstring lists."""
    b, s, kind = shape.global_batch, shape.seq_len, shape.kind
    h, hd = cfg.num_heads, cfg.head_dim
    diff = 0
    if kind == "prefill" and cfg.mla is None:
        # QK^T and PV over the rectangle, 2 * S * T * hd FLOPs a head each
        gqa = sum(t in ("attn", "moe") for t in cfg.layer_types)
        if cfg.family == "audio":
            t = cfg.encoder_seq
            diff += 4 * b * h * hd * (gqa * (s * s + s * t)       # self, cross
                                      + cfg.encoder_layers * t * t)
        else:
            diff += 4 * b * h * hd * s * s * gqa
    if cfg.family == "ssm":
        # r . S, [hd] x [hd, hd], at every token and head of every layer:
        # once forward; backward's dr and dS twice more
        hr = cfg.rwkv_head_dim
        per_pass = 2 * b * s * (cfg.d_model // hr) * hr * hr * cfg.num_layers
        diff += per_pass * (3 if kind == "train" else 1)
    if cfg.moe is not None:
        m = cfg.moe
        e, k, d = m.num_experts, m.top_k, cfg.d_model
        c = max(math.ceil(s * k / e * m.capacity_factor), 4)
        einsum = 2 * b * s * e * c * d        # "gsec,gsd->gecd" and back
        if kind == "prefill":
            per_layer = 2 * einsum             # dispatch, combine
        else:
            # forward dispatch and combine; backward: dx of the dispatch,
            # dy and d(combine) of the combine; remat's recomputed
            # dispatch (the recomputed combine is dead); and the backward
            # of the combine weights' outer product, which contracts E
            per_layer = 6 * einsum + 2 * b * s * k * e * c
        diff += per_layer * sum(t == "moe" for t in cfg.layer_types)
    return diff


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_aten_flops_equal_the_reference_hlo_count(jx, arch, kind):
    cfg = get_smoke(arch)
    shape = _shape(cfg, kind)
    remat = False if cfg.family == "audio" and kind == "train" else None
    port = _aten_flops(arch, kind, remat=remat)
    assert port > 0
    assert jx(arch, shape) == port + _by_design(cfg, shape)


def test_encdec_remat_recounts_the_layers():
    """whisper's training with each layer checkpointed counts more than
    without: the recomputed forward of its layers."""
    assert (_aten_flops("whisper-small", "train", remat=True)
            > _aten_flops("whisper-small", "train", remat=False))
