"""Shared building blocks: norms, RoPE, MLPs, embeddings.

Plain functions over dicts of tensors, as in `repro/models/layers.py`, so
that one agent's parameters are just a dict the trainer can slice from
its stacked state. Init functions take a `torch.Generator` and create on
its device.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

# what draws each leaf the inits draw from a generator (`keeping`), or
# None; a context variable, so each thread (a test's thread ranks) has
# its own
_KEEP = contextvars.ContextVar("keep", default=None)


@contextlib.contextmanager
def keeping(fn):
    """Within the block, every leaf the inits draw from a generator (`_he`,
    `embedding_init`) is fn(draw, shape, dtype) in place of draw(), in
    the order of the draws: `dist.tensor_parallel.init_shard` takes the
    leaves' shapes without drawing them, then keeps a rank's piece of
    each draw, so the whole leaf is freed before the next is drawn."""
    token = _KEEP.set(fn)
    try:
        yield
    finally:
        _KEEP.reset(token)


def _drawn(draw, shape, dtype):
    fn = _KEEP.get()
    return draw() if fn is None else fn(draw, tuple(shape), dtype)


def _he(generator, shape, dtype, fan_in):
    # scaled in place: a large leaf (dbrx's [L, 16, 6144, 10752] experts)
    # holds one f32 draw beside its cast, not two
    return _drawn(lambda: torch.randn(shape, generator=generator,
                                      device=generator.device).div_(
                                          math.sqrt(fan_in)).to(dtype),
                  shape, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(shape, dtype, device):
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def layernorm_init(shape, dtype, device):
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-5):
    """In f32 with the biased variance (`jnp.var`'s), as the reference."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(dt)


def make_norm(norm_type):
    """(init, apply) of "rmsnorm" or "layernorm"."""
    if norm_type == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if norm_type == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(norm_type)


# ---------------------------------------------------------------------------
# rotary position embeddings (split halves, f32 angles)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim, theta, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=1e4):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # [hd/2]
    angles = positions[..., None].float() * freqs              # [..., s, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                   # [..., s, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs (swiglu; gelu and sq_relu: one up projection)
# ---------------------------------------------------------------------------


def mlp_init(generator, lead, d_model, d_ff, dtype, mlp_type="swiglu"):
    """MLP weights with leading dims `lead` (the stacked layer axis):
    swiglu's w_gate, w_up, w_down, or gelu's and sq_relu's w_up, w_down."""
    if mlp_type not in ("swiglu", "gelu", "sq_relu"):
        raise ValueError(f"mlp_type {mlp_type!r} is not ported")
    p = {}
    if mlp_type == "swiglu":
        p["w_gate"] = _he(generator, lead + (d_model, d_ff), dtype, d_model)
    p["w_up"] = _he(generator, lead + (d_model, d_ff), dtype, d_model)
    p["w_down"] = _he(generator, lead + (d_ff, d_model), dtype, d_ff)
    return p


def mlp_hidden(params, x, mlp_type):
    """The MLP's activations before its down projection: swiglu, gelu in
    its tanh form (`jax.nn.gelu`'s default), or squared ReLU."""
    if mlp_type == "swiglu":
        return F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    if mlp_type == "gelu":
        return F.gelu(x @ params["w_up"], approximate="tanh")
    if mlp_type == "sq_relu":
        return torch.square(F.relu(x @ params["w_up"]))
    raise ValueError(f"mlp_type {mlp_type!r} is not ported")


def mlp_apply(params, x, mlp_type):
    """swiglu, gelu in its tanh form (`jax.nn.gelu`'s default), or squared
    ReLU."""
    return mlp_hidden(params, x, mlp_type) @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embedding_init(generator, vocab, d_model, dtype):
    return {"table": _drawn(lambda: (torch.randn(
        (vocab, d_model), generator=generator, device=generator.device)
        * 0.02).to(dtype), (vocab, d_model), dtype)}


def embed(params, tokens):
    return F.embedding(tokens, params["table"])


def unembed(params, x):
    return x @ params["table"].T
