"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix.

A port of `repro/models/rwkv6.py` (arXiv:2404.05892 at block level):

  * token-shift interpolation (static mix ratios mu_*),
  * data-dependent per-channel decay w_t = exp(-exp(w0 + LoRA(x_t))),
  * per-head WKV state recurrence with bonus term u:
        out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
        S_t   = diag(w_t) S_{t-1} + k_t^T v_t
  * grouped (per-head) normalization, silu(g) output gate,
  * channel-mix: sigma(r') * (relu(k')^2 W_v).

The reference runs the recurrence as a `lax.scan` over time, or through
its chunked closed form `wkv_chunked` when S % 64 == 0 and S > 64; the
port has one recurrence for every S, `kernels.ops.rwkv6_scan` (the CUDA
kernel on the card), and where the reference would take the chunked form
it rounds the WKV output to the compute dtype as that form does. With no
state (training, as the reference's train mode starts from
`init_state`'s zeros) the blocks take `ops.rwkv6_scan_train`, whose
backward is the WKV backward kernel, and return no state. The
mixing parameters are one flat dict: "mu.r", ..., "cm_mu.k" for the
reference's nested mix ratios.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _he

DECAY_LORA = 64
# the reference's wkv_chunked chunk: S % CHUNK == 0 and S > CHUNK take it
CHUNK = 64
MIX = ("r", "k", "v", "g", "w")
LEAVES = ("shift", "wkv", "cm_shift")     # the recurrent state
CM_MIX = ("r", "k")


def rwkv_init(generator, lead, cfg, dtype):
    """Mixing parameters with leading dims `lead` (the stacked layer axis),
    with the reference's shapes and scales."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    h = d // hd
    dev = generator.device

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    def normal(shape, scale):
        return (torch.randn(lead + shape, generator=generator, device=dev)
                * scale).to(dtype)

    params = {f"mu.{n}": full((d,), 0.5) for n in MIX}
    params.update({
        "wr": _he(generator, lead + (d, d), dtype, d),
        "wk": _he(generator, lead + (d, d), dtype, d),
        "wv": _he(generator, lead + (d, d), dtype, d),
        "wg": _he(generator, lead + (d, d), dtype, d),
        "w0": full((d,), -2.0),           # base decay ~exp(-exp(-2))
        "w_lora_a": _he(generator, lead + (d, DECAY_LORA), dtype, d),
        "w_lora_b": normal((DECAY_LORA, d), 0.01),
        "u": normal((h, hd), 0.1),
        "ln_out_scale": full((d,), 1.0),
        "wo": _he(generator, lead + (d, d), dtype, d),
    })
    params.update({f"cm_mu.{n}": full((d,), 0.5) for n in CM_MIX})
    params.update({
        "cm_wr": _he(generator, lead + (d, d), dtype, d),
        "cm_wk": _he(generator, lead + (d, cfg.d_ff), dtype, d),
        "cm_wv": _he(generator, lead + (cfg.d_ff, d), dtype, cfg.d_ff),
    })
    return params


def init_state(cfg, batch, lead=(), device=None, parts=1):
    """Zero recurrent state in f32: {"shift", "cm_shift": [*lead, B, D],
    "wkv": [*lead, B, H / parts, hd, hd]} (parts: a model axis's size,
    whose rank holds its heads' WKV state and the whole shifts)."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    f32 = torch.float32
    return {"shift": torch.zeros(lead + (batch, d), dtype=f32, device=device),
            "wkv": torch.zeros(lead + (batch, d // hd // parts, hd, hd),
                               dtype=f32, device=device),
            "cm_shift": torch.zeros(lead + (batch, d), dtype=f32,
                                    device=device)}


def _token_shift(x, prev, mu):
    """lerp between shifted and current: x + (shifted - x) * mu (the
    difference, the same for every mix, is taken once). prev None: zeros
    (training)."""
    first = (x.new_zeros(x[:, :1].shape) if prev is None
             else prev.to(x.dtype)[:, None, :])
    shifted = torch.cat([first, x[:, :-1, :]], dim=1)
    diff = shifted - x
    return {n: x + diff * m for n, m in mu.items()}


def _rows(axis, h, w):
    """h @ w of a row-parallel leaf (`wo`, `cm_wv`): on a model axis the
    sum of the ranks' partial products, rounded once (`ModelAxis.
    row_sum`)."""
    return h @ w if axis is None else axis.row_sum(h, w)


def time_mix(params, cfg, x, state, axis=None):
    """x: [B,S,D]; state: {"shift", "wkv", ...} of `init_state`'s leaves
    at batch B -> (out [B,S,D], new state). The WKV state advances in
    place (`state["wkv"]` is overwritten and returned); the new "shift"
    is x's last position. state None (training): from zeros, through the
    differentiable `ops.rwkv6_scan_train`, returning (out, None).

    axis: a `dist.tensor_parallel.ModelAxis` whose rank holds its heads
    (`u` [H_r, hd] gives their count; r, k, v, g and the decay by
    columns): the rank's heads run the WKV recurrence and the group
    norm, and `wo`'s partial products are summed over the axis."""
    b, s, _ = x.shape
    hd = cfg.rwkv_head_dim
    h = params["u"].shape[0]
    d = h * hd

    train = state is None
    xs = _token_shift(x, None if train else state["shift"],
                      {n: params[f"mu.{n}"] for n in MIX})
    r = (xs["r"] @ params["wr"]).reshape(b, s, h, hd)
    k = (xs["k"] @ params["wk"]).reshape(b, s, h, hd)
    v = (xs["v"] @ params["wv"]).reshape(b, s, h, hd)
    g = F.silu(xs["g"] @ params["wg"])

    # data-dependent decay (the Finch mechanism)
    w = params["w0"] + torch.tanh(
        xs["w"] @ params["w_lora_a"]) @ params["w_lora_b"]
    w = torch.exp(-torch.exp(w.float())).reshape(b, s, h, hd)   # in (0,1)

    rkvw = (r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            w.transpose(1, 2))
    if train:
        out = ops.rwkv6_scan_train(*rkvw, params["u"])
    else:
        out, wkv = ops.rwkv6_scan(*rkvw, params["u"], state["wkv"])
    if s % CHUNK == 0 and s > CHUNK:
        # the reference's chunked form returns its output in r's dtype
        out = out.to(r.dtype).float()
    out = out.transpose(1, 2)                                 # [B,S,H,hd]

    # per-head group norm (population variance, as jnp.var)
    mu_o = out.mean(-1, keepdim=True)
    var_o = out.var(-1, keepdim=True, unbiased=False)
    out = (out - mu_o) * torch.rsqrt(var_o + 1e-5)
    out = out.reshape(b, s, d) * params["ln_out_scale"].float()

    out = _rows(axis, out.to(x.dtype) * g, params["wo"])
    if train:
        return out, None
    return out, dict(state, shift=x[:, -1, :], wkv=wkv)


def channel_mix(params, cfg, x, state, axis=None):
    """x: [B,S,D] -> (out, new state with "cm_shift" x's last position);
    state None (training): from a zero shift, returning (out, None).
    axis: a model axis whose rank holds its columns of d_ff (`cm_wk`)
    and their rows of `cm_wv`: the v product is summed over the axis and
    rounded once before the whole gate `r` multiplies it, as one process
    rounds `k @ cm_wv` before it."""
    xs = _token_shift(x, None if state is None else state["cm_shift"],
                      {n: params[f"cm_mu.{n}"] for n in CM_MIX})
    r = torch.sigmoid(xs["r"] @ params["cm_wr"])
    k = torch.square(torch.relu(xs["k"] @ params["cm_wk"]))
    out = r * _rows(axis, k, params["cm_wv"])
    if state is None:
        return out, None
    return out, dict(state, cm_shift=x[:, -1, :])
