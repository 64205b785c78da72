"""GQA attention for training (the `repro/models/attention.py` train path).

Attention stays plain PyTorch, as the reference computes it outside any
Pallas kernel. It keeps the reference's numerics: f32 logits from the
compute-dtype q and k, masked logits at -1e30, and the output as
acc / max(l, 1e-30) cast to v's dtype. At the trainer's lengths one chunk
of the reference's online softmax covers the whole sequence, so one
masked softmax computes the same function.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import _he, apply_rope

_NEG_INF = -1e30


def gqa_init(generator, lead, cfg, dtype):
    """Projection weights with leading dims `lead` (the stacked layer axis)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": _he(generator, lead + (d, h * hd), dtype, d),
        "wk": _he(generator, lead + (d, kv * hd), dtype, d),
        "wv": _he(generator, lead + (d, kv * hd), dtype, d),
        "wo": _he(generator, lead + (h * hd, d), dtype, h * hd),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros(lead + (h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (kv * hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params, cfg, x, positions):
    """x [B,S,D] -> q [B,S,KV,G,hd], k/v [B,S,KV,hd] with rope applied."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kv, hd), positions, cfg.rope_theta)
    return q.reshape(b, s, kv, h // kv, hd), k, v.reshape(b, s, kv, hd)


def chunked_attention(q, k, v, *, causal=True, window=0):
    """Masked softmax attention, the reference's one-chunk case.

    q: [B, S, KV, G, hd]; k, v: [B, T, KV, hd]. window > 0 limits each
    query to the last `window` positions (inclusive). Returns
    [B, S, KV, G, hd] in v's dtype.
    """
    s, t, hd = q.shape[1], k.shape[1], q.shape[-1]
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(),
                          k.float()) * float(1.0 / math.sqrt(hd))
    q_idx = torch.arange(s, device=q.device)[:, None]
    kv_idx = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_idx <= q_idx
    if window > 0:
        mask &= kv_idx > q_idx - window
    logits = torch.where(mask, logits, _NEG_INF)
    # the row max only shifts the exponent; its gradient is zero
    m = logits.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(logits - m)
    acc = torch.einsum("bkgst,btkd->bkgsd", p, v.float())
    out = acc / torch.clamp_min(p.sum(dim=-1), 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)


def gqa_prefill(params, cfg, x, positions):
    """Full training attention (sliding if cfg.attn_window > 0): [B,S,D]."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = chunked_attention(q, k, v, causal=True, window=cfg.attn_window)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"]
