"""GQA attention: the training path and the serving half (prefill into a
KV cache, one-token decode against it), as in `repro/models/attention.py`.

Training attention stays plain PyTorch (`chunked_attention`), as the
reference computes it outside any Pallas kernel, so autograd can run
through it; it is the flash kernel's plain version (`kernels.ref.
attention`) in the model's layout. It keeps the reference's numerics:
f32 logits from the compute-dtype q and k, masked logits at -1e30, and
the output as acc / max(l, 1e-30) cast to v's dtype. At the trainer's
lengths one chunk
of the reference's online softmax covers the whole sequence, so one
masked softmax computes the same function.

Serving goes through the kernels (`kernels.ops`): prefill attention
through `flash_attention` and decode attention through
`decode_attention`, which on the card are the hand-written CUDA kernels
and on the CPU their plain versions. The reference computes both with
jnp here (its `use_pallas` switch does not exist), so the port's serving
path is held against those jnp paths. The KV cache is a ring of capacity
T per row; the port writes it in place where the reference returns new
buffers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import _he, apply_rope


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
    """Masked softmax attention, the reference's one-chunk case: the
    kernels' plain version `ref.attention` in the [B, S, KV, G, hd]
    layout.

    q: [B, S, KV, G, hd]; k, v: [B, T, KV, hd]. window > 0 limits each
    query to the last `window` positions (inclusive). Returns
    [B, S, KV, G, hd] in v's dtype.
    """
    b, s, kv, g, hd = q.shape
    out = ref.attention(q.reshape(b, s, kv * g, hd), k, v, causal=causal,
                        window=window)
    return out.reshape(q.shape).to(v.dtype)


def gqa_prefill(params, cfg, x, positions, *, kernel=False):
    """Full prefill/training attention. Returns ([B,S,D], (k, v)), k and v
    [B,S,KV,hd] for the cache.

    kernel=False (training) computes the autograd-able `chunked_attention`;
    kernel=True (serving prefill) goes through `ops.flash_attention`,
    which has no backward, as the TPU kernel has none."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(params, cfg, x, positions)
    if kernel:
        out = ops.flash_attention(q.reshape(b, s, h, hd), k, v, causal=True,
                                  window=cfg.attn_window)
    else:
        out = chunked_attention(q, k, v, causal=True, window=cfg.attn_window)
    out = out.reshape(b, s, h * hd)
    return out @ params["wo"], (k, v)


# ---------------------------------------------------------------------------
# decode attention (one new token vs KV cache)
# ---------------------------------------------------------------------------


def ring_insert(buf, entry, ptr):
    """Write entry [B,...] into buf [B,T,...] at slot ptr % T, in place.

    ptr is the running token count, so slot i % T always holds token i
    and ring eviction drops the oldest cached token. ptr is a 0-dim
    tensor (every row at the same depth) or int [B] (slot-arena decode:
    each row at its own depth). Returns buf.
    """
    slot = (ptr % buf.shape[1]).long()
    if slot.dim() == 0:
        buf.index_copy_(1, slot.reshape(1), entry[:, None].to(buf.dtype))
    else:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, slot] = entry.to(buf.dtype)
    return buf


def prefill_cache_entries(seq_entries, capacity, s):
    """Store the last `capacity` of s prefill entries [B,s,...] so that
    slot i % T holds token i (consistent ring eviction in later decode).
    Pads with zeros when the prompt is shorter than the capacity (slots
    >= s are masked by the decode validity length until written)."""
    t = capacity
    if s < t:
        pad = seq_entries.new_zeros(
            (seq_entries.shape[0], t - s) + tuple(seq_entries.shape[2:]))
        return torch.cat([seq_entries, pad], dim=1)
    kept = seq_entries[:, -t:]
    if s > t:
        kept = torch.roll(kept, shifts=s % t, dims=1)
    return kept


def gqa_decode(params, cfg, x, cache, position):
    """x: [B,1,D]; cache: {k, v: [B,T,KV,hd], ptr} (ptr = tokens written,
    0-dim or per row [B]); position: [B,1] absolute positions.

    Inserts the new token's K/V first, then attends over the valid slots
    min(ptr + 1, T) of each row (so the token attends to itself), through
    `ops.decode_attention`. Updates the cache in place (K/V insert, ptr
    + 1) and returns ([B,1,D], cache). q is cast to the cache's dtype for
    the kernel, which takes one dtype. A windowed config's cache is a
    ring of capacity window, so no mask beyond `lengths` is needed."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k_new, v_new = _project_qkv(params, cfg, x, position)
    t = cache["k"].shape[1]
    ring_insert(cache["k"], k_new[:, 0], cache["ptr"])
    ring_insert(cache["v"], v_new[:, 0], cache["ptr"])
    lengths = torch.clamp(cache["ptr"] + 1, max=t).to(torch.int32)
    lengths = lengths.expand(b).contiguous()
    out = ops.decode_attention(q[:, 0].reshape(b, h, hd).to(cache["k"].dtype),
                               cache["k"], cache["v"], lengths=lengths)
    cache["ptr"].add_(1)
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return out @ params["wo"], cache
