"""GQA and MLA attention: the training path and the serving half (prefill
into a cache, one-token decode against it), as in
`repro/models/attention.py`.

Training attention stays plain PyTorch (`chunked_attention`), as the
reference computes it outside any Pallas kernel, so autograd can run
through it. It is the reference's online softmax over K/V chunks of
1024 with its numerics: f32 logits from the compute-dtype q and k,
masked logits at -1e30, an f32 running max, sum and accumulator, and the
output as acc / max(l, 1e-30) cast to v's dtype; each block of 1024
queries runs under `torch.utils.checkpoint`, so that backward recomputes
its chunk loop instead of keeping every chunk's probabilities.

Serving goes through the kernels (`kernels.ops`): prefill attention
through `flash_attention` and decode attention through
`decode_attention`, which on the card are the hand-written CUDA kernels
and on the CPU their plain versions. The reference computes both with
jnp here (its `use_pallas` switch does not exist), so the port's serving
path is held against those jnp paths. The KV cache is a ring of capacity
T per row; the port writes it in place where the reference returns new
buffers. The paged pool's decode goes through `decode_attention_paged`
(`decode_attention_ring` for a window), the paged and ring kernels on
the card; its chunk prefill attends with plain PyTorch, as the
reference does with jnp.

The encoder-decoder's attention (`bidir_attention`, `cross_kv`,
`cross_attention`, `cross_decode`) has the same two routes: training
through `chunked_attention` with causal=False, serving through
`flash_attention` with causal=False (the encoder over its frames, the
decoder's prefill over the encoder's K/V) and `decode_attention` over the
cached cross K/V (every row valid).

MLA (DeepSeek-V2's latent attention, the `mla_*` functions) caches the
latents {ckv, kpe} in place of K/V, on the arena and the pool alike. Its
cores are plain PyTorch on every device, as the reference computes them
with jnp outside any Pallas kernel: the prefill expands K/V (hd_qk 192,
hd_v 128 at full width) into `chunked_attention`, and the decode attends
in the latent space in f32.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (_he, apply_rope, layernorm, rmsnorm,
                                       rmsnorm_init)


def gqa_init(generator, lead, cfg, dtype):
    """Projection weights with leading dims `lead` (the stacked layer axis);
    with qk_norm, unit rmsnorm scales over hd for q and k ("q_norm.scale",
    "k_norm.scale")."""
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
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[f"{name}.scale"] = rmsnorm_init(lead + (hd,), dtype,
                                              generator.device)["scale"]
    return p


def _qk_norm(params, cfg, q, k, norm=rmsnorm):
    """qk-norm (rmsnorm over hd, or `norm`) of q [..., H, hd] and k [...,
    KV, hd], as the reference applies it after the reshape and before
    rope; q and k unchanged without it."""
    if not cfg.qk_norm:
        return q, k
    return (norm({"scale": params["q_norm.scale"]}, q),
            norm({"scale": params["k_norm.scale"]}, k))


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
    q, k = _qk_norm(params, cfg, q.reshape(b, s, h, hd),
                    k.reshape(b, s, kv, hd))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(b, s, kv, h // kv, hd), k, v.reshape(b, s, kv, hd)


def chunked_attention(q, k, v, *, causal=True, window=0, q_chunk=1024,
                      kv_chunk=1024, q_offset=0):
    """Online-softmax attention with O(chunk^2) activation memory, as the
    reference's `chunked_attention`.

    q: [B, S, KV, G, hd]; k, v: [B, T, KV, hd]. window > 0 limits each
    query to the last `window` positions (inclusive). q_offset: the
    absolute position of q[:, 0]. Returns [B, S, KV, G, hd] in v's dtype.

    K/V run in chunks of `kv_chunk` (the last one cut short, where the
    reference pads and masks it), queries in blocks of `q_chunk`, each
    block under non-reentrant `torch.utils.checkpoint` where q, k or v
    needs a gradient (the checkpoint's first call imports torch._dynamo,
    seconds a process, which serving's MLA prefill does not need). K and
    V are never repeated over the G query heads of their kv head.
    """
    b, s, kvh, g, hd = q.shape
    t = k.shape[1]
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    scale = float(1.0 / math.sqrt(hd))
    qh = q.float().permute(0, 2, 3, 1, 4)                   # [b,kv,g,s,hd]
    kh = k.float().permute(0, 2, 3, 1)                      # [b,kv,hd,t]
    vh = v.float().permute(0, 2, 1, 3)                      # [b,kv,t,hd_v]

    def q_block(q0, qblk, kh, vh):
        qc = qblk.shape[3]
        q_idx = q_offset + q0 + torch.arange(qc, device=q.device)[:, None]
        qflat = qblk.reshape(b, kvh, g * qc, hd)
        m = qblk.new_full((b, kvh, g, qc), ref._NEG_INF)
        l = qblk.new_zeros((b, kvh, g, qc))
        acc = qblk.new_zeros((b, kvh, g, qc, vh.shape[-1]))
        for k0 in range(0, t, kv_chunk):
            kc = min(kv_chunk, t - k0)
            logits = (qflat @ kh[..., k0:k0 + kc]).reshape(
                b, kvh, g, qc, kc) * scale
            kv_idx = k0 + torch.arange(kc, device=q.device)[None, :]
            mask = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kv_idx <= q_idx
            if window > 0:
                mask &= kv_idx > q_idx - window
            logits = torch.where(mask, logits, ref._NEG_INF)
            # the running max only shifts the exponents (its gradient is
            # zero), so it is detached
            m_new = torch.maximum(m, logits.amax(dim=-1)).detach()
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = (p.reshape(b, kvh, g * qc, kc) @ vh[:, :, k0:k0 + kc])
            acc = acc * corr[..., None] + pv.reshape(acc.shape)
            m = m_new
        return acc / torch.clamp_min(l, 1e-30)[..., None]

    # flash semantics: backward recomputes each block's chunk loop instead
    # of keeping per-chunk probabilities (otherwise it holds O(S^2))
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = [checkpoint(q_block, q0, qh[:, :, :, q0:q0 + q_chunk], kh, vh,
                       use_reentrant=False, preserve_rng_state=False)
            if grad else q_block(q0, qh[:, :, :, q0:q0 + q_chunk], kh, vh)
            for q0 in range(0, s, q_chunk)]
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).to(v.dtype)


def gqa_prefill(params, cfg, x, positions, *, kernel=False, window=0,
                product=torch.matmul):
    """Full prefill/training attention. Returns ([B,S,D], (k, v)), k and v
    [B,S,KV,hd] for the cache. window: the sliding window (0: the
    config's own, as in the reference). product(heads, wo): the output
    projection (a rank of a model axis passes `ModelAxis.row_product`),
    as in every `gqa_*` function.

    kernel=False (training) computes the autograd-able `chunked_attention`;
    kernel=True (serving prefill) goes through `ops.flash_attention`,
    which has no backward, as the TPU kernel has none."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    win = window or cfg.attn_window
    q, k, v = _project_qkv(params, cfg, x, positions)
    if kernel:
        out = ops.flash_attention(q.reshape(b, s, h, hd), k, v, causal=True,
                                  window=win)
    else:
        out = chunked_attention(q, k, v, causal=True, window=win)
    out = out.reshape(b, s, h * hd)
    return product(out, params["wo"]), (k, v)


def bidir_attention(params, cfg, x, positions, *, kernel=False,
                    product=torch.matmul):
    """Encoder self-attention (no causal mask; rope on `positions`, as the
    reference's). x [B,T,D] -> [B,T,D]. kernel=False (training):
    `chunked_attention`; kernel=True (serving): `ops.flash_attention`
    with causal=False. product(heads, wo): the output projection, as in
    the `gqa_*` functions (and `cross_attention`, `cross_decode`)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(params, cfg, x, positions)
    if kernel:
        out = ops.flash_attention(q.reshape(b, s, h, hd), k, v, causal=False)
    else:
        out = chunked_attention(q, k, v, causal=False)
    return product(out.reshape(b, s, h * hd), params["wo"])


# ---------------------------------------------------------------------------
# cross-attention (the whisper decoder over the encoder's output)
# ---------------------------------------------------------------------------


def cross_init(generator, lead, cfg, dtype):
    """wq, wk, wv [D, H*hd] and wo [H*hd, D] with leading dims `lead`,
    He-scaled by their fan-in."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {"wq": _he(generator, lead + (d, h * hd), dtype, d),
            "wk": _he(generator, lead + (d, h * hd), dtype, d),
            "wv": _he(generator, lead + (d, h * hd), dtype, d),
            "wo": _he(generator, lead + (h * hd, d), dtype, h * hd)}


def cross_kv(params, cfg, enc_out):
    """The encoder output [B,T,D] -> its keys and values [B,T,H,hd] (every
    query head its own: no grouping, no rope)."""
    b, t, _ = enc_out.shape
    h, hd = cfg.num_heads, cfg.head_dim
    return ((enc_out @ params["wk"]).reshape(b, t, h, hd),
            (enc_out @ params["wv"]).reshape(b, t, h, hd))


def cross_attention(params, cfg, x, enc_k, enc_v, *, kernel=False,
                    product=torch.matmul):
    """x [B,S,D] over the encoder's enc_k, enc_v [B,T,H,hd] (in x's dtype)
    -> [B,S,D]. kernel=False (training): `chunked_attention`; kernel=True
    (serving prefill): `ops.flash_attention` with causal=False."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    if kernel:
        out = ops.flash_attention(q, enc_k, enc_v, causal=False)
    else:
        out = chunked_attention(q.reshape(b, s, h, 1, hd), enc_k, enc_v,
                                causal=False)
    return product(out.reshape(b, s, h * hd), params["wo"])


def cross_decode(params, cfg, x, enc_k, enc_v, product=torch.matmul):
    """One decode token a row x [B,1,D] over the cached enc_k, enc_v [B,T,
    H,hd], every row attending to all T rows, through `ops.decode_attention`
    (q cast to the cache's dtype, as `_decode_attend` does; the reference
    computes this with `cross_attention` over the cache cast to x's
    dtype). Returns [B,1,D]."""
    b = x.shape[0]
    h, hd, t = cfg.num_heads, cfg.head_dim, enc_k.shape[1]
    q = (x @ params["wq"]).reshape(b, h, hd).to(enc_k.dtype)
    lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
    out = ops.decode_attention(q, enc_k, enc_v, lengths=lengths)
    return product(out.reshape(b, 1, h * hd).to(x.dtype), params["wo"])


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


def gqa_decode(params, cfg, x, cache, position, product=torch.matmul):
    """x: [B,1,D]; cache: {k, v: [B,T,KV,hd], ptr} (ptr = tokens written,
    0-dim or per row [B]); position: [B,1] absolute positions.

    Inserts the new token's K/V first, then attends over the valid slots
    min(ptr + 1, T) of each row (so the token attends to itself), through
    `ops.decode_attention`. Updates the cache in place (K/V insert, ptr
    + 1) and returns ([B,1,D], cache). A windowed config's cache is a
    ring of capacity window, so no mask beyond `lengths` is needed."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, cfg, x, position)
    out = _decode_attend(cfg, q[:, 0], k_new[:, 0], v_new[:, 0], cache)
    return product(out.reshape(b, 1, -1).to(x.dtype), params["wo"]), cache


def _decode_attend(cfg, q, k_new, v_new, cache):
    """`gqa_decode` after the projection: q [B,KV,G,hd], k_new, v_new
    [B,KV,hd]. Inserts K/V at each row's ptr, attends, advances ptr, in
    place. Returns [B, H*hd] in the cache's dtype (q is cast to it for
    the kernel, which takes one dtype)."""
    b = q.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    t = cache["k"].shape[1]
    ring_insert(cache["k"], k_new, cache["ptr"])
    ring_insert(cache["v"], v_new, cache["ptr"])
    lengths = torch.clamp(cache["ptr"] + 1, max=t).to(torch.int32)
    lengths = lengths.expand(b).contiguous()
    out = ops.decode_attention(q.reshape(b, h, hd).to(cache["k"].dtype),
                               cache["k"], cache["v"], lengths=lengths)
    cache["ptr"].add_(1)
    return out.reshape(b, h * hd)


# ---------------------------------------------------------------------------
# paged KV (a shared block pool, per-row block tables)
#
# A layer's pool is {k, v: [NB, bs, KV, hd]}; block 0 is the null block
# that unallocated table entries point at and masked writes land in, and
# no live row ever attends to it. Logical position p of a row lies at row
# p % bs of block table[p // bs]. With window > 0 the table is a RING over
# ring slots: position p lies at ring slot p % window, so eviction is an
# overwrite and a slot never holds more than ceil(window / bs) blocks. The
# port writes the pool in place where the reference returns new buffers;
# duplicate scatter targets (dead rows, masked chunk positions) all lie in
# the null block, so their undefined winner is never read.
# ---------------------------------------------------------------------------


gather_pages = ref.gather_pages    # pool [NB, bs, ...] -> [B, W * bs, ...]


def scatter_chunk_pages(pool, entries, table, start, window=0, valid=None):
    """Write a prefill chunk's entries [C, ...] into one slot's blocks, in
    place. table int [W]; start: the absolute position of entries[0].

    Positions past the table's range go to the null block (only the
    padded chunk tail can land there; pads written into real blocks lie
    past the slot's length and are overwritten by decode before they are
    valid). window > 0: position p writes ring slot p % window, and the
    entries at or past `valid` (the chunk's true length) go to the null
    block, since a pad's ring slot can hold live wrapped context."""
    bs, w = pool.shape[1], table.shape[0]
    c = entries.shape[0]
    idx = torch.arange(c, device=pool.device)
    p = start + idx
    if window:
        p = p % window
    bi = p // bs
    in_range = bi < w
    if window:
        in_range &= idx < valid
    blk = torch.where(in_range, table.long()[torch.clamp(bi, max=w - 1)], 0)
    pool[blk, p % bs] = entries.to(pool.dtype)
    return pool


def scatter_token_pages(pool, entries, tables, positions, window=0):
    """Write one entry per row, entries [B, ...] at positions[b], in place.
    tables int [B, W].

    Dead rows (zeroed table) write the null block. A dead row's position
    drifts up by one per decode step, past the table's width: the block
    index is clamped to W - 1, which for a dead row is the null block
    too. window > 0: position p writes ring slot p % window, overwriting
    the evicted token."""
    bs, w = pool.shape[1], tables.shape[1]
    positions = positions.long()
    if window:
        positions = positions % window
    bi = torch.clamp(positions // bs, max=w - 1)
    blk = torch.gather(tables.long(), 1, bi[:, None])[:, 0]
    pool[blk, positions % bs] = entries.to(pool.dtype)
    return pool


def _paged_context_attention(q, k_ctx, v_ctx, k_new, v_new, ctx_len, scale,
                             window=0):
    """Chunk queries against (gathered context ++ the chunk's own K/V), as
    one masked softmax in f32.

    q [B,C,KV,G,hd]; k_ctx, v_ctx [B,T,KV,hd]; k_new, v_new [B,C,KV,hd];
    ctx_len: tokens already in the slot (an int). Context keys are valid
    below ctx_len; chunk keys are causal within the chunk (padded tail
    keys sit above every valid query). Returns [B,C,KV,G,hd] in f32.

    window > 0: the context is a ring; ring slot j holds the latest
    context position congruent to j, p_j = ctx_len-1 - ((ctx_len-1-j) %
    window), and chunk query i (position ctx_len + i) sees it when j <
    min(ctx_len, window) and p_j > ctx_len + i - window; it sees chunk key
    jj when jj <= i < jj + window: together the arena's sliding-window
    causal mask."""
    t, c = k_ctx.shape[1], q.shape[1]
    dev = q.device
    qf = q.float()
    ctx_logits = torch.einsum("bskgh,btkh->bskgt", qf, k_ctx.float()) * scale
    j = torch.arange(t, device=dev)
    if window:
        p_j = ctx_len - 1 - (ctx_len - 1 - j) % window            # [T]
        q_pos = ctx_len + torch.arange(c, device=dev)              # [C]
        ctx_valid = ((j < min(ctx_len, window))[None, :]
                     & (p_j[None, :] > q_pos[:, None] - window))   # [C, T]
    else:
        ctx_valid = (j < ctx_len)[None, :].expand(c, t)
    ctx_logits = torch.where(ctx_valid[None, :, None, None, :], ctx_logits,
                             ref._NEG_INF)
    self_logits = torch.einsum("bskgh,btkh->bskgt", qf, k_new.float()) * scale
    i = torch.arange(c, device=dev)
    causal = i[:, None] >= i[None, :]                              # [C, C]
    if window:
        causal &= (i[:, None] - i[None, :]) < window
    self_logits = torch.where(causal[None, :, None, None, :], self_logits,
                              ref._NEG_INF)
    p = torch.softmax(torch.cat([ctx_logits, self_logits], dim=-1), dim=-1)
    v_all = torch.cat([v_ctx, v_new], dim=1).float()
    return torch.einsum("bskgt,btkh->bskgh", p, v_all)


def gqa_prefill_paged(params, cfg, x, cache, table, ctx_len, window=0,
                      valid=None, product=torch.matmul):
    """One prefill chunk against a layer's paged pool (batch-1 admission).

    x [1,C,D]; cache {k, v: [NB, bs, KV, hd]}; table int [W]; ctx_len:
    tokens already in the slot's blocks (an int). Attends the chunk's
    queries to the gathered context (read before the chunk is written)
    plus the chunk itself, then scatters the chunk's K/V into the slot's
    blocks in place. `valid` (the chunk's true length) routes a ring's pad
    entries to the null block. Returns ([1,C,D], cache)."""
    b, c, _ = x.shape
    positions = ctx_len + torch.arange(c, device=x.device)[None].expand(b, c)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    out = _chunk_attend(cfg, q, k_new, v_new, cache, table, ctx_len,
                        window, valid)
    return product(out.to(x.dtype), params["wo"]), cache


def _chunk_attend(cfg, q, k_new, v_new, cache, table, ctx_len, window,
                  valid):
    """`gqa_prefill_paged` after the projection: q [1,C,KV,G,hd], k_new,
    v_new [1,C,KV,hd]. Returns [1, C, H*hd] in f32 and writes the chunk's
    K/V into the pool."""
    c = q.shape[1]
    h, hd = cfg.num_heads, cfg.head_dim
    k_ctx = gather_pages(cache["k"], table[None])
    v_ctx = gather_pages(cache["v"], table[None])
    out = _paged_context_attention(q, k_ctx, v_ctx, k_new, v_new, ctx_len,
                                   float(1.0 / math.sqrt(hd)), window=window)
    scatter_chunk_pages(cache["k"], k_new[0], table, ctx_len, window=window,
                        valid=valid)
    scatter_chunk_pages(cache["v"], v_new[0], table, ctx_len, window=window,
                        valid=valid)
    return out.reshape(1, c, h * hd)


def gqa_decode_paged(params, cfg, x, cache, tables, lengths, window=0,
                     product=torch.matmul):
    """One decode token per row against a layer's paged pool.

    x [B,1,D]; cache {k, v: [NB, bs, KV, hd]} (the layer's slice of the
    pool, written in place); tables int32 [B, W]; lengths int32 [B]:
    tokens already cached per row (the incoming token's position).
    Inserts the new token's K/V at position lengths[b], then attends over
    lengths[b] + 1 positions through `ops.decode_attention_paged` (the
    insert-then-attend of the arena's `gqa_decode`), which on the card is
    the CUDA kernel reading the pool where it lies: no gather. window > 0:
    the token writes ring slot lengths[b] % window and the row attends
    over min(lengths[b] + 1, window) ring slots through
    `ops.decode_attention_ring` (ring starts 0: the engine keeps each
    table in ring order). Returns ([B,1,D], cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, cfg, x, lengths.reshape(b, 1))
    out = _paged_decode_attend(cfg, q[:, 0], k_new[:, 0], v_new[:, 0], cache,
                               tables, lengths, window)
    return product(out.reshape(b, 1, -1).to(x.dtype), params["wo"]), cache


def _paged_decode_attend(cfg, q, k_new, v_new, cache, tables, lengths,
                         window):
    """`gqa_decode_paged` after the projection: q [B,KV,G,hd], k_new,
    v_new [B,KV,hd]. Returns [B, H*hd] in the pool's dtype."""
    b = q.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    scatter_token_pages(cache["k"], k_new, tables, lengths, window=window)
    scatter_token_pages(cache["v"], v_new, tables, lengths, window=window)
    q = q.reshape(b, h, hd).to(cache["k"].dtype)
    if window:
        out = ops.decode_attention_ring(
            q, cache["k"], cache["v"], tables,
            ring_starts=torch.zeros_like(lengths), lengths=lengths + 1,
            window=window)
    else:
        out = ops.decode_attention_paged(q, cache["k"], cache["v"], tables,
                                         lengths=lengths + 1)
    return out.reshape(b, h * hd)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
#
# The cache holds the compressed latents, not K/V: per token the rmsnormed
# c_kv [r] and one roped key head k_pe [rope] that all heads share. Prefill
# and training are non-absorbed (K and V expanded from the latent through
# wk_b and wv_b, then `chunked_attention` with g = 1); decode is absorbed
# (q_nope folded through wk_b into the latent space, attention over c_kv
# and k_pe, the context unfolded through wv_b), all in f32, as the
# reference computes it. Both cores are plain PyTorch, as the reference's
# are jnp outside any Pallas kernel: no kernel of the port takes
# hd_qk 192 with hd_v 128, or one latent head of 512 + 64 under 128 query
# heads.
# ---------------------------------------------------------------------------


def mla_init(generator, lead, cfg, dtype):
    """MLA weights with leading dims `lead`: wq_a [D, q_lora], q_norm over
    q_lora, wq_b [q_lora, H*(nope+rope)], wkv_a [D, r+rope], kv_norm over
    r, wk_b [r, H*nope], wv_b [r, H*v], wo [H*v, D], each He-scaled by its
    fan-in (its first dim; H*v for wo)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    r, dev = m.kv_lora_rank, generator.device
    return {
        "wq_a": _he(generator, lead + (d, m.q_lora_rank), dtype, d),
        "q_norm.scale": rmsnorm_init(lead + (m.q_lora_rank,), dtype,
                                     dev)["scale"],
        "wq_b": _he(generator, lead + (m.q_lora_rank, h * qk), dtype,
                    m.q_lora_rank),
        "wkv_a": _he(generator, lead + (d, r + m.qk_rope_head_dim), dtype,
                     d),
        "kv_norm.scale": rmsnorm_init(lead + (r,), dtype, dev)["scale"],
        "wk_b": _he(generator, lead + (r, h * m.qk_nope_head_dim), dtype, r),
        "wv_b": _he(generator, lead + (r, h * m.v_head_dim), dtype, r),
        "wo": _he(generator, lead + (h * m.v_head_dim, d), dtype,
                  h * m.v_head_dim),
    }


def _mla_split_q(cfg, q, rope):
    """q [B,S,H*(nope+rope)] -> (q_nope [B,S,H,nope], rope(q_pe))."""
    m = cfg.mla
    b, s, _ = q.shape
    q = q.reshape(b, s, cfg.num_heads, m.qk_nope_head_dim
                  + m.qk_rope_head_dim)
    q_nope, q_pe = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                               dim=-1)
    return q_nope, rope(q_pe)


def _mla_split_kv(cfg, kv, norm, rope):
    """kv [B,S,r+rope] -> (norm(c_kv) [B,S,r], k_pe [B,S,rope]): the
    single rope head through `rope` as [B,S,1,rope]."""
    m = cfg.mla
    c_kv, k_pe = torch.split(kv, [m.kv_lora_rank, m.qk_rope_head_dim],
                             dim=-1)
    return norm(c_kv), rope(k_pe[:, :, None, :])[:, :, 0]


def _mla_q(params, cfg, x, positions):
    """x [B,S,D] -> q_nope [B,S,H,nope], q_pe [B,S,H,rope] (roped):
    through the q_lora bottleneck and its rmsnorm."""
    q = rmsnorm({"scale": params["q_norm.scale"]}, x @ params["wq_a"])
    return _mla_split_q(cfg, q @ params["wq_b"],
                        lambda t: apply_rope(t, positions, cfg.rope_theta))


def _mla_ckv(params, cfg, x, positions):
    """x [B,S,D] -> the latents c_kv [B,S,r] (rmsnormed) and k_pe
    [B,S,rope] (roped)."""
    return _mla_split_kv(
        cfg, x @ params["wkv_a"],
        lambda t: rmsnorm({"scale": params["kv_norm.scale"]}, t),
        lambda t: apply_rope(t, positions, cfg.rope_theta))


def _mla_expand(params, cfg, c_kv, k_pe):
    """Non-absorbed K [B,S,H,nope+rope] (k_pe broadcast over the heads)
    and V [B,S,H,v] from the latents c_kv [B,S,r], k_pe [B,S,rope]."""
    m = cfg.mla
    b, s, _ = c_kv.shape
    h = cfg.num_heads
    k_nope = (c_kv @ params["wk_b"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = (c_kv @ params["wv_b"]).reshape(b, s, h, m.v_head_dim)
    k = torch.cat([k_nope, k_pe[:, :, None, :].to(k_nope.dtype).expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    return k, v


def _mla_prefill_core(params, cfg, q_nope, q_pe, c_kv, k_pe):
    """`mla_prefill` after the projection: K/V expanded, causal
    `chunked_attention` with g = 1 and scale 1/sqrt(nope+rope). Returns
    [B, S, H*v] in V's dtype."""
    b, s, h, _ = q_nope.shape
    k, v = _mla_expand(params, cfg, c_kv, k_pe)
    q = torch.cat([q_nope, q_pe], dim=-1)
    out = chunked_attention(q[:, :, :, None, :], k, v, causal=True)
    return out.reshape(b, s, h * cfg.mla.v_head_dim)


def mla_prefill(params, cfg, x, positions, product=torch.matmul):
    """Non-absorbed MLA for training and the serving prefill (plain
    PyTorch: the reference has no kernel here). It ignores any sliding
    window, as the reference's does. `product` is the output
    projection's (a rank's partial one on a model axis, where the
    leaves hold the rank's heads and `cfg.num_heads` counts them, as in
    every `mla_*` function). Returns ([B,S,D], (c_kv [B,S,r], k_pe
    [B,S,rope])) for the cache."""
    q_nope, q_pe = _mla_q(params, cfg, x, positions)
    c_kv, k_pe = _mla_ckv(params, cfg, x, positions)
    out = _mla_prefill_core(params, cfg, q_nope, q_pe, c_kv, k_pe)
    return product(out, params["wo"]), (c_kv, k_pe)


def _mla_absorbed(params, cfg, q_nope, q_pe, ckv, kpe, num_valid):
    """Absorbed latent attention in f32, as the reference's: q_nope
    [B,H,nope], q_pe [B,H,rope]; ckv [B,T,r], kpe [B,T,rope] with the first
    num_valid (0-dim or [B]) slots of each row valid. wk_b and wv_b are
    cast to f32 here, every call, as the reference casts them. Returns
    [B, H*v] in f32."""
    m = cfg.mla
    b, h = q_nope.shape[0], cfg.num_heads
    t = ckv.shape[1]
    wk_b = params["wk_b"].float().reshape(m.kv_lora_rank, h,
                                          m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope.float(), wk_b)
    ckv = ckv.float()
    scale = float(1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    logits = (torch.einsum("bhr,btr->bht", q_lat, ckv)
              + torch.einsum("bhd,btd->bht", q_pe.float(), kpe.float())
              ) * scale
    valid = torch.arange(t, device=ckv.device) < num_valid.reshape(-1, 1)
    logits = torch.where(valid[:, None, :], logits, ref._NEG_INF)
    p = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bht,btr->bhr", p, ckv)
    wv_b = params["wv_b"].float().reshape(m.kv_lora_rank, h, m.v_head_dim)
    return torch.einsum("bhr,rhd->bhd", ctx, wv_b).reshape(
        b, h * m.v_head_dim)


def _mla_decode_attend(params, cfg, q_nope, q_pe, c_kv, k_pe, cache):
    """`mla_decode` after the projection: q_nope [B,H,nope], q_pe
    [B,H,rope], c_kv [B,r], k_pe [B,rope]. Inserts the latents at each
    row's ptr, attends over min(ptr + 1, T) slots, advances ptr, in
    place. Returns [B, H*v] in f32."""
    t = cache["ckv"].shape[1]
    ring_insert(cache["ckv"], c_kv, cache["ptr"])
    ring_insert(cache["kpe"], k_pe, cache["ptr"])
    num_valid = torch.clamp(cache["ptr"] + 1, max=t)
    out = _mla_absorbed(params, cfg, q_nope, q_pe, cache["ckv"],
                        cache["kpe"], num_valid)
    cache["ptr"].add_(1)
    return out


def mla_decode(params, cfg, x, cache, position, product=torch.matmul):
    """Absorbed MLA decode: x [B,1,D]; cache {ckv [B,T,r], kpe [B,T,rope],
    ptr} (ptr 0-dim or per row [B]); position [B,1]. Inserts the token's
    latents, then attends in the latent space, O(r) a position, never
    materialising K/V. Updates the cache in place and returns ([B,1,D],
    cache); `product` as `mla_prefill`'s."""
    b = x.shape[0]
    q_nope, q_pe = _mla_q(params, cfg, x, position)
    c_kv, k_pe = _mla_ckv(params, cfg, x, position)
    out = _mla_decode_attend(params, cfg, q_nope[:, 0], q_pe[:, 0],
                             c_kv[:, 0], k_pe[:, 0], cache)
    return product(out.reshape(b, 1, -1).to(x.dtype), params["wo"]), cache


def _mla_chunk_attend(params, cfg, q_nope, q_pe, c_kv, k_pe, cache, table,
                      ctx_len):
    """`mla_prefill_paged` after the projection: q_nope [1,C,H,nope], q_pe
    [1,C,H,rope], c_kv [1,C,r], k_pe [1,C,rope]. The context latents,
    gathered before the chunk is written and cast to the compute dtype,
    and the chunk's own are expanded as in `mla_prefill`; the chunk's
    latents are then scattered into its blocks. Returns [1, C, H*v] in
    f32."""
    c, h = q_nope.shape[1], cfg.num_heads
    dt = c_kv.dtype
    ckv_ctx = gather_pages(cache["ckv"], table[None])
    kpe_ctx = gather_pages(cache["kpe"], table[None])
    k_ctx, v_ctx = _mla_expand(params, cfg, ckv_ctx.to(dt), kpe_ctx)
    k_new, v_new = _mla_expand(params, cfg, c_kv, k_pe)
    q = torch.cat([q_nope, q_pe], dim=-1)
    out = _paged_context_attention(q[:, :, :, None, :], k_ctx, v_ctx, k_new,
                                   v_new, ctx_len,
                                   float(1.0 / math.sqrt(q.shape[-1])))
    scatter_chunk_pages(cache["ckv"], c_kv[0], table, ctx_len)
    scatter_chunk_pages(cache["kpe"], k_pe[0], table, ctx_len)
    return out.reshape(1, c, h * cfg.mla.v_head_dim)


def mla_prefill_paged(params, cfg, x, cache, table, ctx_len,
                      product=torch.matmul):
    """One MLA prefill chunk against a layer's latent pool (batch-1).

    x [1,C,D]; cache {ckv [NB,bs,r], kpe [NB,bs,rope]} (kpe post-rope, as
    the arena keeps it); table int [W]; ctx_len: tokens already in the
    slot (an int). The chunk attends to its context, K/V reconstructed
    from the gathered latents, and to itself, then its latents are
    scattered into the blocks in place. Returns ([1,C,D], cache);
    `product` as `mla_prefill`'s."""
    b, c, _ = x.shape
    positions = ctx_len + torch.arange(c, device=x.device)[None].expand(b, c)
    q_nope, q_pe = _mla_q(params, cfg, x, positions)
    c_kv, k_pe = _mla_ckv(params, cfg, x, positions)
    out = _mla_chunk_attend(params, cfg, q_nope, q_pe, c_kv, k_pe, cache,
                            table, ctx_len)
    return product(out.to(x.dtype), params["wo"]), cache


def _mla_paged_decode_attend(params, cfg, q_nope, q_pe, c_kv, k_pe, cache,
                             tables, lengths):
    """`mla_decode_paged` after the projection (operands as
    `_mla_decode_attend`'s). Returns [B, H*v] in f32."""
    scatter_token_pages(cache["ckv"], c_kv, tables, lengths)
    scatter_token_pages(cache["kpe"], k_pe, tables, lengths)
    return _mla_absorbed(params, cfg, q_nope, q_pe,
                         gather_pages(cache["ckv"], tables),
                         gather_pages(cache["kpe"], tables), lengths + 1)


def mla_decode_paged(params, cfg, x, cache, tables, lengths,
                     product=torch.matmul):
    """Absorbed MLA decode against a layer's latent pool: `mla_decode`'s
    math over a block-table gather. x [B,1,D]; tables int32 [B, W];
    lengths int32 [B] (the incoming token's position). Inserts the token's
    latents at position lengths[b] first, in place. Returns ([B,1,D],
    cache); `product` as `mla_prefill`'s."""
    b = x.shape[0]
    pos = lengths.reshape(b, 1)
    q_nope, q_pe = _mla_q(params, cfg, x, pos)
    c_kv, k_pe = _mla_ckv(params, cfg, x, pos)
    out = _mla_paged_decode_attend(params, cfg, q_nope[:, 0], q_pe[:, 0],
                                   c_kv[:, 0], k_pe[:, 0], cache, tables,
                                   lengths)
    return product(out.reshape(b, 1, -1).to(x.dtype), params["wo"]), cache


# ---------------------------------------------------------------------------
# the fused mixed step (overlapped admission): decode rows [:nd] and one
# prefill unit [nd:] as one token batch [1, nd + S, D]
#
# The elementwise ops and the unembedding run once over all tokens;
# rope, the attention cores and the ops in MIXED_PER_HALF (every product
# but the unembedding, rmsnorm) run per half, each half's
# core exactly what its standalone step runs after the projection (the
# decode and flash kernels on the arena, the paged or ring kernel and the
# plain chunk attention on the pool). A shared op's rows are bitwise those
# of the standalone launches only where it is row-stable across M (the
# engine's overlapped output equals its serialized output only then).
# Cache writes keep the sequential order: the decode half inserts first,
# then the prefill half writes (on the arena the whole slot row, over the
# dead slot's garbage insert; on the pool its private blocks, disjoint
# from the decode writes).
# ---------------------------------------------------------------------------

# The ops that run per half: every product here, and rmsnorm. On an H100,
# cuBLAS's bf16 product of the 8 decode rows alone differs from the same
# rows inside the mixed batch (8 + 256 on the arena, 8 + 32 on the pool)
# for each of these products at one of the dense configs' widths at least:
# w_down at K = 4864 (qwen2), 8192, 12288 and 24576; wk and wv at K = 4096
# (qwen3, where 32 chunk rows alone differ from them among 40 too); wq,
# wk, wv and wo at K = 6144 (nemotron). rmsnorm's f32 mean of squares
# over d_model (2048, 4096, 6144) sums in another order for 8 + 256 rows
# than for 8, which tips a bf16 rounding now and then: shared, it made
# internlm2's and qwen3's overlapped logits leave the serialized ones on
# the card, and qwen3's tokens. qk-norm (the same reduction over hd)
# measured row-stable and runs per half with the other norms. The gate
# and up projections were bitwise row-stable at the GQA configs' widths,
# but not at deepseek-v2's (K = 5120, N = 1536: the 8 decode rows moved
# by up to 0.0156 at Sp = 256, and the dense MLA stack's overlapped
# tokens left the serialized ones), so they run per half with their
# activation (the MLP's hidden layer, named "w_up"). The unembedding was
# row-stable at every width. MLA's down projections wq_a and wkv_a (K =
# d_model; unstable at 5120 too) and wq_b (K = q_lora) run per half, as
# wq/wk/wv do, and its q_norm and kv_norm (over q_lora and r) are
# rmsnorms; its expansion products and absorbed einsums touch one half
# only. layernorm (a layernorm stack's block and final norms) reduces over
# d_model as rmsnorm does, and runs per half with it. `chip_smoke.py`'s
# row-stability report measures each op.
MIXED_PER_HALF = frozenset({"wq", "wk", "wv", "wo", "w_down", "rmsnorm",
                            "layernorm", "w_gate", "w_up", "wq_a", "wq_b",
                            "wkv_a"})


def per_half(fn, x, nd, name):
    """fn over the mixed batch x [1, nd + S, ...]: per half (the decode
    rows [:nd], then the rest, as the standalone steps run it) where the
    op `name` is in MIXED_PER_HALF, else once over all rows."""
    if name not in MIXED_PER_HALF:
        return fn(x)
    return torch.cat([fn(x[:, :nd]), fn(x[:, nd:])], dim=1)


def mixed_product(x, w, nd, name, product=torch.matmul):
    """product(x, w) (x [1, nd + S, K] @ w) for the product `name`, through
    `per_half`."""
    return per_half(lambda t: product(t, w), x, nd, name)


def mixed_norm(params, x, nd, norm_type="rmsnorm"):
    """The norm `norm_type` ("rmsnorm" or "layernorm") over the mixed
    batch's last axis, through `per_half`."""
    norm = {"rmsnorm": rmsnorm, "layernorm": layernorm}[norm_type]
    return per_half(lambda t: norm(params, t), x, nd, norm_type)


def _rope_mixed(t, nd, pos_d, pos_p, theta):
    """apply_rope over the concatenated token axis, each half with its own
    positions (pos_d [1, nd], pos_p [1, S]); rope is elementwise, so each
    half is bitwise its standalone value."""
    return torch.cat([apply_rope(t[:, :nd], pos_d, theta),
                      apply_rope(t[:, nd:], pos_p, theta)], dim=1)


def _project_qkv_mixed(params, cfg, x, nd, pos_d, pos_p):
    """`_project_qkv` for the mixed batch x [1, nd + S, D]: the q/k/v
    products through `mixed_product`, qk-norm through `mixed_norm`,
    rope per half."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = (mixed_product(x, params[w], nd, w)
               for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q, k = _qk_norm(params, cfg, q.reshape(b, s, h, hd),
                    k.reshape(b, s, kv, hd),
                    norm=lambda p, t: mixed_norm(p, t, nd))
    q = _rope_mixed(q, nd, pos_d, pos_p, cfg.rope_theta)
    k = _rope_mixed(k, nd, pos_d, pos_p, cfg.rope_theta)
    return q.reshape(b, s, kv, h // kv, hd), k, v.reshape(b, s, kv, hd)


def gqa_mixed(params, cfg, x, nd, pos_d, pos_p, cache, p_len, p_slot,
              window=0, product=torch.matmul):
    """Fused arena layer: decode rows [:nd] and a whole prompt [nd:].

    x [1, nd + Sp, D] (normed); pos_d [1, nd]: the decode rows' positions;
    pos_p [1, Sp]: 0..Sp-1. cache: one arena layer {k, v: [nd, T, KV,
    hd], ptr [nd]}, written in place. Slot `p_slot` (an int) must be dead
    to decode: the decode half's insert into its row is overwritten whole
    by the prompt's entries, and its ptr set to `p_len`, as
    `decode_rows` followed by `prefill_into_slot` leave it. Returns
    ([1, nd + Sp, D], cache)."""
    sp = x.shape[1] - nd
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv_mixed(params, cfg, x, nd, pos_d, pos_p)
    out_d = _decode_attend(cfg, q[0, :nd], k[0, :nd], v[0, :nd], cache)
    # the prefill half: gqa_prefill(kernel=True) after the projection
    out_p = ops.flash_attention(q[:, nd:].reshape(1, sp, h, hd), k[:, nd:],
                                v[:, nd:], causal=True,
                                window=window or cfg.attn_window)
    # the prompt's row over the decode half's insert
    t = cache["k"].shape[1]
    cache["k"][p_slot].copy_(prefill_cache_entries(k[:, nd:], t, sp)[0])
    cache["v"][p_slot].copy_(prefill_cache_entries(v[:, nd:], t, sp)[0])
    cache["ptr"][p_slot] = p_len
    out = torch.cat([out_d[None].to(x.dtype), out_p.reshape(1, sp, h * hd)],
                    dim=1)
    return mixed_product(out, params["wo"], nd, "wo", product), cache


def gqa_mixed_paged(params, cfg, x, nd, pos_d, pos_p, cache, tables, lengths,
                    ctx_len, c_table, window=0, c_valid=None,
                    product=torch.matmul):
    """Fused pool layer: decode rows [:nd] and one prefill chunk [nd:].

    cache: one pool layer {k, v: [NB, bs, KV, hd]}, written in place;
    tables int32 [nd, W] and lengths int32 [nd]: the decode operands of
    `gqa_decode_paged`; ctx_len, c_table int [Wc] and c_valid: the chunk
    operands of `gqa_prefill_paged`. The decode half scatters first (a
    streaming slot's zeroed table row routes its writes to the null
    block); the chunk then gathers its context from the updated pool and
    scatters its own entries into its private blocks. Returns ([1, nd + C,
    D], cache)."""
    q, k, v = _project_qkv_mixed(params, cfg, x, nd, pos_d, pos_p)
    out_d = _paged_decode_attend(cfg, q[0, :nd], k[0, :nd], v[0, :nd], cache,
                                 tables, lengths, window)
    out_p = _chunk_attend(cfg, q[:, nd:], k[:, nd:], v[:, nd:], cache,
                          c_table, ctx_len, window, c_valid)
    out = torch.cat([out_d[None].to(x.dtype), out_p.to(x.dtype)], dim=1)
    return mixed_product(out, params["wo"], nd, "wo", product), cache


def _mla_q_mixed(params, cfg, x, nd, pos_d, pos_p):
    """`_mla_q` for the mixed batch: wq_a, q_norm and wq_b through
    `mixed_product` and `mixed_norm`, rope per half."""
    q = mixed_norm({"scale": params["q_norm.scale"]},
                      mixed_product(x, params["wq_a"], nd, "wq_a"), nd)
    return _mla_split_q(cfg, mixed_product(q, params["wq_b"], nd, "wq_b"),
                        lambda t: _rope_mixed(t, nd, pos_d, pos_p,
                                              cfg.rope_theta))


def _mla_ckv_mixed(params, cfg, x, nd, pos_d, pos_p):
    """`_mla_ckv` for the mixed batch: wkv_a and kv_norm through
    `mixed_product` and `mixed_norm`, rope per half."""
    return _mla_split_kv(
        cfg, mixed_product(x, params["wkv_a"], nd, "wkv_a"),
        lambda t: mixed_norm({"scale": params["kv_norm.scale"]}, t, nd),
        lambda t: _rope_mixed(t, nd, pos_d, pos_p, cfg.rope_theta))


def mla_mixed(params, cfg, x, nd, pos_d, pos_p, cache, p_len, p_slot,
              product=torch.matmul):
    """Fused arena MLA layer: absorbed decode of rows [:nd] and the
    non-absorbed prefill of a whole prompt [nd:]. cache: one arena layer
    {ckv [nd,T,r], kpe [nd,T,rope], ptr [nd]}, written in place; the
    contract of `gqa_mixed` (slot `p_slot` dead to decode, its row
    overwritten whole after the decode half's insert, its ptr set to
    `p_len`). Returns ([1, nd + Sp, D], cache); `product` as
    `mla_prefill`'s."""
    sp = x.shape[1] - nd
    q_nope, q_pe = _mla_q_mixed(params, cfg, x, nd, pos_d, pos_p)
    c_kv, k_pe = _mla_ckv_mixed(params, cfg, x, nd, pos_d, pos_p)
    out_d = _mla_decode_attend(params, cfg, q_nope[0, :nd], q_pe[0, :nd],
                               c_kv[0, :nd], k_pe[0, :nd], cache)
    out_p = _mla_prefill_core(params, cfg, q_nope[:, nd:], q_pe[:, nd:],
                              c_kv[:, nd:], k_pe[:, nd:])
    t = cache["ckv"].shape[1]
    cache["ckv"][p_slot].copy_(prefill_cache_entries(c_kv[:, nd:], t, sp)[0])
    cache["kpe"][p_slot].copy_(prefill_cache_entries(k_pe[:, nd:], t, sp)[0])
    cache["ptr"][p_slot] = p_len
    out = torch.cat([out_d[None].to(x.dtype), out_p], dim=1)
    return mixed_product(out, params["wo"], nd, "wo", product), cache


def mla_mixed_paged(params, cfg, x, nd, pos_d, pos_p, cache, tables, lengths,
                    ctx_len, c_table, product=torch.matmul):
    """Fused pool MLA layer: absorbed decode of rows [:nd] and one chunk
    [nd:]. cache: one latent pool layer {ckv [NB,bs,r], kpe [NB,bs,rope]},
    written in place; the operands and op order of `gqa_mixed_paged` (the
    decode half scatters first, the chunk then gathers its context from
    the updated pool and scatters into its private blocks). Returns ([1,
    nd + C, D], cache); `product` as `mla_prefill`'s."""
    q_nope, q_pe = _mla_q_mixed(params, cfg, x, nd, pos_d, pos_p)
    c_kv, k_pe = _mla_ckv_mixed(params, cfg, x, nd, pos_d, pos_p)
    out_d = _mla_paged_decode_attend(params, cfg, q_nope[0, :nd],
                                     q_pe[0, :nd], c_kv[0, :nd],
                                     k_pe[0, :nd], cache, tables, lengths)
    out_p = _mla_chunk_attend(params, cfg, q_nope[:, nd:], q_pe[:, nd:],
                              c_kv[:, nd:], k_pe[:, nd:], cache, c_table,
                              ctx_len)
    out = torch.cat([out_d[None].to(x.dtype), out_p.to(x.dtype)], dim=1)
    return mixed_product(out, params["wo"], nd, "wo", product), cache
