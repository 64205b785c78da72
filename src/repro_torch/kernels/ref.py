"""Plain PyTorch versions of the port's kernels (the correctness oracles).

The CPU path runs these; on the card `chip_smoke.py` holds each kernel
against them on the same inputs.
"""
from __future__ import annotations

import math

import torch


def prox_update(x, g, zsum, *, tau, rho, num_walks, num_agents):
    """gAPI-BCD closed form (eq. 15) + incremental token delta (eq. 12b).

    x_new = (rho*x - g + tau*zsum) / (rho + tau*M), delta = (x_new - x)/N,
    in f32. Returns (x_new in x.dtype, delta in f32).

    Both divisions take a 0-dim tensor on x's device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which is
    not the IEEE quotient the reference and the kernel compute.
    """
    denom = torch.tensor(rho + tau * num_walks, dtype=torch.float32,
                         device=x.device)
    n = torch.tensor(float(num_agents), dtype=torch.float32, device=x.device)
    xf = x.float()
    x_new = (rho * xf - g.float() + tau * zsum.float()) / denom
    delta = (x_new - xf) / n
    return x_new.to(x.dtype), delta


_NEG_INF = -1e30


def _masked_softmax_attend(logits, mask, v):
    """The kernels' arithmetic in f32: masked logits at -1e30, then
    out = (p @ v) / max(l, 1e-30) with p = exp(logits - row max).

    logits [B, KV, G, S, T]; mask broadcastable to it; v [B, KV, T, hd]
    (one kv head for its G query heads, so K and V are never repeated).
    The row max only shifts the exponent: it is detached, as its gradient
    is zero, so autograd runs through this for the training path.
    Returns [B, KV, G, S, hd] in f32.
    """
    logits = torch.where(mask, logits, _NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    b, kv, g, s, t = p.shape
    acc = (p.reshape(b, kv, g * s, t) @ v).reshape(b, kv, g, s, -1)
    return acc / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)


def _logits(q, k, scale):
    """q [B, KV, G, S, hd] and k [B, T, KV, hd] -> f32 logits
    [B, KV, G, S, T]."""
    b, kv, g, s, hd = q.shape
    kt = k.float().permute(0, 2, 3, 1)                       # [b,kv,hd,t]
    return (q.float().reshape(b, kv, g * s, hd) @ kt).reshape(
        b, kv, g, s, -1) * scale


def attention(q, k, v, *, causal=True, window=0, scale=None):
    """Online-softmax GQA attention (the TPU kernel `flash_attention_bhsd`)
    as one masked softmax; also the training path's attention
    (`models.attention.chunked_attention`), which autograd runs through.

    q: [B, S, H, hd]; k, v: [B, T, KV, hd] with H = KV * G (query head h
    reads kv head h // G). Masks: causal kv <= q, window kv > q - window
    (window > 0). Logits and sums in f32; returns [B, S, H, hd] in q's
    dtype.
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else float(1.0 / math.sqrt(hd))
    qh = q.reshape(b, s, kv, h // kv, hd).permute(0, 2, 3, 1, 4)
    q_idx = torch.arange(s, device=q.device)[:, None]
    kv_idx = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_idx <= q_idx
    if window > 0:
        mask &= kv_idx > q_idx - window
    out = _masked_softmax_attend(_logits(qh, k, scale), mask,
                                 v.float().permute(0, 2, 1, 3))
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def decode_attention(q, k, v, *, lengths, scale=None):
    """One-token GQA decode over a linear cache (the TPU kernel
    `decode_attention_grouped`).

    q: [B, H, hd]; k, v: [B, T, KV, hd]; lengths: int [B], the valid
    cache rows of each batch row (positions >= lengths[b] are masked and
    their V rows zeroed). Returns [B, H, hd] in q's dtype.
    """
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else float(1.0 / math.sqrt(hd))
    valid = (torch.arange(t, device=q.device)[None, :]
             < lengths.to(q.device).reshape(b, 1))          # [b, t]
    # invalid V rows are zeroed, as the kernel does (0 * garbage is NaN)
    vh = torch.where(valid[:, None, :, None], v.float().permute(0, 2, 1, 3),
                     0.0)                                    # [b,kv,t,hd]
    out = _masked_softmax_attend(
        _logits(q.reshape(b, kv, h // kv, 1, hd), k, scale),
        valid[:, None, None, None, :], vh)
    return out.reshape(b, h, hd).to(q.dtype)


def decode_attention_split(q, k, v, *, lengths, split_rows, scale=None):
    """`decode_attention` by the decode kernel's split-and-combine
    arithmetic (the tests hold it against `decode_attention` and the TPU
    kernel; the card runs the kernel).

    The cache is cut into chunks of `split_rows` rows. Each chunk that
    starts below a row's length keeps, in f32, its own max m_s, sum l_s and
    unnormalised acc_s over its valid rows; the chunks combine as
        M = max_s m_s;  out = sum_s e^(m_s - M) acc_s
                              / max(sum_s e^(m_s - M) l_s, 1e-30).
    A row that fits one chunk gets acc_0 / max(l_0, 1e-30), the same value;
    a row of length 0 gets 0. Shapes as `decode_attention`.
    """
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else float(1.0 / math.sqrt(hd))
    n = max(1, -(-t // split_rows))
    pad = n * split_rows - t
    kp, vp = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
              .reshape(b, n, split_rows, kv, hd) for x in (k, v))
    pos = torch.arange(n * split_rows, device=q.device).reshape(n, split_rows)
    lens = lengths.to(q.device).reshape(b, 1, 1)
    valid = pos[None] < lens                                  # [b, n, R]
    active = pos[None, :, 0] < lens[:, :, 0]                  # [b, n]
    logits = torch.einsum("bcgd,bnrcd->bcgnr",
                          q.float().reshape(b, kv, g, hd), kp) * scale
    logits = torch.where(valid[:, None, None], logits, _NEG_INF)
    m = logits.amax(dim=-1)                                   # [b,kv,g,n]
    p = torch.exp(logits - m[..., None])
    vz = torch.where(valid[..., None, None], vp, 0.0)
    acc = torch.einsum("bcgnr,bnrcd->bcgnd", p, vz)
    l_s = p.sum(dim=-1)
    act = active[:, None, None]                               # [b,1,1,n]
    big = torch.where(act, m, -math.inf).amax(dim=-1, keepdim=True)
    w = torch.where(act, torch.exp(m - torch.where(act, big, 0.0)), 0.0)
    out = (w[..., None] * acc).sum(dim=-2) / torch.clamp_min(
        (w * l_s).sum(dim=-1), 1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def gather_pages(pool, tables):
    """pool [NB, bs, ...] through int tables [B, W] -> linear [B, W * bs,
    ...]: logical position p of row b is row p % bs of pool block
    tables[b, p // bs] (a copy: the plain paged paths and the paged
    prefill gather, the kernels read the pool where it lies)."""
    b, w = tables.shape
    return pool[tables.long()].reshape((b, w * pool.shape[1]) + pool.shape[2:])


def decode_attention_paged(q, k_pool, v_pool, block_tables, *, lengths,
                           scale=None):
    """One-token GQA decode against a shared block pool (the TPU kernel
    `decode_attention_paged_grouped`): gather each row's blocks into a
    linear cache, then `decode_attention` with per-row lengths.

    q: [B, H, hd]; k_pool, v_pool: [NB, bs, KV, hd] (block 0 is the null
    block); block_tables: int [B, W]; lengths: int [B], the valid logical
    positions of each row (positions past W * bs do not exist). Returns
    [B, H, hd] in q's dtype.
    """
    return decode_attention(q, gather_pages(k_pool, block_tables),
                            gather_pages(v_pool, block_tables),
                            lengths=lengths, scale=scale)


def ring_order(block_tables, ring_starts):
    """Undo each row's table rotation: ring block bi of row b sits at table
    entry (ring_starts[b] + bi) % W; returns the tables in ring order."""
    b, w = block_tables.shape
    order = (ring_starts.long().reshape(b, 1)
             + torch.arange(w, device=block_tables.device)[None]) % w
    return torch.gather(block_tables.long(), 1, order)


def decode_attention_ring(q, k_pool, v_pool, block_tables, *, ring_starts,
                          lengths, window, scale=None):
    """One-token GQA decode over a sliding-window ring of blocks (the TPU
    kernel `decode_attention_ring_grouped`): undo each row's table
    rotation (ring block bi sits at table entry (starts[b] + bi) % W),
    then the ring is a paged layout over ring slots, of which exactly
    min(lengths[b], window) are valid, of the W * bs the table covers (the
    serving engine's table is narrower than the ring until a row holds
    more than W * bs tokens).

    q: [B, H, hd]; pools [NB, bs, KV, hd]; block_tables: int [B, W];
    ring_starts, lengths: int [B]. Returns [B, H, hd] in q's dtype.
    """
    return decode_attention_paged(q, k_pool, v_pool,
                                  ring_order(block_tables, ring_starts),
                                  lengths=torch.clamp(lengths, max=window),
                                  scale=scale)


def decode_attention_paged_split(q, k_pool, v_pool, block_tables, *, lengths,
                                 split_rows, ring_starts=None, window=0,
                                 scale=None):
    """`decode_attention_paged` (window 0) or `decode_attention_ring`
    (window > 0, with ring_starts) by the paged kernel's split-and-combine
    arithmetic (the tests hold it against both and the TPU kernels; the
    card runs the kernel): the row's blocks gathered in logical (ring-
    slot) order into a linear cache of W * bs rows, each row's length
    capped where the kernel caps it (at W * bs, and at the window for a
    ring), then `decode_attention_split` over chunks of `split_rows`, one
    batch row at a time as the kernel's blocks take them (PyTorch's CPU
    matmul rounds a batch of rows otherwise than one row alone), so that
    a row's bits depend neither on the batch nor on the table's width.
    Shapes as `decode_attention_paged`.
    """
    cap = block_tables.shape[1] * k_pool.shape[1]
    if window:
        block_tables = ring_order(block_tables, ring_starts)
        cap = min(cap, window)
    lengths = torch.clamp(lengths, 0, cap)
    return torch.cat([decode_attention_split(
        q[i:i + 1], gather_pages(k_pool, block_tables[i:i + 1]),
        gather_pages(v_pool, block_tables[i:i + 1]),
        lengths=lengths[i:i + 1], split_rows=split_rows, scale=scale)
        for i in range(q.shape[0])])


def rwkv6(r, k, v, w, u, state=None):
    """RWKV6 WKV recurrence (the TPU kernel `rwkv6_scan_bh`, with state in
    and out), a sequential loop over time in f32:

        out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
        S_t   = diag(w_t) S_{t-1} + k_t^T v_t

    r, k, v, w: [B, H, S, hd]; u: [H, hd]; state: f32 [B, H, hd, hd]
    (None: zeros), not modified. Returns (out [B, H, S, hd] in f32, the
    final state in f32). The output stays in f32, as the model's
    sequential path keeps it (the reference's oracle casts it to r's
    dtype).
    """
    b, h, s, hd = r.shape
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                            device=r.device)
    st = state.float()
    uf = u.float()[None, :, :, None]
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    outs = []
    for t in range(s):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], st + uf * kv))
        st = wf[:, :, t, :, None] * st + kv
    return torch.stack(outs, dim=2), st


def rglru(a, u, h0=None):
    """RG-LRU gated linear recurrence (the TPU kernel `rglru_scan_bsw`, with
    state in and out), a sequential loop over time in f32:

        h_t = a_t * h_{t-1} + u_t

    rounding the product and the sum each (two ops a step, as the kernel).
    a, u: [B, S, W]; h0: f32 [B, W] (None: zeros), not modified. Returns
    (h [B, S, W] in f32, the final h [B, W] in f32).
    """
    b, s, w = a.shape
    h = (torch.zeros((b, w), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, uf = a.float(), u.float()
    outs = []
    for t in range(s):
        h = af[:, t] * h + uf[:, t]
        outs.append(h)
    return torch.stack(outs, dim=1), h
