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
    is zero. Returns [B, KV, G, S, hd] in f32.
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
    as one masked softmax. The training path's attention is the
    reference's chunked online softmax (`models.attention.
    chunked_attention`), not this.

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


SUB = 16    # steps of a sub-chunk: the span of every log-decay sum


def _products(factors):
    """[prod_{m<j}, prod_{m>j}] of a list of equal-shaped tensors, each
    product taken in ascending m, as the kernel forms them."""
    n = len(factors)
    one = torch.ones_like(factors[0])
    pre, suf = [], []
    for j in range(n):
        p = one
        for m in range(j):
            p = p * factors[m]
        pre.append(p)
        q = one
        for m in range(j + 1, n):
            q = q * factors[m]
        suf.append(q)
    return pre, suf


def rwkv6_chunked(r, k, v, w, u, state=None, chunk=64):
    """The chunked WKV kernel's arithmetic as plain PyTorch (tests only:
    the CPU path runs `rwkv6`, the card the kernel). Same arguments and
    results as `rwkv6`.

    Time is cut into chunks of `chunk` steps (the last padded with r = k =
    v = 0, w = 1) and each chunk into sub-chunks of 16. With lw =
    log2(max(w, 1e-38)), every exponent is a sum of lw over at most 16
    steps of one sub-chunk, taken from its start (Lp_t, the steps before t)
    or towards its end (Ls_s, the steps after s), so every factor is <= 1:
        q_t = r_t 2^Lp_t,   k~_s = k_s 2^Ls_s,   E_j = 2^(sum of lw over j).
    Decay across whole sub-chunks is a product of the E's. The chunk's
    matrix A (t, s):
      * diagonal 16x16 blocks: the exact ratio, a running product of the
        decays, sum_d r_td k_sd prod_{s<q<t} w_qd for s < t, the bonus
        r_t . (u k_t) at s = t, 0 above (nothing to mask: no exp);
      * block (J, I), I < J: q_J (k~_I prod_{I<m<J} E_m)^T.
    Then out = A v + (q_t prod_{m<J} E_m) S_in, and across chunks, in
    chunk order, S <- diag(prod_m E_m) S + sum_s (k~_s prod_{m>I} E_m)^T v_s.
    """
    b, h, s, hd = r.shape
    c = chunk
    nc = -(-s // c)
    pad = nc * c - s
    n = c // SUB
    f32, dev = torch.float32, r.device
    rf, kf, vf = (torch.nn.functional.pad(a.to(f32), (0, 0, 0, pad))
                  for a in (r, k, v))
    wf = torch.nn.functional.pad(w.to(f32), (0, 0, 0, pad), value=1.0)
    shape = (b, h, nc, n, SUB, hd)
    rf, kf, vf, wf = (a.reshape(shape) for a in (rf, kf, vf, wf))
    lw = torch.log2(torch.clamp_min(wf, 1e-38))
    acc = torch.zeros_like(lw[..., 0, :])
    lp = []
    for t in range(SUB):                      # exclusive prefix sums
        lp.append(acc)
        acc = acc + lw[..., t, :]
    total = acc                               # [b, h, nc, n, hd]
    acc = torch.zeros_like(total)
    ls = [None] * SUB
    for t in reversed(range(SUB)):            # exclusive suffix sums
        ls[t] = acc
        acc = acc + lw[..., t, :]
    q = rf * torch.exp2(torch.stack(lp, dim=-2))
    kt = kf * torch.exp2(torch.stack(ls, dim=-2))
    e = [torch.exp2(total[..., j, :]) for j in range(n)]
    pre, suf = _products(e)
    uf = u.to(f32)[None, :, None, None, None, :]

    # diagonal blocks: running products over t, every s at once
    kp = kf.clone()
    idx = torch.arange(SUB, device=dev)
    rows = []
    for t in range(SUB):
        coef = torch.where((idx == t)[:, None], kp * uf,
                           torch.where((idx < t)[:, None], kp, 0.0))
        rows.append(torch.einsum("...d,...sd->...s", rf[..., t, :], coef))
        kp = torch.where((idx < t)[:, None], kp * wf[..., t:t + 1, :], kp)
    diag = torch.stack(rows, dim=-2)          # [b, h, nc, n, t, s]

    a = torch.zeros((b, h, nc, c, c), dtype=f32, device=dev)
    for jb in range(n):
        sl = slice(SUB * jb, SUB * (jb + 1))
        a[..., sl, sl] = diag[..., jb, :, :]
        for ib in range(jb):
            mid = torch.ones_like(e[0])
            for m in range(ib + 1, jb):
                mid = mid * e[m]
            a[..., sl, SUB * ib:SUB * (ib + 1)] = torch.einsum(
                "...td,...sd->...ts", q[..., jb, :, :],
                kt[..., ib, :, :] * mid[..., None, :])
    vc = vf.reshape(b, h, nc, c, hd)
    intra = a @ vc
    rdec = torch.cat([q[..., j, :, :] * pre[j][..., None, :]
                      for j in range(n)], dim=-2)
    kdec = torch.cat([kt[..., j, :, :] * suf[j][..., None, :]
                      for j in range(n)], dim=-2)
    tot = pre[-1] * e[-1]                     # prod over every sub-chunk
    st = (torch.zeros((b, h, hd, hd), dtype=f32, device=dev)
          if state is None
          else state.to(f32))
    outs = []
    for ci in range(nc):
        outs.append(intra[:, :, ci] + rdec[:, :, ci] @ st)
        st = tot[:, :, ci, :, None] * st + kdec[:, :, ci].transpose(-1, -2) \
            @ vc[:, :, ci]
    return torch.cat(outs, dim=2)[:, :, :s], st


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


def rglru_gated(gate_a, gate_i, b_a, b_i, lamb, xa, h0=None):
    """The RG-LRU block's gate math and recurrence (the fused kernel's
    plain version): the block's ops in its order and roundings, then
    `rglru`.

    gate_a = xa @ W_a, gate_i = xa @ W_i and xa: [B, S, W] in the compute
    dtype; b_a, b_i, lamb: [W] in the same dtype; h0: f32 [B, W] (None:
    zeros), not modified. The gates and i * xa round to the compute dtype,
    the decay and the scale are f32:
        r = sigmoid(gate_a + b_a),  i = sigmoid(gate_i + b_i)
        a = exp(-8 softplus(lamb) r),  u = sqrt(max(1 - a^2, 1e-12)) (i xa)
    Returns (h [B, S, W] in xa's dtype, the final h [B, W] in f32).
    """
    r = torch.sigmoid(gate_a + b_a)
    i = torch.sigmoid(gate_i + b_i)
    log_a = -8.0 * torch.nn.functional.softplus(lamb.float()) * r.float()
    a = torch.exp(log_a)                                     # [B,S,W] in (0,1)
    gated = (i * xa).float()
    scale = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    out, final = rglru(a, scale * gated, h0)
    return out.to(xa.dtype), final


def rwkv6_bwd(r, k, v, w, u, state, dout, dstate=None):
    """The WKV recurrence's backward (the backward kernel's plain version),
    a reverse-time loop in f32. With G_t the gradient of the state after
    step t (G_{S-1} = dstate, None: zeros):

        dr_t = (S_{t-1} + diag(u) k_t^T v_t) do_t
        dk_t = G_t v_t + u * r_t (v_t . do_t)
        dv_t = k_t G_t + (r_t . (u * k_t)) do_t
        dw_t = rowsum(G_t * S_{t-1})
        du   = sum over b and t of r_t * k_t (v_t . do_t)
        G_{t-1} = diag(w_t) G_t + r_t^T do_t

    S_{t-1} comes from the forward recurrence run again from `state` (None:
    zeros), never from S_t by dividing by w_t (decays reach ~1e-30). du
    sums over t in reverse per batch row, then over the rows in order.
    Arguments as `rwkv6`, dout f32 [B, H, S, hd]. Returns (dr, dk, dv, dw
    [B, H, S, hd], du [H, hd], dstate_in = G_{-1} [B, H, hd, hd]), all f32.
    """
    b, h, s, hd = r.shape
    f32 = torch.float32
    rf, kf, vf, wf, dof = (a.to(f32) for a in (r, k, v, w, dout))
    uf = u.to(f32)
    st = (torch.zeros((b, h, hd, hd), dtype=f32, device=r.device)
          if state is None else state.to(f32))
    prev = []
    for t in range(s):
        prev.append(st)
        st = wf[:, :, t, :, None] * st \
            + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    g = (torch.zeros_like(st) if dstate is None else dstate.to(f32))
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((b, h, hd), dtype=f32, device=r.device)
    for t in reversed(range(s)):
        rt, kt, vt, wt, dot = (a[:, :, t] for a in (rf, kf, vf, wf, dof))
        vdo = (vt * dot).sum(-1, keepdim=True)                 # [b, h, 1]
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", prev[t], dot) \
            + uf * kt * vdo
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", g, vt) + uf * rt * vdo
        dv[:, :, t] = torch.einsum("bhi,bhij->bhj", kt, g) \
            + (rt * uf * kt).sum(-1, keepdim=True) * dot
        dw[:, :, t] = (g * prev[t]).sum(-1)
        du = du + rt * kt * vdo
        g = wt[..., None] * g + rt[..., None] * dot[:, :, None, :]
    return dr, dk, dv, dw, du.sum(0), g


def rglru_gated_bwd(gate_a, gate_i, b_a, b_i, lamb, xa, h0, dout,
                    dh_final=None):
    """The backward of `rglru_gated` (the backward kernel's plain version):
    the forward's gates, decay and scale made again in its roundings, h
    recomputed in f32 from h0 (None: zeros), then a reverse-time loop in
    f32, each op rounded alone:

        dh_t = dout_t + a_{t+1} dh_{t+1}   (dh_final, None: zeros, past S)
        da_t = dh_t h_{t-1},  du_t = dh_t,  dh0 = a_0 dh_0

    and back through u = sqrt(max(1 - a^2, 1e-12)) (i xa) (no gradient
    where the clamp binds), a = exp(-8 softplus(lamb) r) and the two
    sigmoids (their backward from the rounded outputs, g (1 - y) y).
    db_a, db_i and dlamb sum over t in reverse per batch row (dlamb's
    sum then times -8 softplus'(lamb)), then over the rows in order.
    Returns (dgate_a, dgate_i [B, S, W], db_a, db_i, dlamb [W], dxa [B, S,
    W], dh0 [B, W]), all f32.
    """
    b, s, w = xa.shape
    f32 = torch.float32
    r = torch.sigmoid(gate_a + b_a)
    i = torch.sigmoid(gate_i + b_i)
    lf = lamb.to(f32)
    neg = -8.0 * torch.nn.functional.softplus(lf)
    rf, i_f, xf = r.to(f32), i.to(f32), xa.to(f32)
    a = torch.exp(neg * rf)
    gated = (i * xa).to(f32)
    one_m = 1.0 - a * a
    scale = torch.sqrt(torch.clamp_min(one_m, 1e-12))
    hs, _ = rglru(a, scale * gated, h0)
    h_first = (torch.zeros((b, w), dtype=f32, device=xa.device)
               if h0 is None else h0.to(f32))
    h_prev = torch.cat([h_first[:, None], hs[:, :-1]], dim=1)
    dof = dout.to(f32)
    carry = (torch.zeros((b, w), dtype=f32, device=xa.device)
             if dh_final is None else dh_final.to(f32))
    dh = torch.empty_like(hs)
    for t in reversed(range(s)):
        dh[:, t] = dof[:, t] + carry
        carry = a[:, t] * dh[:, t]
    dgated = dh * scale
    dcl = dh * gated / (2.0 * scale)
    done = torch.where(one_m >= 1e-12, dcl, 0.0)
    da = dh * h_prev - 2.0 * (done * a)
    dlog = da * a
    dga = dlog * neg * (1.0 - rf) * rf
    di = dgated * xf
    dgi = di * (1.0 - i_f) * i_f
    dxa = dgated * i_f
    parts = [torch.zeros((b, w), dtype=f32, device=xa.device)
             for _ in range(3)]
    for t in reversed(range(s)):
        for p, x in zip(parts, (dga, dgi, dlog * rf)):
            p += x[:, t]
    dsoft = torch.where(lf > 20.0, 1.0, torch.sigmoid(lf))
    parts[2] = parts[2] * -8.0 * dsoft
    db_a, db_i, dlamb = (p.sum(0) for p in parts)
    return dga, dgi, db_a, db_i, dlamb, dxa, carry
