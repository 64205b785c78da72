"""Dispatch between the Hopper kernels and their plain versions.

A CUDA tensor goes to the kernel, which launches or raises; a CPU tensor
goes to the plain version in `ref`. Nothing else is accepted, and no
failure on the card falls back to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.decode_attention_paged import (
    decode_attention_paged_cuda, decode_attention_ring_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.prox_update import prox_update_cuda
from repro_torch.kernels.rglru_scan import rglru_scan_cuda
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda


def prox_update(x, g, zsum, *, tau, rho, num_walks, num_agents):
    """Fused gAPI-BCD update on one tensor of any shape.

    Returns (x_new in x.dtype, delta in f32) — see kernels/prox_update.py.
    """
    kw = dict(tau=tau, rho=rho, num_walks=num_walks, num_agents=num_agents)
    if x.device.type == "cuda":
        return prox_update_cuda(x, g, zsum, **kw)
    if x.device.type == "cpu":
        return ref.prox_update(x, g, zsum, **kw)
    raise ValueError(f"prox_update: no kernel for device {x.device}")


def prox_update_tree(xs, gs, zsums, *, tau, rho, num_walks, num_agents):
    """Dict version: returns (new_params, deltas), keyed like `xs`."""
    new, delta = {}, {}
    for k in xs:
        new[k], delta[k] = prox_update(xs[k], gs[k], zsums[k], tau=tau,
                                       rho=rho, num_walks=num_walks,
                                       num_agents=num_agents)
    return new, delta


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: [B,S,H,hd]; k, v: [B,T,KV,hd]. Returns [B,S,H,hd] in q's dtype
    (forward only: the TPU kernel has no backward either)."""
    kw = dict(causal=causal, window=window, scale=scale)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, **kw)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def decode_attention(q, k, v, *, lengths, scale=None):
    """q: [B,H,hd]; k, v: [B,T,KV,hd]; lengths: int32 [B] valid cache rows
    per batch row. Returns [B,H,hd] in q's dtype."""
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k, v, lengths=lengths, scale=scale)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, lengths=lengths, scale=scale)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")


def decode_attention_paged(q, k_pool, v_pool, block_tables, *, lengths,
                           scale=None):
    """q: [B,H,hd]; k_pool, v_pool: [NB,bs,KV,hd] (block 0 the null
    block); block_tables: int32 [B,W]; lengths: int32 [B] valid logical
    positions per row. Returns [B,H,hd] in q's dtype."""
    if q.device.type == "cuda":
        return decode_attention_paged_cuda(q, k_pool, v_pool, block_tables,
                                           lengths=lengths, scale=scale)
    if q.device.type == "cpu":
        return ref.decode_attention_paged(q, k_pool, v_pool, block_tables,
                                          lengths=lengths, scale=scale)
    raise ValueError(f"decode_attention_paged: no kernel for device "
                     f"{q.device}")


def decode_attention_ring(q, k_pool, v_pool, block_tables, *, ring_starts,
                          lengths, window, scale=None):
    """The sliding-window ring: ring block bi of row b is table entry
    (ring_starts[b] + bi) % W, and ring slots below min(lengths[b],
    window, W * bs) are valid. Shapes as `decode_attention_paged`;
    ring_starts int32 [B]."""
    kw = dict(ring_starts=ring_starts, lengths=lengths, window=window,
              scale=scale)
    if q.device.type == "cuda":
        return decode_attention_ring_cuda(q, k_pool, v_pool, block_tables,
                                          **kw)
    if q.device.type == "cpu":
        return ref.decode_attention_ring(q, k_pool, v_pool, block_tables,
                                         **kw)
    raise ValueError(f"decode_attention_ring: no kernel for device "
                     f"{q.device}")


def rwkv6_scan(r, k, v, w, u, state):
    """RWKV6 WKV recurrence. r, k, v: [B,H,S,hd] (f32 or bf16; any strides
    with a contiguous last dim); w: f32 decays of the same shape; u:
    [H,hd]; state: the incoming f32 [B,H,hd,hd].

    Returns (out [B,H,S,hd] in f32, state). `state` is overwritten with
    the final state, on both routes, so a layer's state advances where it
    lies in the cache."""
    if r.device.type == "cuda":
        return rwkv6_scan_cuda(r, k, v, w, u, state)
    if r.device.type == "cpu":
        out, final = ref.rwkv6(r, k, v, w, u, state)
        return out, state.copy_(final)
    raise ValueError(f"rwkv6_scan: no kernel for device {r.device}")


def rglru_scan(gate_a, gate_i, b_a, b_i, lamb, xa, state):
    """RG-LRU gate math and recurrence h_t = a_t * h_{t-1} + u_t, a and u
    made from the gate products as `ref.rglru_gated` states. gate_a =
    xa @ W_a, gate_i = xa @ W_i, xa: [B,S,W] (f32 or bf16; a contiguous
    last dim); b_a, b_i, lamb: [W] in xa's dtype; state: the incoming f32
    [B,W].

    Returns (out [B,S,W] in xa's dtype, state). `state` is overwritten
    with the final h, on both routes, so a slot's state advances where it
    lies in the arena."""
    args = (gate_a, gate_i, b_a, b_i, lamb, xa)
    if xa.device.type == "cuda":
        return rglru_scan_cuda(*args, state)
    if xa.device.type == "cpu":
        out, final = ref.rglru_gated(*args, state)
        return out, state.copy_(final)
    raise ValueError(f"rglru_scan: no kernel for device {xa.device}")
