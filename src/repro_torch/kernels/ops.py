"""Dispatch between the Hopper kernels and their plain versions.

A CUDA tensor goes to the kernel, which launches or raises; a CPU tensor
goes to the plain version in `ref`. A fake tensor
(`torch._subclasses.fake_tensor`, as the dry-run counts on) gets the
kernel's outputs, their shapes and dtypes, without running anything (a
recurrence's state advances in shape only), the abstract implementation
a custom op's `register_fake` would give. Nothing else is accepted, and
no failure on the card falls back to the plain version.

While a `utils.roofline.StepCost` is open (`costs.OPEN`), each call
records its `kernels.costs` entry there and pauses the count while the
kernel's wrapper or plain version runs, so a step counts the kernel's
work whatever runs it; with no count open that is one global lookup.

The two recurrences also have training routes (`rwkv6_scan_train`,
`rglru_scan_train`): `torch.autograd.Function`s whose forward is the
forward kernel from a fresh zero state and whose backward is the
hand-written backward kernel (the plain forward and backward on the CPU).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import costs, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.decode_attention_paged import (
    decode_attention_paged_cuda, decode_attention_ring_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.prox_update import prox_update_cuda
from repro_torch.kernels.rglru_scan import (rglru_scan_bwd_cuda,
                                            rglru_scan_cuda)
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_bwd_cuda,
                                            rwkv6_scan_cuda)


def _route(name, t):
    """"fake" for a fake tensor, "cuda" for the kernel, "cpu" for the
    plain version; raises for any other device."""
    if costs.is_fake(t):
        return "fake"
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"{name}: no kernel for device {t.device}")


def _counted(cost_fn, *args, **kwargs):
    """Record `cost_fn(*args, **kwargs)` in the open count and return a
    context that pauses it; a no-op context when no count is open."""
    count = costs.OPEN
    if count is None:
        return contextlib.nullcontext()
    count.record(cost_fn(*args, **kwargs))
    return count.paused()


def prox_update(x, g, zsum, *, tau, rho, num_walks, num_agents):
    """Fused gAPI-BCD update on one tensor of any shape.

    Returns (x_new in x.dtype, delta in f32) — see kernels/prox_update.py.
    """
    kw = dict(tau=tau, rho=rho, num_walks=num_walks, num_agents=num_agents)
    route = _route("prox_update", x)
    with _counted(costs.prox_update, x, g, zsum):
        if route == "fake":
            return x.new_empty(x.shape), x.new_empty(x.shape,
                                                     dtype=torch.float32)
        if route == "cuda":
            return prox_update_cuda(x, g, zsum, **kw)
        return ref.prox_update(x, g, zsum, **kw)


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
    route = _route("flash_attention", q)
    with _counted(costs.flash_attention, q, k, v, causal=causal,
                  window=window):
        if route == "fake":
            return q.new_empty(q.shape)
        if route == "cuda":
            return flash_attention_cuda(q, k, v, **kw)
        return ref.attention(q, k, v, **kw)


def decode_attention(q, k, v, *, lengths, scale=None):
    """q: [B,H,hd]; k, v: [B,T,KV,hd]; lengths: int32 [B] valid cache rows
    per batch row. Returns [B,H,hd] in q's dtype."""
    route = _route("decode_attention", q)
    with _counted(costs.decode_attention, q, k, v, lengths=lengths):
        if route == "fake":
            return q.new_empty(q.shape)
        if route == "cuda":
            return decode_attention_cuda(q, k, v, lengths=lengths,
                                         scale=scale)
        return ref.decode_attention(q, k, v, lengths=lengths, scale=scale)


def decode_attention_paged(q, k_pool, v_pool, block_tables, *, lengths,
                           scale=None):
    """q: [B,H,hd]; k_pool, v_pool: [NB,bs,KV,hd] (block 0 the null
    block); block_tables: int32 [B,W]; lengths: int32 [B] valid logical
    positions per row. Returns [B,H,hd] in q's dtype."""
    route = _route("decode_attention_paged", q)
    with _counted(costs.decode_attention_paged, q, k_pool, v_pool,
                  block_tables, lengths=lengths):
        if route == "fake":
            return q.new_empty(q.shape)
        if route == "cuda":
            return decode_attention_paged_cuda(q, k_pool, v_pool,
                                               block_tables, lengths=lengths,
                                               scale=scale)
        return ref.decode_attention_paged(q, k_pool, v_pool, block_tables,
                                          lengths=lengths, scale=scale)


def decode_attention_ring(q, k_pool, v_pool, block_tables, *, ring_starts,
                          lengths, window, scale=None):
    """The sliding-window ring: ring block bi of row b is table entry
    (ring_starts[b] + bi) % W, and ring slots below min(lengths[b],
    window, W * bs) are valid. Shapes as `decode_attention_paged`;
    ring_starts int32 [B]."""
    kw = dict(ring_starts=ring_starts, lengths=lengths, window=window,
              scale=scale)
    route = _route("decode_attention_ring", q)
    with _counted(costs.decode_attention_ring, q, k_pool, v_pool,
                  block_tables, lengths=lengths, window=window):
        if route == "fake":
            return q.new_empty(q.shape)
        if route == "cuda":
            return decode_attention_ring_cuda(q, k_pool, v_pool,
                                              block_tables, **kw)
        return ref.decode_attention_ring(q, k_pool, v_pool, block_tables,
                                         **kw)


def _wkv_out(r):
    """The kernel's f32 output for r [B,H,S,hd]: a [B,H,S,hd] view of a
    [B,S,H,hd] buffer (on a fake tensor, its shape only)."""
    b, h, s, hd = r.shape
    return r.new_empty((b, s, h, hd), dtype=torch.float32).transpose(1, 2)


def rwkv6_scan(r, k, v, w, u, state):
    """RWKV6 WKV recurrence. r, k, v: [B,H,S,hd] (f32 or bf16; any strides
    with a contiguous last dim); w: f32 decays of the same shape; u:
    [H,hd]; state: the incoming f32 [B,H,hd,hd].

    Returns (out [B,H,S,hd] in f32, state). `state` is overwritten with
    the final state, on both routes, so a layer's state advances where it
    lies in the cache."""
    route = _route("rwkv6_scan", r)
    with _counted(costs.rwkv6_scan, r, k, v, w, u, state):
        if route == "fake":
            return _wkv_out(r), state
        if route == "cuda":
            return rwkv6_scan_cuda(r, k, v, w, u, state)
        out, final = ref.rwkv6(r, k, v, w, u, state)
        return out, state.copy_(final)


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
    route = _route("rglru_scan", xa)
    with _counted(costs.rglru_scan, *args, state):
        if route == "fake":
            return xa.new_empty(xa.shape), state
        if route == "cuda":
            return rglru_scan_cuda(*args, state)
        out, final = ref.rglru_gated(*args, state)
        return out, state.copy_(final)


class RWKV6Scan(torch.autograd.Function):
    """The WKV recurrence from a zero state, differentiable in r, k, v, w
    and u. Forward: `rwkv6_scan_cuda` on a state allocated here (which it
    overwrites; nothing saved is written), or `ref.rwkv6`; backward:
    `rwkv6_scan_bwd_cuda` or `ref.rwkv6_bwd` from the saved inputs, each
    gradient returned in its input's dtype. A recompute (activation
    checkpointing) runs the same forward on the same inputs and gives the
    same output. Fake tensors get shapes, and a count records both
    kernels, as in `rwkv6_scan`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        b, h, _, hd = r.shape
        route = _route("rwkv6_scan_train", r)
        state = r.new_zeros((b, h, hd, hd), dtype=torch.float32)
        ctx.save_for_backward(r, k, v, w, u)
        with _counted(costs.rwkv6_scan, r, k, v, w, u, state):
            if route == "fake":
                return _wkv_out(r)
            if route == "cuda":
                return rwkv6_scan_cuda(r, k, v, w, u, state)[0]
            return ref.rwkv6(r, k, v, w, u, state)[0]

    @staticmethod
    def backward(ctx, dout):
        r, k, v, w, u = ctx.saved_tensors
        b, h, _, hd = r.shape
        route = _route("rwkv6_scan_train", r)
        state = r.new_zeros((b, h, hd, hd), dtype=torch.float32)
        dout = dout.float()
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        with _counted(costs.rwkv6_scan_bwd, r, k, v, w, u, state, dout):
            if route == "fake":
                grads = (_wkv_out(r),) * 4 + (
                    u.new_empty(u.shape, dtype=torch.float32),)
            elif route == "cuda":
                grads = rwkv6_scan_bwd_cuda(r, k, v, w, u, state, dout)
            else:
                grads = ref.rwkv6_bwd(r, k, v, w, u, state, dout)
        return tuple(g.to(x.dtype) for g, x in zip(grads, (r, k, v, w, u)))


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU gate math and recurrence from h_0 = 0, differentiable in
    every input. Forward: `rglru_scan_cuda` on a state allocated here, or
    `ref.rglru_gated`; backward: `rglru_scan_bwd_cuda` or
    `ref.rglru_gated_bwd`, each gradient in its input's dtype. Fake
    tensors get shapes, and a count records both kernels, as in
    `rglru_scan`."""

    @staticmethod
    def forward(ctx, gate_a, gate_i, b_a, b_i, lamb, xa):
        b, _, w = xa.shape
        args = (gate_a, gate_i, b_a, b_i, lamb, xa)
        route = _route("rglru_scan_train", xa)
        state = xa.new_zeros((b, w), dtype=torch.float32)
        ctx.save_for_backward(*args)
        with _counted(costs.rglru_scan, *args, state):
            if route == "fake":
                return xa.new_empty(xa.shape)
            if route == "cuda":
                return rglru_scan_cuda(*args, state)[0]
            return ref.rglru_gated(*args, state)[0]

    @staticmethod
    def backward(ctx, dout):
        args = ctx.saved_tensors
        xa = args[-1]
        route = _route("rglru_scan_train", xa)
        state = xa.new_zeros((xa.shape[0], xa.shape[2]), dtype=torch.float32)
        with _counted(costs.rglru_scan_bwd, *args, state, dout):
            if route == "fake":
                grads = tuple(x.new_empty(x.shape, dtype=torch.float32)
                              for x in args)
            elif route == "cuda":
                grads = rglru_scan_bwd_cuda(
                    *args, state, dout.to(xa.dtype).contiguous())
            else:
                grads = ref.rglru_gated_bwd(*args, state, dout)
        return tuple(g.to(x.dtype) for g, x in zip(grads, args))


def rwkv6_scan_train(r, k, v, w, u):
    """The WKV recurrence for training: `rwkv6_scan`'s arguments without a
    state (it starts from zero, as the reference's train mode does).
    Returns out [B,H,S,hd] in f32; autograd reaches r, k, v, w and u
    through the backward kernel."""
    return RWKV6Scan.apply(r, k, v, w, u)


def rglru_scan_train(gate_a, gate_i, b_a, b_i, lamb, xa):
    """The RG-LRU gate math and recurrence for training: `rglru_scan`'s
    arguments without a state (h_0 = 0). Returns h [B,S,W] in xa's dtype;
    autograd reaches every input through the backward kernel."""
    return RGLRUScan.apply(gate_a, gate_i, b_a, b_i, lamb, xa)
