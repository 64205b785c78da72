"""Mixture-of-Experts: top-k routing with GShard capacity dispatch, as
`repro/models/moe.py`.

Tokens are grouped (group = sequence). Routing is a product in x's dtype,
then an f32 softmax, the top k probabilities (ties to the lower expert,
as `jax.lax.top_k` breaks them: a stable descending sort, never
`torch.topk`), renormalised. Each (token, choice) slot takes the next
place in its (group, expert) bucket in token-major order; a bucket holds
`capacity(S)` = max(ceil(S k / E cf), 4) slots and the rest are dropped
(standard GShard semantics). The experts are swiglu MLPs stacked on a
leading E axis and run as one batched product over E.

The reference dispatches and combines with one-hot einsums (S E C D
multiply-adds each); the port computes the same function with gathers:
every bucket slot reads its token's row (an empty slot a zero row),
which a one-hot dispatch of one nonzero term computes bitwise, and every
token sums its k slots' outputs, weighted by their gates, in a fixed
order. Nothing accumulates through atomics, so a decode row gives the
same bits alone and batched and from one call to the next.

`moe_apply_scatter` is the reference's sort/scatter variant (one
capacity over all B S tokens of the batch), selected by
REPRO_MOE_SCATTER where the block is applied, as in the reference.

On a model axis (`axis`, a `dist.tensor_parallel.ModelAxis`) a rank
holds experts first … first + E_l - 1 of the stacked leaves (first =
the axis index times E_l, E_l the leaves' expert count) and the shared
experts' columns of d_ff. Routing, the bucket places and the drops run
over all E on every rank, as in one process, so every rank drops the
same slots; each rank fills and runs only its own experts' buckets (a
slot of another rank's expert is not sent and gives a zero output) and
makes its partial combine in f32, unrounded, adds to it the shared
experts' partial product in f32 (`ModelAxis.row_product`), and the
layer's output is that f32 partial summed over the axis in one `reduce`
and rounded once to x's dtype. One process rounds its f32 combine, its
shared product and their sum, each once: the axis rounds the layer's
output once, where one process rounds it three times (with shared
experts; once without). In f32 only the association of the adds
differs: one process adds a token's k weighted slot outputs in the
order of its choices, then the shared output; the axis adds each rank's
own slots in that order, its shared partial, then the ranks' partial
sums in the line's order. The tokens are one process's (the logits
within rounding).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _he


def moe_init(generator, lead, cfg, dtype):
    """The router [D, E], experts stacked on E (w_gate, w_up [E, D, F],
    w_down [E, F, D]) and, with num_shared_experts, the shared experts'
    "shared.w_gate", "shared.w_up" [D, F s], "shared.w_down" [F s, D],
    each with leading dims `lead`."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    p = {"router": _he(generator, lead + (d, e), dtype, d),
         "w_gate": _he(generator, lead + (e, d, f), dtype, d),
         "w_up": _he(generator, lead + (e, d, f), dtype, d),
         "w_down": _he(generator, lead + (e, f, d), dtype, f)}
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p["shared.w_gate"] = _he(generator, lead + (d, fs), dtype, d)
        p["shared.w_up"] = _he(generator, lead + (d, fs), dtype, d)
        p["shared.w_down"] = _he(generator, lead + (fs, d), dtype, fs)
    return p


def capacity(cfg, tokens):
    """Slots per (group, expert) bucket for a group of `tokens` tokens."""
    m = cfg.moe
    return max(int(math.ceil(tokens * m.top_k / m.num_experts
                             * m.capacity_factor)), 4)


def route(params, cfg, x):
    """x [..., D] -> (probs [..., E] f32, gate_w [..., k] f32, gate_i
    [..., k] int64): the softmax of the router's logits and its top k,
    renormalised; among equal probabilities the lower expert comes
    first."""
    probs = torch.softmax((x @ params["router"]).float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate_w, gate_i = vals[..., :k], idx[..., :k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, gate_w, gate_i


def _one_hot(idx, n):
    return idx[..., None] == torch.arange(n, device=idx.device)


def aux_loss(cfg, probs, gate_i):
    """The Switch-style load-balance loss: router_aux_loss * E * sum over
    experts of (mean choices a token) * (mean probability)."""
    e = cfg.moe.num_experts
    frac_tokens = _one_hot(gate_i, e).sum(-2).float().reshape(-1, e).mean(0)
    frac_probs = probs.reshape(-1, e).mean(0)
    return cfg.moe.router_aux_loss * e * torch.sum(frac_tokens * frac_probs)


def bucket_positions(gate_i, e):
    """gate_i [G, N, k] -> int64 [G, N, k]: each slot's place in its
    (group, expert) bucket, counting the group's slots in token-major
    order (the reference's cumsum of the expert one-hots)."""
    g, n, k = gate_i.shape
    flat = gate_i.reshape(g, n * k)
    ranks = torch.cumsum(_one_hot(flat, e).long(), dim=1)
    return (ranks.gather(-1, flat[..., None])[..., 0] - 1).reshape(g, n, k)


def _experts(params, cfg, xr, gate_i, pos, send, groups, cap, axis=None):
    """Dispatch, experts, and each slot's output.

    xr [T, D]: T tokens in `groups` groups of T / groups; gate_i, pos,
    send [T, k]: each slot's expert, bucket place, and whether its token
    goes there (kept, and for the grouped dispatch a nonzero gate). The
    leaves hold E_l experts from the axis index times E_l on (all of them
    without an axis). Their buckets are one buffer [E_l, groups * cap, D] filled
    by a gather (an empty slot reads a zero row); the experts run as
    batched products over E_l. Returns y [T, k, D]: each slot's expert
    output, zero where the slot was dropped (pos >= cap) or its expert
    is not among the leaves'."""
    t, d = xr.shape
    k = gate_i.shape[1]
    e = params["w_gate"].shape[0]
    first = 0 if axis is None else axis.index * e
    dev = xr.device
    rows = e * groups * cap
    group = torch.arange(t, device=dev) // (t // groups)
    own = (gate_i >= first) & (gate_i < first + e)
    slot = (gate_i - first) * (groups * cap) + group[:, None] * cap + pos
    # dropped or another rank's: the spare row
    slot = torch.where((pos < cap) & own, slot, rows)
    src = torch.full((rows + 1,), t, dtype=torch.long, device=dev)
    # every kept slot owns its bucket row; only the spare row repeats
    src.scatter_(0, torch.where(send & own, slot, rows).reshape(-1),
                 torch.arange(t * k, device=dev) // k)
    buf = torch.cat([xr, xr.new_zeros(1, d)])[src[:rows]].view(
        e, groups * cap, d)
    h = (F.silu(torch.bmm(buf, params["w_gate"]))
         * torch.bmm(buf, params["w_up"]))
    y = torch.bmm(h, params["w_down"]).reshape(rows, d)
    return torch.cat([y, y.new_zeros(1, d)])[slot]


def _shared(params, cfg, xr, product=torch.matmul):
    """The shared experts' output for xr [T, D] (`product` their down
    projection: a rank's partial one on a model axis), or None."""
    if not cfg.moe.num_shared_experts:
        return None
    hs = (F.silu(xr @ params["shared.w_gate"])
          * (xr @ params["shared.w_up"]))
    return product(hs, params["shared.w_down"])


def _finish(params, cfg, xr, combine, dtype, axis):
    """The layer's output [T, D] in `dtype` from the routed combine:
    without an axis `combine` is the whole one (rounded or not), rounded
    to `dtype`, plus the shared experts' output; on a model axis it is
    the rank's f32 partial, plus the shared experts' f32 partial product,
    summed over the axis in one `reduce` and rounded once."""
    if axis is None:
        out = combine.to(dtype)
        shared = _shared(params, cfg, xr)
        return out if shared is None else out + shared
    shared = _shared(params, cfg, xr, axis.row_product)
    partial = combine if shared is None else combine + shared
    return axis.reduce(partial).to(dtype)


def moe_apply(params, cfg, x, with_aux=True, axis=None):
    """x [B, S, D] -> (out [B, S, D], aux: the load-balance loss, or None
    without `with_aux`). Groups are sequences (capacity from S); a token's
    k slot outputs are summed in f32 in the order of its choices, each
    weighted by its gate cast to x's dtype, and rounded once to x's
    dtype. axis: a model axis whose rank holds its experts' leaves (see
    the module's docstring); the output is the whole layer's on every
    rank."""
    b, s, d = x.shape
    m = cfg.moe
    k = m.top_k
    probs, gate_w, gate_i = route(params, cfg, x)
    aux = aux_loss(cfg, probs, gate_i) if with_aux else None
    cap = capacity(cfg, s)
    pos = bucket_positions(gate_i, m.num_experts).reshape(b * s, k)
    gate_w, gate_i = gate_w.reshape(b * s, k), gate_i.reshape(b * s, k)
    send = (pos < cap) & (gate_w > 0)
    xr = x.reshape(b * s, d)
    y = _experts(params, cfg, xr, gate_i, pos, send, b, cap, axis)
    w = gate_w.to(x.dtype).float()
    out = y[:, 0].float() * w[:, :1]
    for j in range(1, k):
        out = out + y[:, j].float() * w[:, j:j + 1]
    out = _finish(params, cfg, xr, out, x.dtype, axis)
    return out.reshape(b, s, d), aux


def moe_apply_scatter(params, cfg, x, with_aux=True, axis=None):
    """The reference's sort/scatter dispatch: x [B, S, D] -> (out, aux),
    one capacity over all T = B S tokens. Slots are sorted by expert
    (stably, as `jnp.argsort`), a slot's place is its rank in its
    expert's run, places past capacity are dropped; the scatter-add into
    out is k adds in x's dtype, in the order of each token's choices,
    of the slot outputs times their gates in x's dtype. On a model axis
    (`moe_apply`'s) a rank adds its own slots' products in f32 and the
    sum over the axis is rounded once: one process's k roundings in x's
    dtype are not repeated there (bitwise equal in f32 but for the
    association)."""
    b, s, d = x.shape
    t = b * s
    m = cfg.moe
    k, e = m.top_k, m.num_experts
    xr = x.reshape(t, d)
    probs, gate_w, gate_i = route(params, cfg, xr)
    aux = aux_loss(cfg, probs, gate_i) if with_aux else None
    cap = capacity(cfg, t)
    e_flat = gate_i.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    counts = _one_hot(e_flat, e).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(t * k, device=x.device) - starts[e_flat[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    pos = pos.reshape(t, k)
    y = _experts(params, cfg, xr, gate_i, pos, pos < cap, 1, cap, axis)
    yw = y * gate_w.to(x.dtype)[..., None]
    if axis is not None:
        yw = yw.float()
    out = yw[:, 0]
    for j in range(1, k):
        out = out + yw[:, j]
    out = _finish(params, cfg, xr, out, x.dtype, axis)
    return out.reshape(b, s, d), aux
