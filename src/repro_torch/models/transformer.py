"""Decoder-only transformer (dense GQA or MLA, MoE, RWKV6 and RG-LRU
hybrid stacks): init, train forward and loss, and the serving entry points
(prefill, decode, the slot arena and the paged pool).

The stack is a program of segments, as the reference builds it
(`build_segments`): each run of consecutive layers of one kind ("attn",
"moe", "rwkv" or "rglru") is one segment whose layers are stacked on a
leading [count] axis; the forward pass loops over segments and layers in
Python where the reference scans. recurrentgemma-2b's (rglru, rglru,
attn) pattern over 26 layers makes 17 segments; qwen2, dbrx and rwkv6
make one. A "moe" layer is the attention block with the mixture of
experts (`models.moe`) in place of its MLP; its load-balance loss is
summed over the layers into `train_loss`, and serving drops it. With
`cfg.mla` set, the attention of every "attn" and "moe" layer is MLA
(`attention.mla_*`: deepseek-v2-236b, or a dense MLA stack). Every block
kind and the final norm take `cfg.norm_type` (rmsnorm or layernorm). A
VLM (phi-3-vision) passes its patch embeddings in the batch
("patches"), in front of the text, to `train_loss` (whose loss skips
them) and `prefill`.

Parameters are one flat dict keyed by the reference pytree's paths
("embed.table", "segments.0.attn.wq", "segments.0.moe.w_gate",
"segments.3.rnn.w_x", "final_norm.scale", ...), with each segment's
leaves stacked [count, ...].

Caches are a list of per-segment dicts, as the reference's list is, with
the same leaves: an attention (or MoE) segment's {"k", "v": [count, B,
T, KV, hd], "ptr"} (a ring of capacity T = min(seq_len, window) with a
sliding window), or with MLA attention its latents {"ckv": [count, B, T,
r], "kpe": [count, B, T, rope], "ptr"}, an RWKV6 segment's {"shift",
"cm_shift": [count, B, D], "wkv": [count, B, H, hd, hd]} and an RG-LRU
segment's {"conv": [count, B, cw - 1, W], "h": [count, B, W]} (recurrent
state in f32). `ptr` counts the tokens
written: int32 [count] for a cache from `init_cache` (every row at one
depth) and [count, B] for the slot arena (`init_arena`, every row at its
own depth). A paged pool (`init_pool`, attention stacks only) is a list of
{"k", "v": [count, NB + 1, bs, KV, hd]} (MLA: {"ckv": [count, NB + 1,
bs, r], "kpe": [count, NB + 1, bs, rope]}) shared by every row, with block
0 the null block; block tables say which blocks a row owns. The port
updates caches and pools in place where the reference returns new
(donated) buffers.
"""
from __future__ import annotations

import os

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.layers import (
    _he, embed, embedding_init, make_norm, mlp_hidden, mlp_init,
    unembed,
)

# the layer kinds the port runs
KINDS = ("attn", "moe", "rwkv", "rglru")


def build_segments(layer_types):
    """[(kind, count), ...] for the runs of consecutive equal layer types."""
    segs = []
    for t in layer_types:
        if segs and segs[-1][0] == t:
            segs[-1][1] += 1
        else:
            segs.append([t, 1])
    return [(k, c) for k, c in segs]


def segments(cfg):
    """The stack's segments; raises for a layer kind the port does not
    run."""
    segs = build_segments(cfg.layer_types)
    unknown = sorted({k for k, _ in segs} - set(KINDS))
    if unknown:
        raise NotImplementedError(f"{cfg.name}: layer types {unknown} are "
                                  f"not among the port's {KINDS}")
    return segs


def subtree(params, prefix):
    """The leaves under `prefix.`, keyed by the rest of their path."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _layers(params, si, count):
    """Per-layer parameters of segment `si` (`stacked_layers`)."""
    return stacked_layers(params, f"segments.{si}", count)


def stacked_layers(params, prefix, count):
    """Per-layer parameters of the `count` layers stacked under `prefix`
    [{"ln1": {...}, "attn": {...}, ...}, ...]; a leaf's key below its
    group keeps its dots ("mix" -> "mu.r").

    Each stacked leaf is unbound once: indexing it once per layer would
    make the backward pass build a zero [count, ...] gradient for every
    layer (O(L^2) memory traffic), where unbind's backward is one stack.
    """
    prefix = prefix + "."
    layers = [{} for _ in range(count)]
    for key, v in params.items():
        if key.startswith(prefix):
            group, leaf = key[len(prefix):].split(".", 1)
            for lp, v_i in zip(layers, v.unbind(0)):
                lp.setdefault(group, {})[leaf] = v_i
    return layers


def _flat(prefix, tree):
    return {f"{prefix}.{k}": v for k, v in tree.items()}


def block_init(generator, lead, cfg, kind, dtype):
    """One segment's parameters, keyed "ln1.scale", "attn.wq", ... with
    leading dims `lead`, as the reference's `block_init` for `kind`."""
    d = cfg.d_model
    dev = generator.device
    norm_init, _ = make_norm(cfg.norm_type)
    p = _flat("ln1", norm_init(lead + (d,), dtype, dev))
    if kind in ("attn", "moe"):
        init = A.mla_init if cfg.mla is not None else A.gqa_init
        p.update(_flat("attn", init(generator, lead, cfg, dtype)))
    elif kind == "rwkv":
        p.update(_flat("mix", RW.rwkv_init(generator, lead, cfg, dtype)))
    else:
        p.update(_flat("rnn", RG.rglru_init(generator, lead, cfg, dtype)))
    p.update(_flat("ln2", norm_init(lead + (d,), dtype, dev)))
    if kind == "moe":
        p.update(_flat("moe", MOE.moe_init(generator, lead, cfg, dtype)))
    elif kind != "rwkv":
        p.update(_flat("mlp", mlp_init(generator, lead, d, cfg.d_ff, dtype,
                                       cfg.mlp_type)))
    return p


def transformer_init(cfg, generator, dtype=None):
    """Random parameters on the generator's device, with the reference's
    shapes and scales (embedding x0.02, He-scaled projections, zero biases,
    unit norm scales)."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    dev = generator.device
    d = cfg.d_model
    params = _flat("embed", embedding_init(generator, cfg.vocab_size, d,
                                           dtype))
    for si, (kind, count) in enumerate(segments(cfg)):
        params.update(_flat(f"segments.{si}",
                            block_init(generator, (count,), cfg, kind,
                                       dtype)))
    params.update(_flat("final_norm",
                        make_norm(cfg.norm_type)[0]((d,), dtype, dev)))
    if not cfg.tie_embeddings:
        params["head"] = _he(generator, (d, cfg.vocab_size), dtype, d)
    return params


def forward(cfg, params, x, *, positions, mode="train", caches=None,
            paged=None, window=0, remat=False, axis=None):
    """Run the stack on embeddings x [B,S,D]. Returns (the final-normed x,
    aux): aux sums the MoE layers' load-balance losses in "train" mode,
    and is None in the others or without MoE layers.

    mode "train": no cache (recurrent layers start from a zero state and
    keep none); with `remat`, each layer's block, of every kind, runs
    under non-reentrant `torch.utils.checkpoint` (activation checkpointing
    per block, as the reference's `jax.checkpoint` in `_segment_apply`),
    so backward keeps one [B,S,D] input a layer and recomputes the rest.
    "prefill": fills `caches` (from `init_cache`,
    batch B) with the prompt's K/V, ring-ordered, and sets each attention
    layer's ptr to S; recurrent layers run from their state in `caches`
    and leave their new state there. "decode": x is one token per row;
    inserts its K/V into `caches` at ptr, attends, and advances ptr.
    Caches are updated in place. `window` (> 0) is the sliding window of
    the prefill attention and of the paged ring; decode attends to the
    whole ring, whose capacity the window caps.

    paged (with `caches` a pool from `init_pool`, as in the reference's
    `block_apply`): for "prefill" {"table": int [W], "ctx_len": int,
    "valid": int}, one chunk of one slot through `gqa_prefill_paged`; for
    "decode" {"tables": int32 [B, W], "lengths": int32 [B]}, through
    `gqa_decode_paged`. An MLA config (`cfg.mla`) takes the `mla_*`
    function of each mode, and its caches hold the latents.

    axis: a `dist.tensor_parallel.ModelAxis` where this rank runs its
    slice of the heads and of d_ff (`cfg` is then its `local_config`):
    the partial products of `wo` and `w_down` (`ModelAxis.row_product`)
    are summed over the axis before each residual add, and the normed
    inputs of q/k/v and of gate/up pass through `ModelAxis.copy`, whose
    backward sums their gradients over the axis. An MLA layer runs the
    rank's heads over the whole latents; an MoE layer the rank's experts
    (`moe_apply(axis=)`, which sums its output over the axis); an RWKV6
    layer the rank's heads (`wo` and the channel mix's `cm_wv` summed)
    and an RG-LRU layer the rank's channels (`w_out` and its MLP's
    `w_down` summed), each over its rank's recurrent state. None runs
    the whole model.
    """
    aux = None
    for si, (kind, count) in enumerate(segments(cfg)):
        seg = None if caches is None else caches[si]
        if kind in ("rwkv", "rglru") and (seg is None) != (mode == "train"):
            raise ValueError(f"{kind} layers run with a cache in 'prefill' "
                             f"or 'decode' mode and without one in 'train' "
                             f"mode, not in {mode!r} with "
                             f"{'none' if seg is None else 'one'}")
        for i, lp in enumerate(_layers(params, si, count)):
            if kind in ("attn", "moe"):
                args = (_attn_block, cfg, lp, x, positions, mode, seg, i,
                        paged, window, axis)
            elif kind == "rwkv":
                args = (_rwkv_block, cfg, lp, x, seg, i, axis)
            else:
                args = (_rglru_block, cfg, lp, x, seg, i, axis)
            if remat and mode == "train":
                x = checkpoint(*args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = args[0](*args[1:])
            if kind == "moe":
                x, layer_aux = x
                if layer_aux is not None:
                    aux = layer_aux if aux is None else aux + layer_aux
    _, norm = make_norm(cfg.norm_type)
    return norm(subtree(params, "final_norm"), x), aux


def _attn_block(cfg, lp, x, positions, mode, seg, i, paged, window,
                axis=None):
    """norm -> attention -> norm -> MLP, as the reference's `block_apply`
    kind "attn" (the norm `cfg.norm_type`, as in every block kind and
    the final norm); layer i of the segment's cache `seg`. MLA
    (`cfg.mla`) runs the `mla_*` function of each mode. A "moe" layer
    (parameters under "moe") runs the mixture of experts in place of the
    MLP, `moe_apply_scatter` when REPRO_MOE_SCATTER is set (read here, as
    the reference reads it), and returns (x, aux), aux its load-balance
    loss in "train" mode and None otherwise."""
    _, norm = make_norm(cfg.norm_type)
    h = _copy(axis, norm(lp["ln1"], x))
    mla = cfg.mla is not None
    names = tuple(_entry_shapes(cfg))
    product = _product(axis)
    if paged is not None:
        layer = {name: seg[name][i] for name in names}
        if mode == "prefill" and mla:
            attn_out, _ = A.mla_prefill_paged(
                lp["attn"], cfg, h, layer, paged["table"], paged["ctx_len"],
                product=product)
        elif mode == "prefill":
            attn_out, _ = A.gqa_prefill_paged(
                lp["attn"], cfg, h, layer, paged["table"], paged["ctx_len"],
                window=window, valid=paged["valid"], product=product)
        elif mla:
            attn_out, _ = A.mla_decode_paged(
                lp["attn"], cfg, h, layer, paged["tables"], paged["lengths"],
                product=product)
        else:
            attn_out, _ = A.gqa_decode_paged(
                lp["attn"], cfg, h, layer, paged["tables"], paged["lengths"],
                window=window, product=product)
    elif mode == "decode":
        layer = {name: seg[name][i] for name in names + ("ptr",)}
        if mla:
            attn_out, _ = A.mla_decode(lp["attn"], cfg, h, layer, positions,
                                       product=product)
        else:
            attn_out, _ = A.gqa_decode(lp["attn"], cfg, h, layer, positions,
                                       product=product)
    else:
        if mla:     # ignores the window, as the reference's mla_prefill
            attn_out, entries = A.mla_prefill(lp["attn"], cfg, h, positions,
                                              product=product)
        else:
            attn_out, entries = A.gqa_prefill(lp["attn"], cfg, h, positions,
                                              kernel=mode == "prefill",
                                              window=window, product=product)
        if mode == "prefill":
            s, t = x.shape[1], seg[names[0]].shape[2]
            for name, e in zip(names, entries):
                seg[name][i].copy_(A.prefill_cache_entries(e, t, s))
            seg["ptr"][i].fill_(s)
    x = x + _reduce(axis, attn_out, x.dtype)
    h2 = _copy(axis, norm(lp["ln2"], x))
    if "moe" in lp:
        moe_fn = (MOE.moe_apply_scatter if os.environ.get("REPRO_MOE_SCATTER")
                  else MOE.moe_apply)
        ff, aux = moe_fn(lp["moe"], cfg, h2, with_aux=mode == "train",
                         axis=axis)
        return x + ff, aux
    return x + _reduce(axis, product(mlp_hidden(lp["mlp"], h2, cfg.mlp_type),
                                     lp["mlp"]["w_down"]), x.dtype)


def _product(axis):
    """The row-parallel products' function: `ModelAxis.row_product` on a
    model axis, the plain product without one."""
    return torch.matmul if axis is None else axis.row_product


def _reduce(axis, x, dtype):
    """A row-parallel product x summed over the model axis (`ModelAxis.
    reduce`: the ranks' partial products, in f32) and rounded once to the
    activation dtype `dtype`; x itself without an axis."""
    return x if axis is None else axis.reduce(x).to(dtype)


def _copy(axis, x):
    """x as the replicated input of a column-parallel product: on a model
    axis `ModelAxis.copy` (its gradient summed over the axis), else x."""
    return x if axis is None else axis.copy(x)


def _rwkv_block(cfg, lp, x, seg, i, axis=None):
    """norm -> time_mix -> norm -> channel_mix, as the reference's
    `block_apply` kind "rwkv". The WKV state advances in place in the
    cache; the shifts are copied in. With no cache (training) the layer
    starts from zeros and keeps no state. Positions are unused. `axis`
    as `forward`'s: both mixes sum their row-parallel products."""
    state = None if seg is None else {name: seg[name][i]
                                      for name in RW.LEAVES}
    _, norm = make_norm(cfg.norm_type)
    h = norm(lp["ln1"], x)
    tm_out, state = RW.time_mix(lp["mix"], cfg, h, state, axis)
    x = x + tm_out
    h2 = norm(lp["ln2"], x)
    cm_out, state = RW.channel_mix(lp["mix"], cfg, h2, state, axis)
    if seg is not None:
        for name in ("shift", "cm_shift"):
            seg[name][i].copy_(state[name])
    return x + cm_out


def _rglru_block(cfg, lp, x, seg, i, axis=None):
    """norm -> RG-LRU block -> norm -> MLP, as the reference's
    `block_apply` kind "rglru". `h` advances in place in the cache and
    the conv's last inputs are copied in; with no cache (training) the
    layer starts from zeros and keeps no state. Positions are unused.
    `axis` as `forward`'s: `w_out` and the MLP's `w_down` are summed
    over it, as the dense layer's `wo` and `w_down`."""
    state = None if seg is None else {name: seg[name][i]
                                      for name in RG.LEAVES}
    _, norm = make_norm(cfg.norm_type)
    h = norm(lp["ln1"], x)
    rnn_out, _ = RG.rglru_block(lp["rnn"], cfg, h, state, axis)
    x = x + rnn_out
    h2 = norm(lp["ln2"], x)
    return x + _reduce(axis, _product(axis)(
        mlp_hidden(lp["mlp"], h2, cfg.mlp_type), lp["mlp"]["w_down"]),
        x.dtype)


def logits_fn(cfg, params, x):
    if cfg.tie_embeddings:
        return unembed(subtree(params, "embed"), x)
    return x @ params["head"]


def _cast(cfg, params):
    cd = getattr(torch, cfg.compute_dtype)
    return {k: v.to(cd) if v.is_floating_point() else v
            for k, v in params.items()}


def _prefix(x, batch):
    """x [B,S,D] behind the batch's patch embeddings [B,P,D] (the VLM's
    stub frontend; cast to x's dtype), and P (0 without patches)."""
    patches = batch.get("patches")
    if patches is None:
        return x, 0
    return torch.cat([patches.to(x.dtype), x], dim=1), patches.shape[1]


def train_loss(cfg, params, batch, window=0, remat=True, axis=None):
    """batch: {tokens [B,S], targets [B,S], loss_mask [B,S] (optional),
    patches [B,P,D] (optional: a VLM's prefix, which the loss skips)}.

    Returns (loss, metrics). Every float parameter, the embedding table
    included, is cast to the compute dtype first; the logits come from a
    compute-dtype product and are cast to f32 for the cross-entropy.
    window: the sliding window of every attention layer (0: the
    config's own); remat: checkpoint each layer's activations (see
    `forward`), the reference's default.

    axis: a `dist.tensor_parallel.ModelAxis` where `params` are this
    rank's piece (`tensor_parallel.shard_params`) and `cfg` its
    `local_config`: the lookup is vocabulary-parallel, the stack sums
    over the axis (`forward`), the head gives the rank's vocabulary
    slice of the logits and `ModelAxis.nll` the cross-entropy over every
    slice; the loss is the whole model's on every rank, and each leaf's
    gradient the rank's piece of the whole one. MoE and MLA layers on an
    axis serve only: they raise here (`tensor_parallel.check_trainable`).
    """
    if axis is not None:
        from repro_torch.dist.tensor_parallel import check_trainable

        check_trainable(cfg)
        params = axis.replicate(params)
    params = _cast(cfg, params)
    tokens = batch["tokens"]
    if axis is None:
        x = embed(subtree(params, "embed"), tokens)
    else:
        x = axis.embed(params["embed.table"], tokens)
    x, n_prefix = _prefix(x, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, aux = forward(cfg, params, x, positions=positions, window=window,
                     remat=remat, axis=axis)
    x = x[:, n_prefix:]
    if axis is None:
        logits = logits_fn(cfg, params, x).float()
        m = logits.amax(dim=-1).detach()
        logz = m + torch.log(torch.sum(torch.exp(logits - m[..., None]),
                                       dim=-1))
        gold = torch.gather(logits, -1,
                            batch["targets"].long()[..., None])[..., 0]
        nll = logz - gold
    else:
        nll = axis.nll(logits_fn(cfg, params, axis.copy(x)).float(),
                       batch["targets"])
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        mask = mask.float()
        loss = torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, seq_len, dtype=torch.bfloat16, device=None,
               window=0, parts=1):
    """Zero per-segment caches for decode. Each attention segment's ring
    holds min(seq_len, window) rows, the config's sliding window first,
    else the `window` override; a recurrent segment's cache is its f32
    state, whatever `seq_len` and `dtype` (as in the reference). parts:
    the model axis's size where `cfg` is a rank's `local_config` (its
    recurrent state holds the rank's RWKV heads or RG-LRU channels; the
    attention entries follow the config's kv heads)."""
    win = cfg.attn_window or window
    cap = max(min(seq_len, win) if win else seq_len, 1)
    caches = []
    for kind, count in segments(cfg):
        if kind == "rwkv":
            caches.append(RW.init_state(cfg, batch, lead=(count,),
                                        device=device, parts=parts))
        elif kind == "rglru":
            caches.append(RG.init_state(cfg, batch, lead=(count,),
                                        device=device, parts=parts))
        else:
            seg = {name: torch.zeros((count, batch, cap) + shape,
                                     dtype=dtype, device=device)
                   for name, shape in _entry_shapes(cfg).items()}
            seg["ptr"] = torch.zeros((count,), dtype=torch.int32,
                                     device=device)
            caches.append(seg)
    return caches


def _entry_shapes(cfg):
    """An attention layer's cache leaves, {name: the shape of one token's
    entry}: MLA's latents {"ckv": (r,), "kpe": (rope,)}, else {"k", "v":
    (KV, hd)}."""
    if cfg.mla is not None:
        return {"ckv": (cfg.mla.kv_lora_rank,),
                "kpe": (cfg.mla.qk_rope_head_dim,)}
    kv = (cfg.num_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def _whole_vocab(cfg, params, axis):
    """Whether this rank's embedding table is the whole vocabulary: off a
    model axis, or on one that does not divide it."""
    return axis is None or params["embed.table"].shape[0] == cfg.vocab_size


def _embed_tokens(cfg, params, tokens, axis=None):
    """The tokens' embeddings in the compute dtype; on a model axis the
    vocabulary-parallel lookup of this rank's table rows
    (`ModelAxis.embed`), or the local lookup where the axis keeps the
    table whole."""
    if _whole_vocab(cfg, params, axis):
        x = embed(subtree(params, "embed"), tokens)
    else:
        x = axis.embed(params["embed.table"], tokens)
    return x.to(getattr(torch, cfg.compute_dtype))


def _greedy(axis, logits, cfg):
    """The int32 argmax of logits [..., V] over their last dim; on a model
    axis (logits: this rank's vocabulary slice) `ModelAxis.argmax`, the
    same ids on every rank. Whole logits (an axis that does not divide
    the vocabulary) take the local argmax: every rank computes the same
    ones."""
    if axis is None or logits.shape[-1] == cfg.vocab_size:
        return torch.argmax(logits, -1).to(torch.int32)
    return axis.argmax(logits)


def prefill(cfg, params, batch, cache_dtype=torch.bfloat16, cache_len=None,
            window=0, axis=None):
    """Build caches from a full prompt batch {"tokens": [B,S], "patches":
    [B,P,D] (optional: a VLM's prefix, in front of the text)}. Returns
    (logits of the last position [B,1,V] in f32, caches).

    cache_len: total cache capacity (>= P + prompt length) to leave room
    for later decode steps; defaults to P + the prompt length."""
    params = _cast(cfg, params)
    x, _ = _prefix(_embed_tokens(cfg, params, batch["tokens"], axis), batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    caches = init_cache(cfg, b, max(cache_len or s, s), dtype=cache_dtype,
                        device=x.device, window=window)
    x, _ = forward(cfg, params, x, positions=positions, mode="prefill",
                   caches=caches, window=window, axis=axis)
    return logits_fn(cfg, params, x[:, -1:]).float(), caches


def decode_step(cfg, params, token, caches, position, window=0, axis=None):
    """token: [B,1] int; position: the absolute position of every row
    (int or 0-dim tensor). Returns (logits [B,1,V] in f32, caches)."""
    params = _cast(cfg, params)
    x = _embed_tokens(cfg, params, token, axis)
    b = x.shape[0]
    positions = torch.as_tensor(position, dtype=torch.int32,
                                device=x.device).reshape(1, 1).expand(b, 1)
    x, _ = forward(cfg, params, x, positions=positions, mode="decode",
                   caches=caches, window=window, axis=axis)
    return logits_fn(cfg, params, x).float(), caches


# The slot arena (continuous batching, `repro_torch.serve`): the caches of
# `slots` independent in-flight requests, with ptr per row ([count, slots])
# so every slot decodes at its own depth. Admission prefills ONE request
# (batch-1 forward) straight into its slot's rows between decode steps;
# the decode step runs all slots with per-row positions.


def init_arena(cfg, slots, capacity, dtype=torch.bfloat16, device=None,
               window=0, parts=1):
    """Slot-arena caches: `init_cache` with per-row ptr [count, slots] in
    every attention segment (a recurrent state has no ptr)."""
    arena = init_cache(cfg, slots, capacity, dtype=dtype, device=device,
                       window=window, parts=parts)
    for seg in arena:
        if "ptr" in seg:
            seg["ptr"] = torch.zeros(seg["ptr"].shape + (slots,),
                                     dtype=torch.int32, device=device)
    return arena


def prefill_into_slot(cfg, params, tokens, length, slot, caches, window=0,
                      axis=None):
    """Admit one request into arena slot `slot` between decode steps.

    tokens: [1, Sp] int, right-padded to a bucketed length Sp (causal
    attention keeps positions < length from seeing the pads, and the
    slot's validity length is `length`; a recurrent stack folds every
    token into its state, and a sliding-window ring would let pads evict
    real context, so their prompts come at their exact length); length:
    the true prompt length; slot: the arena row to overwrite; caches: the
    arena from `init_arena`. The prefill writes the slot's whole cache
    rows (zeros past the prompt; a prompt longer than a windowed ring
    wraps, slot i % T holding token i) through views of the arena, and
    sets its ptr to `length` (the tokens actually in the cache); every
    recurrent leaf of the slot is zeroed first, so the request does not
    start from its slot's previous occupant. Returns (logits [1,1,V] in
    f32 at position length - 1, the arena, updated in place)."""
    params = _cast(cfg, params)
    x = _embed_tokens(cfg, params, tokens, axis)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None]
    slot, length = int(slot), int(length)
    rows = []
    for seg in caches:
        row = {name: leaf[:, slot:slot + 1] for name, leaf in seg.items()
               if name != "ptr"}
        if "ptr" in seg:
            row["ptr"] = seg["ptr"][:, slot]
        else:
            for leaf in row.values():
                leaf.zero_()
        rows.append(row)
    x, _ = forward(cfg, params, x, positions=positions, mode="prefill",
                   caches=rows, window=window, axis=axis)
    for row in rows:
        if "ptr" in row:
            row["ptr"].fill_(length)
    logits = logits_fn(cfg, params, x[:, length - 1:length]).float()
    return logits, caches


def decode_rows(cfg, params, token, caches, positions, window=0, axis=None):
    """One decode step over all arena slots.

    token: [B,1] int (one current token per slot); positions: int [B],
    the absolute positions (== tokens already in each slot's cache). Dead
    slots compute garbage that the engine ignores; their cache rows are
    overwritten whole at the next admission. Returns (logits [B,1,V] in
    f32, the arena, updated in place)."""
    params = _cast(cfg, params)
    x = _embed_tokens(cfg, params, token, axis)
    b = x.shape[0]
    positions = torch.as_tensor(positions, dtype=torch.int32,
                                device=x.device).reshape(b, 1)
    x, _ = forward(cfg, params, x, positions=positions, mode="decode",
                   caches=caches, window=window, axis=axis)
    return logits_fn(cfg, params, x).float(), caches


# Token-returning serving steps: the engine is greedy-only, so the argmax
# runs on the device and the host fetches int32 ids ([] for admission,
# [B] per decode step), never full-vocab logits. The decode variant also
# returns the advanced positions, which feed the next step directly. On a
# model axis (`axis`, with `cfg` the rank's `local_config`), the
# logits-returning entry points give this rank's vocabulary slice, and the
# token steps the argmax over every rank's slice, the same ids on each.


def prefill_into_slot_token(cfg, params, tokens, length, slot, caches,
                            window=0, axis=None):
    """`prefill_into_slot` returning (0-dim int32 greedy token, arena)."""
    logits, caches = prefill_into_slot(cfg, params, tokens, length, slot,
                                       caches, window=window, axis=axis)
    return _greedy(axis, logits[0, -1], cfg), caches


def decode_rows_tokens(cfg, params, tokens, caches, positions, window=0,
                       axis=None):
    """`decode_rows` returning (next [B] int32, arena, positions + 1).

    tokens: [B] int (each slot's incoming token, i.e. the previous step's
    output); positions: int32 [B]. Dead rows advance too; the engine
    re-uploads exact host values whenever admission or finish touches a
    row."""
    positions = torch.as_tensor(positions, dtype=torch.int32,
                                device=tokens.device)
    logits, caches = decode_rows(cfg, params, tokens[:, None], caches,
                                 positions, window=window, axis=axis)
    return _greedy(axis, logits[:, -1], cfg), caches, positions + 1


# The paged pool (`repro_torch.serve`, paged=True): every slot's KV lives
# in fixed-size blocks of one shared pool, addressed through per-slot block
# tables the engine keeps on the host. Admission streams a prompt in
# through fixed-size chunks (batch-1); the decode step runs all slots with
# per-row tables and lengths. window > 0 makes every table a ring.


def init_pool(cfg, num_blocks, block_size, dtype=torch.bfloat16,
              device=None, window=0):
    """Zero paged pool, one {"k", "v": [count, num_blocks + 1, block_size,
    KV, hd]} per segment (MLA: {"ckv": [..., r], "kpe": [..., rope]});
    block 0 is the null block, so allocatable ids are 1..num_blocks.
    Attention stacks only: recurrent state has no pages, and MoE routing
    capacity would change with the chunk. MLA with a sliding window (the
    config's or `window`) does not page either."""
    if (window or cfg.attn_window) and cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: paged KV + sliding window is GQA-only: the arena's "
            "mla_prefill ignores the window, so there is no windowed-MLA "
            "family for a ring to stay bit-identical with (use the slot "
            "arena)")
    pool = []
    for kind, count in segments(cfg):
        if kind == "moe":
            # chunked prefill would change the experts' capacity, which
            # depends on the static chunk length
            raise NotImplementedError(
                f"{cfg.name}: paged KV needs a pure attention stack; moe "
                "routing capacity depends on the chunk length")
        if kind != "attn":
            raise NotImplementedError(f"{cfg.name}: {kind} layers have no "
                                      "paged pool (recurrent state)")
        pool.append({name: torch.zeros(
            (count, num_blocks + 1, block_size) + shape, dtype=dtype,
            device=device) for name, shape in _entry_shapes(cfg).items()})
    return pool


def prefill_chunk_into_blocks(cfg, params, tokens, length, ctx_len,
                              block_table, pool, window=0, axis=None):
    """Stream one prompt chunk into a slot's blocks (batch-1 admission).

    tokens: [1, C] int, the chunk right-padded to the fixed chunk size C;
    length: valid tokens in it (an int); ctx_len: tokens already streamed
    into the slot (an int); block_table: int [W], the slot's blocks; pool:
    from `init_pool`, written in place. Returns (logits [1,1,V] in f32 at
    chunk position length - 1, meaningful for the prompt's last chunk
    only, and the pool)."""
    params = _cast(cfg, params)
    x = _embed_tokens(cfg, params, tokens, axis)
    c = x.shape[1]
    length, ctx_len = int(length), int(ctx_len)
    positions = ctx_len + torch.arange(c, device=x.device)[None]
    x, _ = forward(cfg, params, x, positions=positions, mode="prefill",
                   caches=pool, window=window,
                   paged={"table": block_table, "ctx_len": ctx_len,
                          "valid": length}, axis=axis)
    logits = logits_fn(cfg, params, x[:, length - 1:length]).float()
    return logits, pool


def decode_rows_paged(cfg, params, token, pool, block_tables, lengths,
                      window=0, axis=None):
    """One decode step over all slots against the shared pool.

    token: [B,1] int; block_tables: int32 [B, W]; lengths: int32 [B],
    tokens already cached per row (the incoming token's position). Dead
    rows carry a zeroed table: they write and read only the null block,
    and the engine ignores their tokens. Returns (logits [B,1,V] in f32,
    the pool, written in place)."""
    params = _cast(cfg, params)
    x = _embed_tokens(cfg, params, token, axis)
    b = x.shape[0]
    x, _ = forward(cfg, params, x, positions=lengths.reshape(b, 1),
                   mode="decode", caches=pool, window=window,
                   paged={"tables": block_tables, "lengths": lengths},
                   axis=axis)
    return logits_fn(cfg, params, x).float(), pool


def prefill_chunk_into_blocks_token(cfg, params, tokens, length, ctx_len,
                                    block_table, pool, window=0, axis=None):
    """`prefill_chunk_into_blocks` returning (0-dim int32 greedy token,
    pool); the token is meaningful for the prompt's last chunk only."""
    logits, pool = prefill_chunk_into_blocks(cfg, params, tokens, length,
                                             ctx_len, block_table, pool,
                                             window=window, axis=axis)
    return _greedy(axis, logits[0, -1], cfg), pool


def decode_rows_paged_tokens(cfg, params, tokens, pool, block_tables,
                             lengths, window=0, axis=None):
    """`decode_rows_paged` returning (next [B] int32, pool, lengths + 1).

    Dead rows' lengths drift upward on the device, which is inert: their
    zeroed tables route every write to the null block (block indices
    past the table clamp to its last entry), the kernels stop at the
    table's width, and the engine re-uploads exact host values whenever
    admission, finish or preemption touches a row."""
    logits, pool = decode_rows_paged(cfg, params, tokens[:, None], pool,
                                     block_tables, lengths, window=window,
                                     axis=axis)
    return _greedy(axis, logits[:, -1], cfg), pool, lengths + 1


# The fused mixed steps (overlapped admission, `repro_torch.serve` with
# overlap=True): ONE forward over the decode rows of every slot and one
# prefill unit (the arena's whole padded prompt, or one chunk of the
# pool's), as the token batch [1, B + S, D]. The two halves touch disjoint
# state: the slot being prefilled is dead to decode until the engine
# resolves it. Each half's rows are bitwise what its standalone step
# computes wherever the shared ops are row-stable (`attention.
# MIXED_PER_HALF` names the ops that are not, and run per half);
# only all-attention stacks reach this path (`FamilyCaps.
# supports_mixed_step`). On a model axis the sums of the row-parallel
# products run on the whole mixed batch: a sum over ranks is elementwise,
# in the same order for every element, so each half's rows stay bitwise
# what its standalone step's sums give.


def _mixed_mlp(params, x, nd, mlp_type, product=torch.matmul):
    """`mlp_apply` on the mixed batch: the gate and up products with their
    activation through `attention.per_half` (as "w_up"), the down
    projection `product` through `attention.mixed_product`."""
    h = A.per_half(lambda t: mlp_hidden(params, t, mlp_type), x, nd, "w_up")
    return A.mixed_product(h, params["w_down"], nd, "w_down", product)


def _mixed_forward(cfg, params, x, caches, nd, attn_fn, leaves, axis=None):
    """The shared trunk of the mixed steps over x [1, nd + S, D]: each
    layer's norm -> `attn_fn(p_attn, h, layer_cache)` -> norm -> MLP,
    then the final norm (the norms, `cfg.norm_type`, through `attention.
    mixed_norm`). `leaves` names the cache leaves of a layer (written in
    place by `attn_fn`); `axis` as `forward`'s."""
    segs = segments(cfg)
    if segs != [("attn", cfg.num_layers)]:
        raise NotImplementedError(f"{cfg.name}: the mixed step needs one "
                                  f"attention segment, got {segs}")
    seg = caches[0]
    for i, lp in enumerate(_layers(params, 0, cfg.num_layers)):
        h = A.mixed_norm(lp["ln1"], x, nd, cfg.norm_type)
        attn_out, _ = attn_fn(lp["attn"], h,
                              {name: seg[name][i] for name in leaves})
        x = x + _reduce(axis, attn_out, x.dtype)
        h2 = A.mixed_norm(lp["ln2"], x, nd, cfg.norm_type)
        x = x + _reduce(axis, _mixed_mlp(lp["mlp"], h2, nd, cfg.mlp_type,
                                         _product(axis)), x.dtype)
    return A.mixed_norm(subtree(params, "final_norm"), x, nd,
                        cfg.norm_type)


def _mixed_embed(cfg, params, dec_tokens, adm_tokens, axis=None):
    """Embed the decode tokens [B] as [B, 1] and the admission tokens
    [1, S] apart (the shapes of the standalone steps) and concatenate the
    embeddings into the mixed batch [1, B + S, D]. On a model axis the
    rank's parts are concatenated first and summed over the axis once."""
    if not _whole_vocab(cfg, params, axis):
        table = params["embed.table"]
        x = torch.cat([axis.embed_local(table, dec_tokens[None]),
                       axis.embed_local(table, adm_tokens)], dim=1)
        return axis.reduce(x).to(getattr(torch, cfg.compute_dtype))
    xd = _embed_tokens(cfg, params, dec_tokens[:, None])         # [B, 1, D]
    xa = _embed_tokens(cfg, params, adm_tokens)                  # [1, S, D]
    return torch.cat([xd.transpose(0, 1), xa], dim=1)


def _mixed_logits(cfg, params, x, b, last_idx):
    """Logits of the trunk's output x [1, B + S, D] for the B decode rows
    ([B, 1, V]) and for position `last_idx` of the token axis ([1, 1, V]),
    in f32, from one unembed over the B + 1 rows."""
    h_sel = torch.cat([x[0, :b], x[0, last_idx:last_idx + 1]])[None]
    logits = logits_fn(cfg, params, h_sel).float()
    return logits[0, :b, None], logits[:, b:]


def mixed_step(cfg, params, tokens, caches, positions, p_tokens, p_len,
               p_slot, window=0, axis=None):
    """One fused arena step: decode every slot and prefill one request.

    tokens, positions: the `decode_rows` operands ([B] int, int32 [B]);
    p_tokens [1, Sp], p_len, p_slot: the `prefill_into_slot` operands (the
    padded prompt, its true length, its slot). Slot `p_slot` must be dead
    to decode: its row is overwritten whole after the decode half's
    insert. Returns (decode logits [B, 1, V], the prompt's logits [1, 1, V]
    at position p_len - 1, both f32, and the arena, updated in place)."""
    params = _cast(cfg, params)
    b, sp = tokens.shape[0], p_tokens.shape[1]
    p_len, p_slot = int(p_len), int(p_slot)
    dev = tokens.device
    x = _mixed_embed(cfg, params, tokens, p_tokens, axis)
    pos_d = torch.as_tensor(positions, dtype=torch.int32, device=dev)[None]
    pos_p = torch.arange(sp, device=dev)[None]

    def attn_fn(p, h, layer):
        if cfg.mla is not None:
            return A.mla_mixed(p, cfg, h, b, pos_d, pos_p, layer, p_len,
                               p_slot, product=_product(axis))
        return A.gqa_mixed(p, cfg, h, b, pos_d, pos_p, layer, p_len, p_slot,
                           window=window, product=_product(axis))

    x = _mixed_forward(cfg, params, x, caches, b, attn_fn,
                       tuple(_entry_shapes(cfg)) + ("ptr",), axis)
    return _mixed_logits(cfg, params, x, b, b + p_len - 1) + (caches,)


def mixed_step_paged(cfg, params, tokens, pool, block_tables, lengths,
                     c_tokens, c_len, ctx_len, c_table, window=0, axis=None):
    """One fused pool step: decode every slot and stream one prompt chunk.

    tokens, block_tables, lengths: the `decode_rows_paged` operands; the
    streaming slot carries a zeroed table row (its decode writes go to the
    null block). c_tokens [1, C], c_len, ctx_len, c_table int [Wc]: the
    `prefill_chunk_into_blocks` operands. Returns (decode logits [B, 1,
    V], the chunk's logits [1, 1, V] at chunk position c_len - 1, both
    f32, and the pool, written in place)."""
    params = _cast(cfg, params)
    b, c = tokens.shape[0], c_tokens.shape[1]
    c_len, ctx_len = int(c_len), int(ctx_len)
    x = _mixed_embed(cfg, params, tokens, c_tokens, axis)
    pos_d = lengths[None]
    pos_p = ctx_len + torch.arange(c, device=tokens.device)[None]

    def attn_fn(p, h, layer):
        if cfg.mla is not None:
            return A.mla_mixed_paged(p, cfg, h, b, pos_d, pos_p, layer,
                                     block_tables, lengths, ctx_len, c_table,
                                     product=_product(axis))
        return A.gqa_mixed_paged(p, cfg, h, b, pos_d, pos_p, layer,
                                 block_tables, lengths, ctx_len, c_table,
                                 window=window, c_valid=c_len,
                                 product=_product(axis))

    x = _mixed_forward(cfg, params, x, pool, b, attn_fn,
                       tuple(_entry_shapes(cfg)), axis)
    return _mixed_logits(cfg, params, x, b, b + c_len - 1) + (pool,)


def _mixed_greedy(axis, logits_d, logits_p, cfg):
    """The decode rows' [B] and the prefill unit's [] greedy tokens of the
    mixed logits; on a model axis through one `ModelAxis.argmax` over the
    B + 1 rows (the local argmax of whole logits, as `_greedy`)."""
    if axis is None or logits_d.shape[-1] == cfg.vocab_size:
        return (torch.argmax(logits_d[:, -1], -1).to(torch.int32),
                torch.argmax(logits_p[0, -1], -1).to(torch.int32))
    toks = axis.argmax(torch.cat([logits_d[:, -1], logits_p[0]]))
    return toks[:-1], toks[-1]


def mixed_step_tokens(cfg, params, tokens, caches, positions, p_tokens,
                      p_len, p_slot, window=0, axis=None):
    """`mixed_step` returning (next [B] int32, arena, positions + 1, the
    prompt's greedy token [] int32), the outputs of `decode_rows_tokens`
    and `prefill_into_slot_token` in one launch sequence."""
    positions = torch.as_tensor(positions, dtype=torch.int32,
                                device=tokens.device)
    logits_d, logits_p, caches = mixed_step(cfg, params, tokens, caches,
                                            positions, p_tokens, p_len,
                                            p_slot, window=window, axis=axis)
    nxt, p_tok = _mixed_greedy(axis, logits_d, logits_p, cfg)
    return nxt, caches, positions + 1, p_tok


def mixed_step_paged_tokens(cfg, params, tokens, pool, block_tables, lengths,
                            c_tokens, c_len, ctx_len, c_table, window=0,
                            axis=None):
    """`mixed_step_paged` returning (next [B] int32, pool, lengths + 1, the
    chunk's greedy token [] int32, meaningful for a prompt's last chunk
    only)."""
    logits_d, logits_c, pool = mixed_step_paged(
        cfg, params, tokens, pool, block_tables, lengths, c_tokens, c_len,
        ctx_len, c_table, window=window, axis=axis)
    nxt, c_tok = _mixed_greedy(axis, logits_d, logits_c, cfg)
    return nxt, pool, lengths + 1, c_tok
