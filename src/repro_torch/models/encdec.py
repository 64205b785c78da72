"""Encoder-decoder transformer (whisper-style) for the audio family, as
`repro/models/encdec.py`.

The conv and mel frontend is a stub, as in the reference: the batch
carries precomputed frame embeddings [B, T_enc, D] (T_enc = 1500 for
whisper-small). The encoder is a bidirectional transformer over the
frames, the decoder a causal one with cross-attention over the encoder's
output; both take rope positions where whisper has learned ones, as the
reference does.

Parameters are one flat dict keyed by the reference pytree's paths, each
stack's leaves [L, ...]: "encoder.ln1.scale", "encoder.attn.wq",
"encoder.mlp.w_up", "decoder.self.wq", "decoder.ln_x.bias",
"decoder.cross.wk", ..., "enc_norm.scale", "final_norm.scale",
"embed.table" and an untied "head".

The decode cache is one dict of stacked leaves, as the reference's:
{"k", "v": [L, B, T, KV, hd] (the self-attention ring), "ptr": int32 [L],
"ek", "ev": [L, B, T_enc, H, hd] (the cross-attention K/V, written once
by prefill)}, updated in place. Serving runs every attention through the
kernels: the encoder's and the cross-attention's prefill through
`ops.flash_attention` with causal=False, the decoder's self-attention
through flash (causal) and, at decode, `ops.decode_attention` over its
ring; the cross-attention's decode through `ops.decode_attention` over
the cached K/V, all T_enc rows valid. Training attends with the
autograd-able `chunked_attention`. The family has no slot arena (the
engine refuses it, as the reference's does); `launch.serve` serves it
through `serve_raw`, and a mesh through `dist.serving.make_prefill_step`
and `make_decode_step`.

On a model axis (`axis`, a `dist.tensor_parallel.ModelAxis`, with `cfg`
the rank's `local_config`) a rank serves its heads of every attention
(the encoder's, the decoder's self- and cross-attention: q, k, v by
columns, `wo` by rows, so its cache holds its heads' self K/V and cross
K/V) and its columns of each MLP's d_ff; each of those row-parallel
products is summed over the axis and rounded once (two sums an encoder
layer, three a decoder layer). The embedding and the head are the
rank's vocabulary slices, or whole where the axis does not divide the
vocabulary (whisper-small's 51,865): then the lookup is local.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models.layers import (_he, embed, embedding_init, make_norm,
                                       mlp_apply, mlp_hidden, mlp_init)
from repro_torch.models.transformer import (_cast, _flat, _product, _reduce,
                                            _whole_vocab, stacked_layers,
                                            subtree)


def encdec_init(cfg, generator, dtype=None):
    """Random parameters on the generator's device with the reference's
    shapes and scales."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    dev, d = generator.device, cfg.d_model
    norm_init, _ = make_norm(cfg.norm_type)

    def norm(lead):
        return norm_init(lead + (d,), dtype, dev)

    def mlp(lead):
        return mlp_init(generator, lead, d, cfg.d_ff, dtype, cfg.mlp_type)

    enc, dec = (cfg.encoder_layers,), (cfg.num_layers,)
    params = {}
    for name, tree in (("ln1", norm(enc)),
                       ("attn", A.gqa_init(generator, enc, cfg, dtype)),
                       ("ln2", norm(enc)), ("mlp", mlp(enc))):
        params.update(_flat(f"encoder.{name}", tree))
    for name, tree in (("ln1", norm(dec)),
                       ("self", A.gqa_init(generator, dec, cfg, dtype)),
                       ("ln_x", norm(dec)),
                       ("cross", A.cross_init(generator, dec, cfg, dtype)),
                       ("ln2", norm(dec)), ("mlp", mlp(dec))):
        params.update(_flat(f"decoder.{name}", tree))
    params.update(_flat("enc_norm", norm(())))
    params.update(_flat("final_norm", norm(())))
    params.update(_flat("embed", embedding_init(generator, cfg.vocab_size,
                                                d, dtype)))
    params["head"] = _he(generator, (d, cfg.vocab_size), dtype, d)
    return params


def _run(layer_fn, args, remat):
    """layer_fn(*args), under non-reentrant checkpointing with `remat`."""
    if remat:
        return checkpoint(layer_fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return layer_fn(*args)


def _mlp(cfg, params, x, axis):
    """The MLP of x; on a model axis its `w_down` partial products summed
    over the axis and rounded once (`ModelAxis.row_sum`)."""
    if axis is None:
        return mlp_apply(params, x, cfg.mlp_type)
    return axis.row_sum(mlp_hidden(params, x, cfg.mlp_type),
                        params["w_down"])


def encode(cfg, params, frames, *, kernel=False, remat=False, axis=None):
    """frames [B, T_enc, D] -> the normed encoder output [B, T_enc, D] in
    the compute dtype. kernel: attention through the flash kernel
    (serving); remat: checkpoint each layer (training); axis: a model
    axis (the module's docstring)."""
    _, norm = make_norm(cfg.norm_type)
    x = frames.to(getattr(torch, cfg.compute_dtype))
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None].expand(b, t)

    def layer(lp, xx):
        h = norm(lp["ln1"], xx)
        xx = xx + _reduce(axis, A.bidir_attention(
            lp["attn"], cfg, h, positions, kernel=kernel,
            product=_product(axis)), xx.dtype)
        return xx + _mlp(cfg, lp["mlp"], norm(lp["ln2"], xx), axis)

    for lp in stacked_layers(params, "encoder", cfg.encoder_layers):
        x = _run(layer, (lp, x), remat)
    return norm(subtree(params, "enc_norm"), x)


def _decoder_layer(cfg, lp, x, positions, mode, caches, i, enc_out,
                   axis=None):
    """Layer i of the decoder: norm -> self-attention -> norm ->
    cross-attention -> norm -> MLP. "train": chunked attention, no cache;
    "prefill": flash, the self K/V and the cross K/V (cast to the cache's
    dtype) written into layer i of `caches`, ptr set to S; "decode": the
    decode kernel over the self ring (insert, attend, ptr + 1) and over
    the cached cross K/V. axis: a model axis (the module's docstring)."""
    _, norm = make_norm(cfg.norm_type)
    product = _product(axis)
    h = norm(lp["ln1"], x)
    if mode == "decode":
        layer = {"k": caches["k"][i], "v": caches["v"][i],
                 "ptr": caches["ptr"][i]}
        out, _ = A.gqa_decode(lp["self"], cfg, h, layer, positions,
                              product=product)
    else:
        out, (k, v) = A.gqa_prefill(lp["self"], cfg, h, positions,
                                    kernel=mode == "prefill",
                                    product=product)
        if mode == "prefill":
            s, t = x.shape[1], caches["k"].shape[2]
            caches["k"][i].copy_(A.prefill_cache_entries(k, t, s))
            caches["v"][i].copy_(A.prefill_cache_entries(v, t, s))
            caches["ptr"][i].fill_(s)
    x = x + _reduce(axis, out, x.dtype)

    hx = norm(lp["ln_x"], x)
    if mode == "decode":
        out = A.cross_decode(lp["cross"], cfg, hx, caches["ek"][i],
                             caches["ev"][i], product=product)
    else:
        ek, ev = A.cross_kv(lp["cross"], cfg, enc_out)
        if mode == "prefill":
            caches["ek"][i].copy_(ek)
            caches["ev"][i].copy_(ev)
        out = A.cross_attention(lp["cross"], cfg, hx, ek.to(x.dtype),
                                ev.to(x.dtype), kernel=mode == "prefill",
                                product=product)
    x = x + _reduce(axis, out, x.dtype)
    return x + _mlp(cfg, lp["mlp"], norm(lp["ln2"], x), axis)


def _decoder_stack(cfg, params, x, positions, mode, caches, enc_out,
                   remat=False, axis=None):
    """The decoder's layers, then the final norm; `caches` (prefill,
    decode) is written in place."""
    _, norm = make_norm(cfg.norm_type)
    for i, lp in enumerate(stacked_layers(params, "decoder",
                                          cfg.num_layers)):
        x = _run(_decoder_layer, (cfg, lp, x, positions, mode, caches, i,
                                  enc_out, axis), remat and mode == "train")
    return norm(subtree(params, "final_norm"), x)


def init_cache(cfg, batch, seq_len, dtype=torch.bfloat16, device=None):
    """Zero caches: a self-attention ring of seq_len rows and the cross
    K/V of `cfg.encoder_seq` rows for each decoder layer."""
    lead = (cfg.num_layers, batch)
    kv, h, hd = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim

    def zeros(shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return {"k": zeros((seq_len, kv, hd)), "v": zeros((seq_len, kv, hd)),
            "ptr": torch.zeros((cfg.num_layers,), dtype=torch.int32,
                               device=device),
            "ek": zeros((cfg.encoder_seq, h, hd)),
            "ev": zeros((cfg.encoder_seq, h, hd))}


def _embed_tokens(cfg, params, tokens, axis=None):
    """The tokens' embeddings in the compute dtype: the local lookup, or on
    a model axis that splits the vocabulary the vocabulary-parallel one
    (`ModelAxis.embed`)."""
    if _whole_vocab(cfg, params, axis):
        x = embed(subtree(params, "embed"), tokens)
    else:
        x = axis.embed(params["embed.table"], tokens)
    return x.to(getattr(torch, cfg.compute_dtype))


def train_loss(cfg, params, batch, window=0, remat=True):
    """batch: {frames [B,T_enc,D], tokens [B,S], targets [B,S]}. Returns
    (loss, {"nll", "aux" (0)}): the mean token cross-entropy. remat:
    checkpoint each encoder and decoder layer (the reference's encdec has
    no remat switch; it only changes what backward keeps). window is
    ignored, as the reference ignores it."""
    del window
    params = _cast(cfg, params)
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    x = _embed_tokens(cfg, params, batch["tokens"])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = _decoder_stack(cfg, params, x, positions, "train", None, enc_out,
                       remat=remat)
    logits = (x @ params["head"]).float()
    gold = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    loss = torch.mean(torch.logsumexp(logits, dim=-1) - gold)
    return loss, {"nll": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                  device=loss.device)}


def prefill(cfg, params, batch, window=0, cache_dtype=torch.bfloat16,
            cache_len=None, axis=None):
    """batch: {frames [B,T_enc,D], tokens [B,S]}. Encodes the frames, runs
    the prompt through the decoder and fills fresh caches (a self ring of
    max(cache_len, S) rows). Returns (logits of the last position [B,1,V]
    in f32, caches). On a model axis (`axis`) the logits are the rank's
    vocabulary slice where the axis splits it, and the caches its
    heads'."""
    del window
    params = _cast(cfg, params)
    enc_out = encode(cfg, params, batch["frames"], kernel=True, axis=axis)
    x = _embed_tokens(cfg, params, batch["tokens"], axis)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    caches = init_cache(cfg, b, max(cache_len or s, s), dtype=cache_dtype,
                        device=x.device)
    x = _decoder_stack(cfg, params, x, positions, "prefill", caches, enc_out,
                       axis=axis)
    return (x[:, -1:] @ params["head"]).float(), caches


def decode_step(cfg, params, token, caches, position, window=0, axis=None):
    """token [B,1] int; position: every row's absolute position (int or
    0-dim tensor). Returns (logits [B,1,V] in f32, caches, updated in
    place); `axis` as `prefill`'s."""
    del window
    params = _cast(cfg, params)
    x = _embed_tokens(cfg, params, token, axis)
    b = x.shape[0]
    positions = torch.as_tensor(position, dtype=torch.int32,
                                device=x.device).reshape(1, 1).expand(b, 1)
    x = _decoder_stack(cfg, params, x, positions, "decode", caches, None,
                       axis=axis)
    return (x @ params["head"]).float(), caches
