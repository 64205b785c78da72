"""Decoder-only dense GQA transformer: init, train forward and loss.

Parameters are one flat dict keyed by the reference pytree's paths
("embed.table", "segments.0.attn.wq", "final_norm.scale", ...). Layers
are stacked on a leading [L] axis under one segment, as the reference
stacks a homogeneous run of layers; the forward pass loops over them in
Python where the reference scans.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models.layers import (
    _he, embed, embedding_init, mlp_apply, mlp_init, rmsnorm, rmsnorm_init,
    unembed,
)

SEGMENT = "segments.0."


def subtree(params, prefix):
    """The leaves under `prefix.`, keyed by the rest of their path."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _layers(params, num_layers):
    """Per-layer parameters [{"ln1": {...}, "attn": {...}, ...}, ...].

    Each stacked leaf is unbound once: indexing it once per layer would
    make the backward pass build a zero [L, ...] gradient for every layer
    (O(L^2) memory traffic), where unbind's backward is one stack.
    """
    layers = [{} for _ in range(num_layers)]
    for key, v in params.items():
        if key.startswith(SEGMENT):
            group, leaf = key[len(SEGMENT):].split(".")
            for lp, v_i in zip(layers, v.unbind(0)):
                lp.setdefault(group, {})[leaf] = v_i
    return layers


def _flat(prefix, tree):
    return {f"{prefix}.{k}": v for k, v in tree.items()}


def transformer_init(cfg, generator, dtype=None):
    """Random parameters on the generator's device, with the reference's
    shapes and scales (embedding x0.02, He-scaled projections, zero biases,
    unit norm scales)."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    dev = generator.device
    lead = (cfg.num_layers,)
    d = cfg.d_model
    params = _flat("embed", embedding_init(generator, cfg.vocab_size, d,
                                           dtype))
    params.update(_flat(SEGMENT + "ln1", rmsnorm_init(lead + (d,), dtype, dev)))
    params.update(_flat(SEGMENT + "attn", A.gqa_init(generator, lead, cfg,
                                                     dtype)))
    params.update(_flat(SEGMENT + "ln2", rmsnorm_init(lead + (d,), dtype, dev)))
    params.update(_flat(SEGMENT + "mlp", mlp_init(generator, lead, d,
                                                  cfg.d_ff, dtype)))
    params.update(_flat("final_norm", rmsnorm_init((d,), dtype, dev)))
    if not cfg.tie_embeddings:
        params["head"] = _he(generator, (d, cfg.vocab_size), dtype, d)
    return params


def forward(cfg, params, x, *, positions):
    """Run the stack on embeddings x [B,S,D] (train mode: no cache)."""
    for lp in _layers(params, cfg.num_layers):
        h = rmsnorm(lp["ln1"], x)
        x = x + A.gqa_prefill(lp["attn"], cfg, h, positions)
        h2 = rmsnorm(lp["ln2"], x)
        x = x + mlp_apply(lp["mlp"], h2, cfg.mlp_type)
    return rmsnorm(subtree(params, "final_norm"), x)


def logits_fn(cfg, params, x):
    if cfg.tie_embeddings:
        return unembed(subtree(params, "embed"), x)
    return x @ params["head"]


def _cast(cfg, params):
    cd = getattr(torch, cfg.compute_dtype)
    return {k: v.to(cd) if v.is_floating_point() else v
            for k, v in params.items()}


def train_loss(cfg, params, batch):
    """batch: {tokens [B,S], targets [B,S], loss_mask [B,S] (optional)}.

    Returns (loss, metrics). Every float parameter, the embedding table
    included, is cast to the compute dtype first; the logits come from a
    compute-dtype product and are cast to f32 for the cross-entropy.
    """
    params = _cast(cfg, params)
    tokens = batch["tokens"]
    x = embed(subtree(params, "embed"), tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = forward(cfg, params, x, positions=positions)
    logits = logits_fn(cfg, params, x).float()
    m = logits.amax(dim=-1).detach()
    logz = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    gold = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        mask = mask.float()
        loss = torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + aux, {"nll": loss, "aux": aux}
