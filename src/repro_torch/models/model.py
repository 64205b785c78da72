"""Model dispatch: build (init, train_loss, and the serving entry points)
per config, as `repro/models/model.py` does.

Every family the reference builds is ported. The decoder-only stack
(`models.transformer`) serves the dense family (a swiglu, gelu or
squared-ReLU MLP, rmsnorm or layernorm, qk-norm where the config asks
for it), the mixture of experts (family "moe", every layer "moe": top-k
routed swiglu experts with GShard capacity, shared experts where the
config has them, as dbrx-132b and deepseek-v2-236b), the RWKV6
recurrent stack (family "ssm", every layer "rwkv"), the RG-LRU hybrid
(family "hybrid", layers "rglru" and "attn", as recurrentgemma-2b) and
the VLM (family "vlm", phi-3-vision: the dense stack, whose `train_loss`
and `prefill` take a batch's patch embeddings as a prefix). The
encoder-decoder (`models.encdec`; families "audio" and "encdec",
whisper-small) has init, train_loss, prefill, decode_step and init_cache
only, as in the reference: no slot arena, so the engine refuses it and
`launch.serve` serves it through its raw loop. The attention of the
dense and MoE families is GQA, or MLA where `cfg.mla` is set
(deepseek-v2-236b's latent attention; a dense stack with it pages and
has the mixed steps as a GQA one does, except with a sliding window:
then `init_pool` raises, as the reference's does, and the engine serves
it from the arena). The dense serving entry points
cover the slot arena and the paged pool; an MoE or recurrent model has
the arena's only (expert capacity depends on the static chunk length,
and recurrent state has no pages, as the reference's `FamilyCaps` says),
and prefills every prompt at its exact length. `train_loss` adds the MoE
layers' load-balance loss. Every family trains: `train_loss` runs a
recurrent layer from a zero state through the differentiable recurrences
(`kernels.ops.rwkv6_scan_train`, `rglru_scan_train`, whose backward is a
hand-written kernel on the card). The dense stack also has the
reference's mixed-step entry points (one fused decode + prefill step,
the engine's overlapped admission) on the arena and the pool; the MoE
and recurrent families have none, as in the reference. A sliding window
(`cfg.attn_window` or the `window` override) serves from the arena, as a
ring of the window's capacity, and from the paged pool, as a block ring,
and `train_loss` trains with it. `train_loss(params, batch, remat=True)`
checkpoints each layer's activations, as the reference's does by
default.

`param_specs`, `input_specs` and `cache_specs` give the parameters, a
batch of an assigned `ShapeConfig` and the decode caches as fake tensors
(`torch._subclasses.fake_tensor`): the reference's shapes and dtypes,
with nothing allocated, as its `jax.eval_shape` and `ShapeDtypeStruct`s
give them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable           # (generator) -> params dict
    train_loss: Callable     # (params, batch, remat=True) -> (loss, metrics)
    prefill: Callable        # (params, batch, **kw) -> (logits, caches)
    decode_step: Callable    # (params, token, caches, position) -> (logits, caches)
    init_cache: Callable     # (batch, seq_len, **kw) -> caches
    # the config's sliding window (0 = full causal)
    window: int = 0
    # slot-arena continuous-batching entry points (repro_torch.serve)
    init_arena: Callable = None         # (slots, capacity, **kw) -> arena
    prefill_into_slot: Callable = None  # (params, tokens, length, slot, arena)
    decode_rows: Callable = None        # (params, token, arena, positions)
    # token-returning serving steps: greedy argmax on the device, so the
    # host fetches int32 ids instead of full-vocab logits
    prefill_into_slot_token: Callable = None    # -> (tok [], arena)
    decode_rows_tokens: Callable = None         # -> (toks [B], arena, pos+1)
    # paged-KV (block-pool) entry points (repro_torch.serve, paged=True)
    init_pool: Callable = None          # (num_blocks, block_size, **kw)
    prefill_chunk_into_blocks: Callable = None  # (params, tokens, length,
                                                #  ctx_len, table, pool)
    decode_rows_paged: Callable = None  # (params, token, pool, tables,
                                        #  lengths)
    prefill_chunk_into_blocks_token: Callable = None  # -> (tok [], pool)
    decode_rows_paged_tokens: Callable = None   # -> (toks [B], pool, len+1)
    # fused decode + prefill steps (the engine's overlapped admission);
    # None for the recurrent families
    mixed_step_tokens: Callable = None  # (params, tokens, arena, positions,
                                        #  p_tokens, p_len, p_slot)
                                        # -> (toks [B], arena, pos+1, tok [])
    mixed_step_paged_tokens: Callable = None  # (params, tokens, pool,
                                              #  tables, lengths, c_tokens,
                                              #  c_len, ctx_len, c_table)
                                              # -> (toks, pool, len+1, tok)


# the families, MLPs and norms the reference builds (`ArchConfig`'s)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "encdec")
MLP_TYPES = ("swiglu", "gelu", "sq_relu")
NORM_TYPES = ("rmsnorm", "layernorm")


def _check_ported(cfg: ArchConfig):
    """Refuse a config outside the schema the reference builds: a family,
    MLP or norm that `ArchConfig` does not name. It refuses nothing the
    reference builds; an unknown layer kind raises where the stack is
    built (`transformer.segments`), as in the reference."""
    bad = [f"{what} {value!r}" for what, value, known in (
        ("family", cfg.family, FAMILIES), ("mlp", cfg.mlp_type, MLP_TYPES),
        ("norm", cfg.norm_type, NORM_TYPES)) if value not in known]
    if bad:
        raise NotImplementedError(f"{cfg.name}: not ported to repro_torch "
                                  f"(the reference's configs name no "
                                  f"{', '.join(bad)})")


def build_model(cfg: ArchConfig, window: int = 0, model_axis=None) -> Model:
    """window: sliding-window override (0 = the config's own).

    model_axis: a `dist.tensor_parallel.ModelAxis`: the model of this
    rank's slice of a tensor-parallel model (`Model.cfg` is its
    `local_config`), whose entry points take this rank's parameters
    (`tensor_parallel.shard_params`; `serving_params` to serve) and
    caches and sum over the axis where the whole model's products would;
    its logits-returning entry points give this rank's vocabulary slice,
    and its token steps the same ids on every rank. Its `train_loss` is
    the whole model's loss on every rank, with the gradient of the
    rank's piece (`transformer.train_loss(axis=)`). Every family
    (`tensor_parallel.check_tensor_parallel`): the dense, MoE and MLA
    stacks, RWKV6 and the RG-LRU hybrid (a rank's recurrent state holds
    its heads' or channels', `init_cache(parts=)`) and the
    encoder-decoder; the dense stack alone trains there, so the others'
    `train_loss` raises, and so does a stack whose kv head is shared by
    ranks or whose vocabulary the axis does not divide."""
    _check_ported(cfg)
    axis = model_axis
    parts = 1

    def trainable():
        """Nothing off a model axis; on one, what it cannot train raises."""
    if axis is not None:
        from repro_torch.dist.tensor_parallel import (check_tensor_parallel,
                                                      local_config)
        whole, parts = cfg, axis.size
        cfg = local_config(cfg, parts)

        def trainable():
            check_tensor_parallel(whole, parts, training=True)
    if cfg.family in ("audio", "encdec"):
        def ed_loss(p, b, **kw):
            trainable()
            return ED.train_loss(cfg, p, b, **kw)

        return Model(
            cfg=cfg,
            init=lambda generator: ED.encdec_init(cfg, generator),
            train_loss=ed_loss,
            prefill=lambda p, b, **kw: ED.prefill(cfg, p, b, axis=axis,
                                                   **kw),
            decode_step=lambda p, t, c, pos: ED.decode_step(cfg, p, t, c,
                                                            pos, axis=axis),
            init_cache=lambda batch, seq, **kw: ED.init_cache(cfg, batch,
                                                              seq, **kw))
    window = cfg.attn_window or window

    def tf_loss(p, b, **kw):
        trainable()
        return TF.train_loss(cfg, p, b, window=window, axis=axis, **kw)

    entries = dict(
        init=lambda generator: TF.transformer_init(cfg, generator),
        train_loss=tf_loss,
        prefill=lambda p, b, **kw: TF.prefill(cfg, p, b, window=window,
                                               axis=axis, **kw),
        decode_step=lambda p, t, c, pos: TF.decode_step(cfg, p, t, c, pos,
                                                        window=window,
                                                        axis=axis),
        init_cache=lambda batch, seq, **kw: TF.init_cache(
            cfg, batch, seq, window=window, parts=parts, **kw),
        init_arena=lambda slots, capacity, **kw: TF.init_arena(
            cfg, slots, capacity, window=window, parts=parts, **kw),
        prefill_into_slot=lambda p, tokens, length, slot, caches:
            TF.prefill_into_slot(cfg, p, tokens, length, slot, caches,
                                 window=window, axis=axis),
        decode_rows=lambda p, t, c, pos: TF.decode_rows(cfg, p, t, c, pos,
                                                        window=window,
                                                        axis=axis),
        prefill_into_slot_token=lambda p, tokens, length, slot, caches:
            TF.prefill_into_slot_token(cfg, p, tokens, length, slot, caches,
                                       window=window, axis=axis),
        decode_rows_tokens=lambda p, t, c, pos: TF.decode_rows_tokens(
            cfg, p, t, c, pos, window=window, axis=axis),
    )
    if set(cfg.layer_types) != {"attn"}:
        if window and not {"attn", "moe"} & set(cfg.layer_types):
            raise ValueError(f"{cfg.name}: a sliding window applies to "
                             "attention layers; this stack has none")
        return Model(cfg=cfg, window=window, **entries)    # no pages
    return Model(
        cfg=cfg,
        window=window,
        **entries,
        init_pool=lambda num_blocks, block_size, **kw: TF.init_pool(
            cfg, num_blocks, block_size, window=window, **kw),
        prefill_chunk_into_blocks=lambda p, tokens, length, ctx, table, pool:
            TF.prefill_chunk_into_blocks(cfg, p, tokens, length, ctx, table,
                                         pool, window=window, axis=axis),
        decode_rows_paged=lambda p, t, pool, tables, lengths:
            TF.decode_rows_paged(cfg, p, t, pool, tables, lengths,
                                 window=window, axis=axis),
        prefill_chunk_into_blocks_token=lambda p, tokens, length, ctx, table,
            pool: TF.prefill_chunk_into_blocks_token(
                cfg, p, tokens, length, ctx, table, pool, window=window,
                axis=axis),
        decode_rows_paged_tokens=lambda p, t, pool, tables, lengths:
            TF.decode_rows_paged_tokens(cfg, p, t, pool, tables, lengths,
                                        window=window, axis=axis),
        mixed_step_tokens=lambda p, t, arena, pos, p_tokens, p_len, p_slot:
            TF.mixed_step_tokens(cfg, p, t, arena, pos, p_tokens, p_len,
                                 p_slot, window=window, axis=axis),
        mixed_step_paged_tokens=lambda p, t, pool, tables, lengths, c_tokens,
            c_len, ctx_len, c_table: TF.mixed_step_paged_tokens(
                cfg, p, t, pool, tables, lengths, c_tokens, c_len, ctx_len,
                c_table, window=window, axis=axis),
    )


# ---------------------------------------------------------------------------
# specs: fake tensors (shapes and dtypes only; nothing is allocated)
# ---------------------------------------------------------------------------


def _fake(mode):
    """The caller's FakeTensorMode (passed in, else the one it has
    entered), or a new one."""
    if mode is None:
        mode = torch._guards.detect_fake_mode()
    return FakeTensorMode() if mode is None else mode


def param_specs(cfg: ArchConfig, mode=None):
    """`model.init` on fake tensors, {dotted path: fake tensor}: the port's
    counterpart of the reference's `jax.eval_shape(model.init, key)`.
    Made inside `mode` (a FakeTensorMode; by default the one entered,
    else one opened here), as `input_specs` and `cache_specs` are."""
    with _fake(mode):
        return build_model(cfg).init(torch.Generator())


def input_specs(cfg: ArchConfig, shape: ShapeConfig, window: int = 0,
                mode=None):
    """The batch of `shape` as fake tensors, as the reference's
    `input_specs`:

    train:   {tokens, targets[, patches | frames]}
    prefill: {tokens[, patches | frames]}
    decode:  {token [B, 1]}; the caches come from `cache_specs`.

    Token ids are int32, frames and patches in the compute dtype; a VLM's
    text is the sequence less its `num_patches` prefix, which must leave
    some text. `window` is unused, as in the reference."""
    del window
    b, s = shape.global_batch, shape.seq_len
    i32, f = torch.int32, getattr(torch, cfg.compute_dtype)
    with _fake(mode):
        def ids(*dims):
            return torch.empty(dims, dtype=i32)

        if cfg.family in ("audio", "encdec"):
            frames = torch.empty((b, cfg.encoder_seq, cfg.d_model), dtype=f)
            if shape.kind == "train":
                return {"frames": frames, "tokens": ids(b, s),
                        "targets": ids(b, s)}
            if shape.kind == "prefill":
                return {"frames": frames, "tokens": ids(b, s)}
            return {"token": ids(b, 1)}
        if cfg.family == "vlm":
            p = cfg.num_patches
            s_text = s - p
            if s_text <= 0:
                raise ValueError(f"seq must exceed patch prefix: seq_len {s}"
                                 f", {p} patches")
            patches = torch.empty((b, p, cfg.d_model), dtype=f)
            if shape.kind == "train":
                return {"tokens": ids(b, s_text), "targets": ids(b, s_text),
                        "patches": patches}
            if shape.kind == "prefill":
                return {"tokens": ids(b, s_text), "patches": patches}
            return {"token": ids(b, 1)}
        if shape.kind == "train":
            return {"tokens": ids(b, s), "targets": ids(b, s)}
        if shape.kind == "prefill":
            return {"tokens": ids(b, s)}
        return {"token": ids(b, 1)}


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, window: int = 0,
                mode=None):
    """The decode caches of `shape` (`init_cache` of global_batch rows at
    a capacity of seq_len, or the window's) as fake tensors, in the
    reference's layout (`convert.arena_from_jax` maps one to the other):
    a list of per-segment dicts, or the encoder-decoder's one dict."""
    model = build_model(cfg, window=window)
    with _fake(mode):
        return model.init_cache(shape.global_batch, shape.seq_len)
