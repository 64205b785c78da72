"""Serving on a ("data", "model") mesh (the port of
`repro/dist/serving.py`).

The reference jits the model's token-returning serving steps with
parameters tensor-parallel over "model", the decode rows split over the
data axes and the KV arena and pool sharded on their kv-head axis, and
lets GSPMD partition them; its decode kernels then run on the local
shard. Here each rank runs its slice of the model itself
(`dist.tensor_parallel`): `local_model` is the rank's model over its
parameter shard and its arena or pool (`init_arena` / `init_pool` of the
rank's `local_config`, which is `sharding.local_shard` of the whole one
under `cache_shardings` / `pool_shardings`). Its entry points sum over
the model axis where the whole model's products would and return the
argmax over every rank's vocabulary slice, the same ids on every rank of
a model line. The ranks run one deterministic scheduler in lockstep
(`serve.Engine(mesh=...)`, `launch/serve_mesh.py`), so every host
decision is the same on every rank.

The data axes split the decode rows (`RowSplit`): slot s of a max_batch
B engine lives on data line s // (B / data), contiguous rows as GSPMD
shards the batch, pod-major. Each line decodes its B / data rows every
step and gathers the `[B / data]` int32 ids over the data axes into the
`[B]` ids every rank reads; an admission's prefill runs on the line that
owns its slot, and its first token reaches the other lines through the
same kind of gather. The arena of a line holds its rows only. The pool
is the reference's, whose block dimension is replicated over the data
axes: its allocator, block tables, top-ups and preemption victims stay
global, the same host state on every rank, so the scheduling decisions
are the reference's; each line holds the whole pool of its kv heads and
writes and reads only the blocks of its own rows. Another line's copy of
a block is never read: a row reads only the positions below its length,
and each of those was written by that row's prefill or decode steps, on
its own line (a freed block that another line's row takes next is
rewritten there before any of its positions is valid, as a recycled
block is on one process).

  data_axes, serve_param_shardings -- the reference's specs, on the
      port's shape trees (the parameters greedy over "model", replicated
      over the data axes); the tensor-parallel split differs
      (`tensor_parallel`'s docstring says why);
  local_model -- the rank's model. The reference's six token-step
      builders are its entry points: make_slot_prefill_token_step is
      `prefill_into_slot_token`, make_decode_rows_token_step
      `decode_rows_tokens`, make_prefill_chunk_token_step
      `prefill_chunk_into_blocks_token`, make_decode_rows_paged_token_step
      `decode_rows_paged_tokens`, make_mixed_arena_token_step
      `mixed_step_tokens` and make_mixed_paged_token_step
      `mixed_step_paged_tokens`, which the engine takes from it;
  make_prefill_step, make_decode_step -- the reference's wave path (one
      batched prefill, then greedy decode steps, as `launch.serve.
      serve_raw` runs them on one process) on this rank: its data line's
      rows of the batch, the model over "model" through `local_model`,
      the greedy ids gathered over the data axes. The encoder-decoder
      and a VLM's patch prefix, which the engine cannot take, serve
      through them;
  RowSplit -- the decode rows of this rank's data line, and the gathers
      of their ids over the data axes;
  serve_step_sends -- the bytes each rank sends, by kind, in a decode
      step, an admission, a mixed step, a first token's gather and the
      wave path's prefill and decode steps.

A model axis of 1 is the one-process model itself; a data axis of 1
keeps every row on every rank and gathers nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.dist.sharding import _map, _shape, axis_sizes, greedy_spec
from repro_torch.dist.tensor_parallel import (SUM_DTYPE, _encdec,
                                              model_axis, splits_vocab)
from repro_torch.models.transformer import _greedy


def data_axes(mesh):
    """The data-parallel (batch) axes of a mesh, pod-major."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def serve_param_shardings(mesh, params_shapes):
    """The reference's serving specs: tensor-parallel over "model" (each
    leaf greedy), replicated over the data axes."""
    axes = {"model": axis_sizes(mesh).get("model", 1)}
    return _map(lambda _, leaf: greedy_spec(_shape(leaf), axes),
                params_shapes)


def local_model(model, mesh, comm):
    """The model this rank serves on `mesh` with collectives `comm`: its
    slice of `model` (`build_model(..., model_axis=...)`), or `model`
    itself on a model axis of 1."""
    from repro_torch.models import build_model

    axis = model_axis(mesh, comm)
    if axis is None:
        return model
    return build_model(model.cfg, window=model.window, model_axis=axis)


def _wave_rows(batch_rows, mesh, comm, device):
    """The `RowSplit` of a wave batch of `batch_rows` rows: over the data
    axes where they divide it (the reference's `batch_shardings`), else
    every row on every line, gathering nothing."""
    sizes = axis_sizes(mesh)
    data = math.prod(sizes[a] for a in data_axes(mesh))
    return RowSplit(batch_rows, mesh if batch_rows % data == 0 else None,
                    comm, device)


def make_prefill_step(model, mesh, comm, batch_rows, device="cpu"):
    """The reference's `make_prefill_step` on this rank of `mesh` (over
    collectives `comm`): (prefill, rows). prefill(params, batch, **kw)
    takes this rank's serving parameters (`tensor_parallel.
    serving_params`) and the whole batch of `batch_rows` rows ({"tokens"
    [B, S], and "frames" [B, T_enc, D] or "patches" [B, P, D]; keywords
    as `model.prefill`'s), runs `model.prefill` of its line's rows (`rows`,
    a `RowSplit`: B / data of them where B divides the data size, else
    all) through `local_model`, and returns (the greedy ids [B] int32 of
    every row, equal on every rank; its rows' logits [B_line, 1, V_rank]
    in f32, the rank's vocabulary slice where the axis splits it; its
    rows' caches, of the rank's heads)."""
    steps = local_model(model, mesh, comm)
    axis = model_axis(mesh, comm)
    rows = _wave_rows(batch_rows, mesh, comm, device)

    def prefill(params, batch, **kw):
        mine = {k: v[rows.lo:rows.hi] for k, v in batch.items()}
        logits, caches = steps.prefill(params, mine, **kw)
        return (rows.gather(_greedy(axis, logits[:, -1], model.cfg)),
                logits, caches)

    return prefill, rows


def make_decode_step(model, mesh, comm, batch_rows, device="cpu"):
    """The reference's `make_decode_step` on this rank: (decode, rows).
    decode(params, token, caches, position) takes the whole batch's
    tokens [B, 1], the caches of its line's rows (`make_prefill_step`'s)
    and the position of every row, runs `model.decode_step` of its
    line's rows, and returns (the greedy ids [B] int32, equal on every
    rank; its rows' logits [B_line, 1, V_rank] in f32; the caches,
    updated in place)."""
    steps = local_model(model, mesh, comm)
    axis = model_axis(mesh, comm)
    rows = _wave_rows(batch_rows, mesh, comm, device)

    def decode(params, token, caches, position):
        logits, caches = steps.decode_step(params, token[rows.lo:rows.hi],
                                           caches, position)
        return (rows.gather(_greedy(axis, logits[:, -1], model.cfg)),
                logits, caches)

    return decode, rows


class RowSplit:
    """The decode rows of a `max_batch` engine that this rank's line of
    the data axes holds on `mesh` (all of them without a mesh or on a
    data axis of 1), over collectives `comm` on `device`: rows
    [lo, hi), B / data of them, slot s on line s // (B / data)."""

    def __init__(self, max_batch, mesh=None, comm=None, device="cpu"):
        sizes = axis_sizes(mesh) if mesh is not None else {}
        axes = data_axes(mesh) if mesh is not None else ()
        self.size = math.prod(sizes[a] for a in axes)
        if max_batch % self.size:
            raise ValueError(f"max_batch {max_batch} does not split over a "
                             f"data axis of {self.size}: it must be a "
                             f"multiple of the data size")
        self.rows = max_batch // self.size
        self.index = 0      # pod-major over the data axes
        if self.size > 1:
            coords = mesh.coords
            for a in axes:
                self.index = self.index * sizes[a] + coords[a]
        self.lo = self.index * self.rows
        self.hi = self.lo + self.rows
        self.comm = comm
        self.axis = axes[0] if len(axes) == 1 else axes
        self.device = torch.device(device)

    def owner(self, slot):
        """The data line that holds `slot`."""
        return slot // self.rows

    def owns(self, slot):
        return self.lo <= slot < self.hi

    def local(self, slot):
        """`slot`'s row in this line's arena."""
        return slot - self.lo

    def mine(self, host):
        """This line's rows of a `[B, ...]` host array."""
        return np.ascontiguousarray(host[self.lo:self.hi])

    def gather(self, rows):
        """The `[B, ...]` tensor of every line's `[B / data, ...]` rows, in
        line order (`rows` itself on a data axis of 1)."""
        if self.size == 1:
            return rows
        return torch.cat(self.comm.all_gather(rows.contiguous(), self.axis))

    def first_tokens(self, entries):
        """The `[n]` first tokens of n admissions [(slot, token)], equal on
        every rank: each line puts in the tokens of the slots it owns
        (the others' entries are None there, and go as 0), and the
        gather over the data axes takes each from its owner."""
        if self.size == 1:
            return torch.stack([tok for _, tok in entries])
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        mine = torch.stack([zero if tok is None else tok
                            for _, tok in entries])
        every = torch.stack(self.comm.all_gather(mine, self.axis))
        owners = torch.tensor([self.owner(s) for s, _ in entries],
                              device=self.device)
        return every.gather(0, owners[None])[0]


def serve_step_sends(cfg, mesh, batch_rows, prefill_rows):
    """[{step: {kind: bytes}} for each rank, row-major over the mesh], the
    bytes each rank sends in one "decode" step of a batch_rows engine
    (batch_rows / data of them on the rank's line), one "admission" (a
    prefill unit of prefill_rows tokens: the arena's padded prompt or the
    pool's chunk, on the line that owns its slot), one "mixed" step (both
    in one trunk), one "first_token" (an admission's, resolved), and the
    wave path's "wave_prefill" (`make_prefill_step` of a batch_rows batch
    of prefill_rows-token prompts: its line's rows, all of them where
    they do not divide over the data axes) and "wave_decode"
    (`make_decode_step`'s). Over the model axis a step sums
    ("all_reduce") the embedding of its tokens, in the compute dtype,
    where the axis splits the vocabulary (a whole table looks up
    locally), and each layer's row-parallel products, in
    `tensor_parallel.SUM_DTYPE`: two a decoder-only layer (an attention
    layer's after `wo` and its MLP's `w_down` or its MoE layer's output,
    the routed combine and the shared experts' product as one partial;
    an RWKV6 layer's `wo` and `cm_wv`; an RG-LRU layer's `w_out` and its
    MLP's `w_down`), over the prompt and a VLM's `num_patches` patches,
    three an encoder-decoder's decoder layer (self-attention,
    cross-attention, MLP), and at the wave prefill two an encoder layer
    over `encoder_seq` frames a row; it gathers one (value, id) f32 pair
    a greedy row ("all_gather") where the axis splits the vocabulary.
    Over the data axes a decode step gathers its line's int32 ids and a
    first token its int32 id ("all_gather", to each other line). Empty
    on a mesh of one rank."""
    sizes = axis_sizes(mesh)
    mp = sizes.get("model", 1)
    data = math.prod(sizes[a] for a in data_axes(mesh))
    rows = batch_rows // data
    # the wave path's rows of a line and the lines its ids gather over
    wave_data = data if batch_rows % data == 0 else 1
    wave = batch_rows // wave_data
    split = splits_vocab(cfg, mp)
    elem = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                       ).element_size()
    encdec = _encdec(cfg)
    layer_sums = (3 if encdec else 2) * cfg.num_layers * SUM_DTYPE.itemsize
    prefix = cfg.num_patches if cfg.family == "vlm" else 0

    def trunk(tokens, extra=0):
        # [(rows a summed tensor, bytes an element over those tensors)]:
        # the embedding of `tokens` rows and each layer's sums over them
        # and `extra` rows more (a prefix in front of the text)
        if not split:
            return [(tokens + extra, layer_sums)]
        if not extra:
            return [(tokens, elem + layer_sums)]
        return [(tokens, elem), (tokens + extra, layer_sums)]

    encoder = ([(wave * cfg.encoder_seq,
                 2 * cfg.encoder_layers * SUM_DTYPE.itemsize)]
               if encdec else [])
    # (sums over the model axis, greedy picks, ids gathered over the
    # data axes, the data size they gather over)
    shapes = {"decode": (trunk(rows), rows, rows, data),
              "admission": (trunk(prefill_rows), 1, 0, data),
              "mixed": (trunk(rows + prefill_rows), rows + 1, rows, data),
              "first_token": ([], 0, 1, data),
              "wave_prefill": (trunk(wave * prefill_rows, wave * prefix)
                               + encoder, wave, wave, wave_data),
              "wave_decode": (trunk(wave), wave, wave, wave_data)}

    def all_reduce(n, index):
        # Collectives.all_reduce: the whole tensor on a line of 2; else
        # the other ranks' pieces of the flat tensor, then its own piece
        # to each of them
        piece = n // mp + (index < n % mp)
        return n + (mp - 2) * piece

    out = []
    for rank in range(math.prod(sizes.values())):
        index = rank % mp           # "model" is the mesh's last axis
        steps = {}
        for step, (sums, picks, ids, lines) in shapes.items():
            sent = {}
            if mp > 1:
                summed = sum(per_elem * all_reduce(n * cfg.d_model, index)
                             for n, per_elem in sums if n)
                if summed:
                    sent["all_reduce"] = summed
            gathered = ((mp - 1) * picks * 2 * 4 if mp > 1 and split
                        else 0) + (lines - 1) * ids * 4
            if gathered:
                sent["all_gather"] = gathered
            steps[step] = sent
        out.append(steps)
    return out
