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
  RowSplit -- the decode rows of this rank's data line, and the gathers
      of their ids over the data axes;
  serve_step_sends -- the bytes each rank sends, by kind, in a decode
      step, an admission, a mixed step and a first token's gather.

A model axis of 1 is the one-process model itself; a data axis of 1
keeps every row on every rank and gathers nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.dist.sharding import _map, _shape, axis_sizes, greedy_spec
from repro_torch.dist.tensor_parallel import SUM_DTYPE, model_axis


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
    in one trunk) and one "first_token" (an admission's, resolved). Over
    the model axis a step sums ("all_reduce") the embedding, in the
    compute dtype, and each layer's two row-parallel products (its
    attention's after `wo`, its MLP's after `w_down` or its MoE layer's
    output: the routed combine and the shared experts' product as one
    partial), in `tensor_parallel.SUM_DTYPE`, and gathers one (value,
    id) f32 pair a greedy row ("all_gather"). Over the data axes a
    decode step gathers its line's int32 ids and a first token its int32
    id ("all_gather", to each other line). Empty on a mesh of one rank."""
    sizes = axis_sizes(mesh)
    mp = sizes.get("model", 1)
    data = math.prod(sizes[a] for a in data_axes(mesh))
    rows = batch_rows // data
    elem = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                       ).element_size()
    # bytes an element of d_model a step: one embedding and 2 L row sums
    per_elem = elem + 2 * cfg.num_layers * SUM_DTYPE.itemsize
    # (rows summed over the model axis, greedy picks, ids gathered over
    # the data axes)
    shapes = {"decode": (rows, rows, rows),
              "admission": (prefill_rows, 1, 0),
              "mixed": (rows + prefill_rows, rows + 1, rows),
              "first_token": (0, 0, 1)}

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
        for step, (summed, picks, ids) in shapes.items():
            sent = {}
            if mp > 1 and summed:
                sent["all_reduce"] = per_elem * all_reduce(
                    summed * cfg.d_model, index)
            gathered = ((mp - 1) * picks * 2 * 4 if mp > 1 else 0) + (
                (data - 1) * ids * 4)
            if gathered:
                sent["all_gather"] = gathered
            steps[step] = sent
        out.append(steps)
    return out
