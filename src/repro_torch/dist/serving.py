"""Serving on a ("data", "model") mesh (the port of
`repro/dist/serving.py`).

The reference jits the model's token-returning serving steps with
parameters tensor-parallel over "model" and the KV arena and pool
sharded on their kv-head axis, and lets GSPMD partition them; its
decode kernels then run on the local shard. Here each rank runs its
slice of the model itself (`dist.tensor_parallel`): `local_model` is the
rank's model over its parameter shard and its arena or pool (`init_arena`
/ `init_pool` of the rank's `local_config`, which is `sharding.
local_shard` of the whole one under `cache_shardings` /
`pool_shardings`). Its entry points sum over the model axis where the
whole model's products would and return the `[B]` argmax over every
rank's vocabulary slice, the same ids on every rank. Every host operand
(tokens, positions, lengths, block tables) is the same on every rank, as
the reference replicates them: the ranks run one deterministic scheduler
in lockstep (`serve.Engine(mesh=...)`, `launch/serve_mesh.py`).

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
  serve_step_sends -- the bytes each rank sends, by kind, in a decode
      step, an admission and a mixed step.

The mesh serves with data = 1 (`tensor_parallel.model_axis` refuses
more); a model axis of 1 is the one-process model itself.
"""
from __future__ import annotations

import math

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


def serve_step_sends(cfg, mesh, batch_rows, prefill_rows):
    """[{step: {kind: bytes}} for each rank, row-major over the mesh], the
    bytes each rank sends over the model axis in one "decode" step
    (batch_rows rows), one "admission" (a prefill unit of prefill_rows
    tokens: the arena's padded prompt or the pool's chunk) and one
    "mixed" step (both in one trunk). A step sums over the axis
    ("all_reduce") the embedding, in the compute dtype, and each layer's
    two row-parallel products, in `tensor_parallel.SUM_DTYPE`, and
    gathers one (value, id) f32 pair a greedy row ("all_gather"). Empty
    on a model axis of 1."""
    sizes = axis_sizes(mesh)
    mp = sizes.get("model", 1)
    elem = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                       ).element_size()
    # bytes an element of d_model a step: one embedding and 2 L row sums
    per_elem = elem + 2 * cfg.num_layers * SUM_DTYPE.itemsize
    shapes = {"decode": (batch_rows, batch_rows),
              "admission": (prefill_rows, 1),
              "mixed": (batch_rows + prefill_rows, batch_rows + 1)}

    def all_reduce(n, index):
        # Collectives.all_reduce: the whole tensor on a line of 2; else
        # the other ranks' pieces of the flat tensor, then its own piece
        # to each of them
        piece = n // mp + (index < n % mp)
        return n + (mp - 2) * piece

    out = []
    for rank in range(math.prod(sizes.values())):
        index = rank % mp           # "model" is the mesh's last axis
        out.append({step: {} if mp == 1 else {
            "all_reduce": per_elem * all_reduce(rows * cfg.d_model, index),
            "all_gather": (mp - 1) * picks * 2 * 4}
            for step, (rows, picks) in shapes.items()})
    return out
