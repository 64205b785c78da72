"""Sharding specs for the ("agent", "replica", "model") training mesh and
the ("data", "model") / ("pod", "data", "model") serving meshes (the port
of `repro/dist/sharding.py`).

A spec is a tuple with one entry per dimension of its leaf: None
(replicated), a mesh axis name, or a tuple of axis names (major to
minor) that the dimension is split over together. Each function takes
the mesh as its `{axis: size}` (a dict, or anything with such a `.shape`,
as `launch.mesh.Mesh`) and a tree of shapes (dicts, lists and tuples of
tensors, fake tensors, `torch.Size`s or tuples), and returns the tree of
specs. Nothing here touches a device or a process.

The workhorse is `greedy_spec`: each mesh axis (largest first) goes to
the largest still-unassigned dimension it divides exactly. Dimensions
nothing divides stay replicated (whisper's 51865-token vocab, odd head
counts, biases, scalars), so no leaf needs a rule of its own.

  param_shardings       -- params, with an optional leading agent axis.
  state_shardings       -- the API-BCD state {"params", "token", "zhat",
                           "gacc"}.
  batch_shardings       -- the batch dim over the data-parallel axes.
  train_batch_shardings -- [A, B, ...] batches: ("agent", "replica").
  DATA_LINE             -- the training mesh's data-parallel axes.
  cache_shardings       -- stacked decode caches: batch over the data
                           axes, kv-head / latent dims over "model".
  pool_shardings        -- paged block pools: blocks replicated, kv-head /
                           latent dims over "model".

`local_shard` cuts one rank's contiguous piece of a tensor under a spec,
and `gather_shards` puts the pieces of every rank back together.
"""
from __future__ import annotations

import math

import torch

# the training mesh's data-parallel axes: a line of them is the ranks that
# hold one model coordinate (the DP baseline sums its gradient over it)
DATA_LINE = ("agent", "replica")


def axis_sizes(mesh) -> dict:
    """{axis: size} of a mesh given as a dict or an object with `.shape`."""
    return dict(mesh.shape if hasattr(mesh, "shape") else mesh)


def _shape(leaf):
    return tuple(leaf.shape if hasattr(leaf, "shape") else leaf)


def _map(fn, tree, path=()):
    """fn(path, leaf) over a tree of dicts, lists and tuples; a leaf is
    anything else (a tensor, a `torch.Size`, a tuple of ints)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and not isinstance(tree[0], int)):
        return type(tree)(_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_name(path):
    """The last dict key on a tree path (None for positional-only paths)."""
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return None


def greedy_spec(shape, axes, skip_leading=0, entries=None) -> tuple:
    """Greedy divisible-dim assignment of mesh axes to array dims.

    Axes are taken largest size first (ties by name); each goes to the
    largest dimension (index >= skip_leading) that it divides exactly and
    that no other axis claimed. Size-1 axes are never assigned, and no
    axis is assigned twice. `entries`: a spec whose named dims are
    claimed already (its axes are not assigned again). A spec of
    len(shape) entries."""
    entries = [None] * len(shape) if entries is None else list(entries)
    for axis, size in sorted(axes.items(), key=lambda kv: (-kv[1], kv[0])):
        if size <= 1 or axis in entries:
            continue
        best = None
        for i in range(skip_leading, len(shape)):
            if entries[i] is None and shape[i] % size == 0:
                if best is None or shape[i] >= shape[best]:
                    best = i
        if best is not None:
            entries[best] = axis
    return tuple(entries)


def _mesh_axes(mesh, names):
    sizes = axis_sizes(mesh)
    return {a: sizes[a] for a in names if a in sizes}


def param_shardings(mesh, shapes, leading_axis="agent", axes=None):
    """Specs for a parameter tree.

    leading_axis: the mesh axis pinned to dim 0 of every leaf (the agent
    stack), or None for unstacked params (the DP baseline, serving).
    axes: {axis: size} candidates for the other dims; by default the
    mesh's "replica" and "model" axes."""
    if axes is None:
        axes = _mesh_axes(mesh, ("replica", "model"))
    skip = 1 if leading_axis else 0

    def one(_, leaf):
        entries = list(greedy_spec(_shape(leaf), axes, skip_leading=skip))
        if leading_axis and entries:
            entries[0] = leading_axis
        return tuple(entries)

    return _map(one, shapes)


def state_shardings(mesh, state_shapes, model_dims=None):
    """Specs for the API-BCD train state.

    params / gacc: agent-stacked, FSDP over "replica" + TP over "model".
    token:         agent-stacked (one token slot per ring position).
    zhat:          [A, M, ...]: the agent axis sharded, M replicated.

    model_dims: {leaf: the dim of the unstacked leaf that "model" splits,
    or None} (`tensor_parallel.model_dims`, the explicit tensor-parallel
    split): "model" on that dim behind the leading dims and "replica"
    greedy on the others. None: the reference's greedy specs over both
    axes. The two agree where the model axis is 1."""
    axes = _mesh_axes(mesh, ("replica", "model"))
    if model_dims is not None and axes.get("model", 1) > 1:
        return _model_state_shardings(state_shapes, axes, model_dims)

    def zhat_spec(_, leaf):
        entries = list(greedy_spec(_shape(leaf), axes, skip_leading=2))
        if entries:
            entries[0] = "agent"
        return tuple(entries)

    return {
        "params": param_shardings(mesh, state_shapes["params"],
                                  leading_axis="agent", axes=axes),
        "token": param_shardings(mesh, state_shapes["token"],
                                 leading_axis="agent", axes=axes),
        "zhat": _map(zhat_spec, state_shapes["zhat"]),
        "gacc": param_shardings(mesh, state_shapes["gacc"],
                                leading_axis="agent", axes=axes),
    }


def _model_state_shardings(state_shapes, axes, model_dims):
    """`state_shardings` with "model" pinned to `model_dims` (flat
    {leaf: shape} parts)."""
    replica = {"replica": axes.get("replica", 1)}

    def part(leaves, lead):
        out = {}
        for k, leaf in leaves.items():
            entries = [None] * len(_shape(leaf))
            entries[0] = "agent"
            if model_dims[k] is not None:
                entries[lead + model_dims[k]] = "model"
            out[k] = greedy_spec(_shape(leaf), replica, skip_leading=lead,
                                 entries=entries)
        return out

    return {name: part(leaves, 2 if name == "zhat" else 1)
            for name, leaves in state_shapes.items()}


def batch_shardings(mesh, shapes, batch_axes=None):
    """Dim 0 (the batch) over `batch_axes`, the rest replicated.

    batch_axes defaults to the mesh's data-parallel axes (("pod", "data")
    on the production mesh). A batch that does not divide the axes'
    product (batch 1 on long_500k) is replicated."""
    sizes = axis_sizes(mesh)
    if batch_axes is None:
        batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    batch_axes = tuple(a for a in batch_axes if sizes.get(a, 1) > 1)
    total = math.prod(sizes[a] for a in batch_axes)

    def one(_, leaf):
        shape = _shape(leaf)
        entries = [None] * len(shape)
        if shape and batch_axes and shape[0] % total == 0:
            entries[0] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
        return tuple(entries)

    return _map(one, shapes)


def train_batch_shardings(mesh, shapes):
    """[A, B, ...] per-agent batches: the agent axis, and the rows of each
    agent over "replica" where B divides it."""
    replica = axis_sizes(mesh).get("replica", 1)

    def one(_, leaf):
        shape = _shape(leaf)
        entries = [None] * len(shape)
        if shape:
            entries[0] = "agent"
        if len(shape) >= 2 and replica > 1 and shape[1] % replica == 0:
            entries[1] = "replica"
        return tuple(entries)

    return _map(one, shapes)


def _feature_axis(name, shape, model, kv_rank):
    """3 where a leaf's kv-head dim (k, v: leaves of `kv_rank` dims or
    more) or latent feature dim (ckv, kpe: 4 or more) divides over
    "model", else None."""
    need = {"k": kv_rank, "v": kv_rank, "ckv": 4, "kpe": 4}.get(name)
    if need is None or model <= 1 or len(shape) < need or shape[3] % model:
        return None
    return 3


def cache_shardings(mesh, cache_shapes):
    """Specs for stacked decode caches (leaves [stack, B, ...]).

    Batch (dim 1) over the data axes where it divides; an attention cache's
    kv-head dim or an MLA latent's feature dim also over "model" where it
    divides. `ptr` and rank-0/1 leaves are replicated."""
    sizes = axis_sizes(mesh)
    daxes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    dtotal = math.prod(sizes[a] for a in daxes)
    model = sizes.get("model", 1)

    def one(path, leaf):
        shape = _shape(leaf)
        name = _leaf_name(path)
        entries = [None] * len(shape)
        if len(shape) <= 1 or name == "ptr":
            return tuple(entries)
        if daxes and shape[1] % dtotal == 0:
            entries[1] = daxes if len(daxes) > 1 else daxes[0]
        dim = _feature_axis(name, shape, model, kv_rank=4)
        if dim is not None:
            entries[dim] = "model"
        return tuple(entries)

    return _map(one, cache_shapes)


def pool_shardings(mesh, pool_shapes):
    """Specs for paged KV block pools (leaves [layers, NB, bs, ...]).

    The block dim stays replicated over the data axes (tables index any
    block); the kv-head dim of [layers, NB, bs, KV, hd] k / v, or the
    latent feature dim of [layers, NB, bs, r] ckv / kpe, goes over
    "model" where it divides."""
    model = axis_sizes(mesh).get("model", 1)

    def one(path, leaf):
        shape = _shape(leaf)
        name = _leaf_name(path)
        entries = [None] * len(shape)
        dim = _feature_axis(name, shape, model, kv_rank=5)
        if dim is not None:
            entries[dim] = "model"
        return tuple(entries)

    return _map(one, pool_shapes)


# ---------------------------------------------------------------------------
# cutting and joining shards
# ---------------------------------------------------------------------------


def _entry_axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def restrict(spec, axes):
    """The spec with every axis not in `axes` dropped (its dims replicated
    as far as those axes go)."""
    out = []
    for entry in spec:
        kept = tuple(a for a in _entry_axes(entry) if a in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


def _slices(shape, spec, sizes, coords):
    """The index of the piece at `coords` ({axis: index}) in a tensor of
    `shape` under `spec`."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    index = []
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = math.prod(sizes[a] for a in axes)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {shape} does not split {n} ways "
                             f"({spec})")
        pos = 0
        for a in axes:                      # row-major over the entry
            pos = pos * sizes[a] + coords[a]
        step = shape[dim] // n
        index.append(slice(pos * step, (pos + 1) * step))
    return tuple(index)


def local_shard(t, spec, mesh, coords):
    """The piece of `t` that the rank at `coords` ({axis: index}) holds
    under `spec`, as a contiguous tensor of its own."""
    return t[_slices(tuple(t.shape), spec, axis_sizes(mesh),
                     coords)].contiguous()


def shard_shape(shape, spec, mesh):
    """The shape of each piece of a `shape` tensor under `spec`."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] //= math.prod(sizes[a] for a in _entry_axes(entry))
    return tuple(out)


def mesh_coords(mesh, rank):
    """{axis: index} of `rank` on the mesh, ranks laid out row-major over
    the axes in the mesh's order."""
    coords = {}
    for axis, size in reversed(list(axis_sizes(mesh).items())):
        coords[axis] = rank % size
        rank //= size
    return dict(reversed(list(coords.items())))


def gather_shards(pieces, spec, mesh):
    """The inverse of `local_shard`: `pieces[r]` is the piece that rank r
    (row-major over the mesh's axes) holds; returns the whole tensor.
    Ranks that hold the same piece (the axes the spec does not name) must
    hold equal pieces; the last one's is kept."""
    sizes = axis_sizes(mesh)
    if len(pieces) != math.prod(sizes.values()):
        raise ValueError(f"{len(pieces)} pieces for a mesh of {sizes}")
    first = pieces[0]
    shape = list(first.shape)
    for dim, entry in enumerate(spec):
        shape[dim] *= math.prod(sizes[a] for a in _entry_axes(entry))
    out = torch.empty(shape, dtype=first.dtype, device=first.device)
    for rank, piece in enumerate(pieces):
        out[_slices(tuple(shape), spec, sizes,
                    mesh_coords(sizes, rank))] = piece
    return out
