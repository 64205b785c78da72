"""Tensor parallelism over a mesh's "model" axis (the port's stand-in for
what GSPMD does with the reference's `serve_param_shardings` and
`state_shardings`: partition the model from its shardings).

Each rank of the axis holds a contiguous slice of every head, hidden and
vocabulary dimension and runs the model of `local_config`: q, k and v
are column pieces (rank r holds kv heads r·KV/mp … with their G query
heads each, as `attention._project_qkv` groups them), the MLP's gate and
up projections column pieces of d_ff, `wo` and `w_down` row pieces whose
partial products `ModelAxis.reduce` sums, the embedding table its rows of
the vocabulary (and an untied `head` its columns), and every norm scale
whole. The KV arena and pool then hold the rank's kv heads, which is
`sharding.local_shard` of the whole cache under `cache_shardings` /
`pool_shardings`, so the attention kernels run on the rank's shard.

MLA splits its heads: `wq_b`, `wk_b` and `wv_b` by columns (a head's
contiguous block of each), `wo` by rows; `wq_a`, `wkv_a` and the q and
kv norms stay whole, so every rank makes the same latents and holds the
whole latent cache ({ckv, kpe} of `init_arena` / `init_pool` of its
config, which keeps `kv_lora_rank`), where the reference's
`cache_shardings` splits the latents' feature dim over "model". MoE
splits its experts: rank r holds experts r·E/mp … of `w_gate`, `w_up`
and `w_down` (the expert dim after the stacking dim, as the reference's
`shard_hint` pins its expert buffers to "model"), the router whole, and
the shared experts as the dense MLP (`shared.w_gate`, `shared.w_up` by
columns, `shared.w_down` by rows). `local_config` keeps `cfg.moe` whole:
the router has E outputs, top-k runs over all E and the capacity
divides by E, so `models.moe` takes its expert offset from the axis and
its counts from the leaves.

RWKV6 splits its heads (r, k, v, g and the decay by columns, `u` by
heads, `wo` and the channel mix's `cm_wv` by rows, the mix ratios and
`cm_wr` whole) and RG-LRU its channels of `rnn_width` (the gates, the y
branch and their biases split, `w_out` by rows, `w_x` and the conv
whole); a rank's recurrent state holds its heads' WKV state or its
channels' h (`transformer.init_cache(parts=)`), the shifts and the conv
state whole. Where the axis has more ranks than kv heads (and a multiple
of them), rank r holds kv head r·KV / mp whole, so recurrentgemma's one
kv head and its cache sit on every rank. The encoder-decoder splits the
encoder's and both decoder attentions' heads and each MLP as the dense
layer. A vocabulary the axis does not divide stays whole on every rank
(`splits_vocab`): the lookup and the argmax run locally. These serve
only; the dense attention stack alone trains on the axis.

The model trains on the axis too (`models.transformer.train_loss(axis=)`,
`dist.trainer.make_mesh_train_step`): `reduce` and `copy` are each
other's conjugates as autograd Functions. `reduce` (after `wo`, `w_down`
and the embedding's lookup) sums in the forward and passes the gradient
through on each rank; `copy` (the replicated input of each
column-parallel product: after `ln1` into q/k/v, after `ln2` into gate
and up, after the final norm into the head, and the qk-norm scales,
which act on the rank's own heads) passes the value through and sums the
ranks' partial gradients in the backward. `ModelAxis.nll` is the
vocabulary-parallel cross-entropy. Identical graphs reach every sum in
the same order on every rank, so the replicated leaves' gradients, and
the leaves themselves, stay bitwise equal across a model line.

  local_config          -- the config a rank runs;
  check_tensor_parallel -- refuse what this module does not split (and,
                           to train, what it splits for serving only);
  param_specs           -- the split of every leaf, as sharding spec
                           tuples (`model_dims`: its dim a leaf);
  shard_params / gather_params -- a rank's piece of the whole params, and
                           the whole params from every rank's piece;
  init_shard            -- a rank's piece of the init, drawn leaf by
                           leaf, without the whole model;
  serving_params        -- a rank's piece (of the whole params, or the
                           piece itself) as it serves, in the compute
                           dtype;
  ModelAxis             -- the axis's operations: row_product, reduce,
                           copy, replicate, embed, nll, argmax.

Precision. One process rounds a row-parallel product once, from its f32
accumulation to the activation dtype. A rank's partial product of `wo`
or `w_down` (`ModelAxis.row_product`) comes out in SUM_DTYPE, unrounded;
the sum over the axis runs in SUM_DTYPE and rounds once to the
activation dtype (`transformer._reduce`), as one process's product does.
`copy`'s backward sums the partial gradients in SUM_DTYPE too and rounds
them once to the gradient's dtype. An MoE layer's output is summed over
the axis from each rank's f32 partial (its own experts' slots' combine
plus the shared experts' partial product) and rounded once, where one
process rounds the combine, the shared product and their sum
(`models.moe`).

The split differs from `dist.serving.serve_param_shardings` (the
reference's greedy specs): greedy puts "model" on a leaf's largest
dividing dimension (the d_model rows of `wk`, for one), which GSPMD
reshards between operations; explicit tensor parallelism cannot, so each
product splits on the axis that needs no reshard.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (axis_sizes, gather_shards,
                                       local_shard)

# the queue items of ROADMAP.md that the refusals name
UNDIVIDED_ITEM = ("ROADMAP queue 1 item 6.1d (query head, MLA head, expert "
                  "and width counts the axis does not divide)")
TRAINING_ITEM = ("ROADMAP queue 1 item 6.1e (training MoE and MLA on the "
                 "model axis)")
RECURRENT_ITEM = ("ROADMAP queue 1 item 6.1f (training the recurrent "
                  "families and the encoder-decoder on the model axis, and "
                  "what the axis serves undivided: a kv head on several "
                  "ranks, a whole vocabulary)")

# the leaf's dim that "model" splits, by the leaf's name below its
# segment or encoder-decoder stack (None: whole on every rank)
_SPLIT = {
    "attn.wq": 2, "attn.wk": 2, "attn.wv": 2,       # columns: heads
    "attn.bq": 1, "attn.bk": 1, "attn.bv": 1,
    "attn.wo": 1,                                   # rows: heads
    "mlp.w_gate": 2, "mlp.w_up": 2,                 # columns: d_ff
    "mlp.w_down": 1,                                # rows: d_ff
    "attn.q_norm.scale": None, "attn.k_norm.scale": None,
    "ln1.scale": None, "ln1.bias": None, "ln2.scale": None,
    "ln2.bias": None,
    # MLA: the latents' down projections and norms whole, the heads'
    # up projections by columns (a head's block each)
    "attn.wq_a": None, "attn.wkv_a": None, "attn.kv_norm.scale": None,
    "attn.wq_b": 2, "attn.wk_b": 2, "attn.wv_b": 2,
    # MoE: the router whole, the experts [count, E, ...] over E, the
    # shared experts as the MLP
    "moe.router": None, "moe.w_gate": 1, "moe.w_up": 1, "moe.w_down": 1,
    "moe.shared.w_gate": 2, "moe.shared.w_up": 2, "moe.shared.w_down": 1,
    # RWKV6 by heads: r, k, v, g and the decay by columns (the LoRA's
    # second product by its columns, its first whole), u by heads, the
    # group norm's scale by channel, `wo` by rows; the channel mix's k by
    # columns of d_ff and its v by rows. The mix ratios act on the D-wide
    # input and `cm_wr`'s gate multiplies the summed v product: whole
    **{f"mix.mu.{n}": None for n in ("r", "k", "v", "g", "w")},
    "mix.wr": 2, "mix.wk": 2, "mix.wv": 2, "mix.wg": 2, "mix.w0": 1,
    "mix.w_lora_a": None, "mix.w_lora_b": 2, "mix.u": 1,
    "mix.ln_out_scale": 1, "mix.wo": 1,
    "mix.cm_mu.r": None, "mix.cm_mu.k": None, "mix.cm_wr": None,
    "mix.cm_wk": 2, "mix.cm_wv": 1,
    # RG-LRU by channels of rnn_width: the gates and the y branch by
    # columns, their biases and Lambda by channel, `w_out` by rows; `w_x`
    # and the conv whole (every rank's gates read the conv's whole output)
    "rnn.w_x": None, "rnn.conv_kernel": None, "rnn.conv_bias": None,
    "rnn.w_a": 2, "rnn.w_i": 2, "rnn.b_a": 1, "rnn.b_i": 1, "rnn.lamb": 1,
    "rnn.w_y": 2, "rnn.w_out": 1,
    # the encoder-decoder's cross-attention (every query head its own K/V)
    # and its norm (its self-attention's leaves are "attn"'s)
    "cross.wq": 2, "cross.wk": 2, "cross.wv": 2, "cross.wo": 1,
    "ln_x.scale": None, "ln_x.bias": None,
}
_TOP = {"embed.table": 0, "head": 1, "final_norm.scale": None,
        "final_norm.bias": None, "enc_norm.scale": None,
        "enc_norm.bias": None}
# the leaves that a kv head's ranks share where the axis has more ranks
# than kv heads (a group of mp / KV ranks holds one head whole)
_KV = ("attn.wk", "attn.wv", "attn.bk", "attn.bv")
# the whole leaves that act on the rank's own heads only, so each rank's
# gradient is a part of the whole one (`ModelAxis.replicate`)
PARTIAL = ("attn.q_norm.scale", "attn.k_norm.scale")
# the dtype of a rank's partial products of `wo` and `w_down` and of
# their sums over the axis (bytes: `dist.serving.serve_step_sends`)
SUM_DTYPE = torch.float32


def _attention(cfg):
    """Whether the stack has attention layers (dense, MoE or the
    encoder-decoder's)."""
    return bool({"attn", "moe"} & set(cfg.layer_types)
                or _encdec(cfg))


def _encdec(cfg):
    return cfg.family in ("audio", "encdec") or bool(cfg.encoder_layers)


def splits_vocab(cfg, mp):
    """Whether a model axis of `mp` splits the vocabulary (it divides it);
    else the embedding table and the head stay whole on every rank, the
    lookup and the argmax local."""
    return cfg.vocab_size % mp == 0


def local_config(cfg, mp):
    """The config a rank of a model axis of `mp` runs: num_heads / mp query
    heads, num_kv_heads / mp kv heads (one where the axis has more ranks
    than kv heads: the head its group of ranks shares) and d_ff / mp,
    with d_model, head_dim, vocab_size, `cfg.mla` (the rank holds the
    whole latents), `cfg.moe` (routing and capacity run over all E
    experts) and the recurrent fields as they are. An RWKV6 layer takes
    its rank's head count from `u`, an RG-LRU layer its channels from
    `w_a` (the leaves' shapes), and a rank's recurrent state holds those
    (`transformer.init_cache(parts=mp)`); the unembedding's logits are
    the rank's vocabulary slice where the axis splits it. The config
    itself for mp = 1."""
    if mp == 1:
        return cfg
    check_tensor_parallel(cfg, mp)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // mp,
                               num_kv_heads=max(cfg.num_kv_heads // mp, 1),
                               d_ff=cfg.d_ff // mp)


def check_trainable(cfg):
    """Raise NotImplementedError where training on a model axis is not
    split for `cfg` (MoE: the router's gradient and the aux loss counted
    once; MLA: the latents' gradients; the recurrent layers and the
    encoder-decoder), naming the ROADMAP item."""
    recurrent = sorted(set(cfg.layer_types) - {"attn", "moe"})
    if recurrent or _encdec(cfg):
        what = "the encoder-decoder" if _encdec(cfg) else f"{recurrent} layers"
        raise NotImplementedError(f"{cfg.name}: training {what} on a model "
                                  f"axis is {RECURRENT_ITEM}")
    if cfg.moe is not None or cfg.mla is not None:
        what = ("MoE layers" if cfg.mla is None else "MLA attention"
                if cfg.moe is None else "MoE layers and MLA attention")
        raise NotImplementedError(f"{cfg.name}: training {what} on a model "
                                  f"axis is {TRAINING_ITEM}")


def check_tensor_parallel(cfg, mp, training=False):
    """Raise NotImplementedError for a config this module does not split
    over `mp` ranks (`training`: to train, `check_trainable` too, and
    neither a kv head shared by ranks nor a whole vocabulary), naming the
    ROADMAP item that would."""
    kinds = set(cfg.layer_types)
    if training:
        check_trainable(cfg)
    if _attention(cfg) and cfg.mla is None:
        kv = cfg.num_kv_heads
        if cfg.num_heads % mp or (kv % mp and mp % kv):
            raise NotImplementedError(
                f"{cfg.name}: a model axis of {mp} does not divide "
                f"{cfg.num_heads} query and {kv} kv heads (the "
                f"reference's cache_shardings then replicates the cache); "
                f"{UNDIVIDED_ITEM}")
    elif cfg.mla is not None and cfg.num_heads % mp:
        raise NotImplementedError(
            f"{cfg.name}: a model axis of {mp} does not divide "
            f"{cfg.num_heads} query and {cfg.num_kv_heads} kv heads; "
            f"{UNDIVIDED_ITEM}")
    counts = []
    if kinds & {"attn", "rwkv", "rglru"} or _encdec(cfg):
        counts.append(("d_ff", cfg.d_ff))
    if "rwkv" in kinds:
        counts.append(("the RWKV heads",
                       cfg.d_model // cfg.rwkv_head_dim))
    if "rglru" in kinds:
        counts.append(("rnn_width", cfg.rnn_width or cfg.d_model))
    if cfg.moe is not None:
        counts.append(("num_experts", cfg.moe.num_experts))
        counts.append(("the shared experts' width", cfg.moe.d_ff_expert
                       * cfg.moe.num_shared_experts))
    for what, n in counts:
        if n % mp:
            raise NotImplementedError(
                f"{cfg.name}: a model axis of {mp} does not divide {what} "
                f"{n}; {UNDIVIDED_ITEM}")
    if training and (not splits_vocab(cfg, mp) or (
            _attention(cfg) and cfg.mla is None and cfg.num_kv_heads < mp)):
        raise NotImplementedError(
            f"{cfg.name}: training with {cfg.num_kv_heads} kv heads and a "
            f"vocabulary of {cfg.vocab_size} on a model axis of {mp} is "
            f"{RECURRENT_ITEM}")
    if splits_vocab(cfg, mp) and cfg.vocab_size >= 1 << 24:
        raise NotImplementedError(
            f"{cfg.name}: ModelAxis.argmax carries token ids in f32, exact "
            f"below 2**24, not for a vocabulary of {cfg.vocab_size}")


def _rule(key):
    """The name of a leaf in `_SPLIT` or `_TOP`: below its segment
    ("segments.3.rnn.w_a" -> "rnn.w_a"), its encoder stack
    ("encoder.attn.wq" -> "attn.wq") or its decoder stack, whose
    self-attention is "attn" ("decoder.self.wk" -> "attn.wk"); None for
    another key."""
    if key in _TOP:
        return key
    head, _, rest = key.partition(".")
    if head == "segments":
        rest = rest.partition(".")[2]
    elif head == "decoder" and rest.startswith("self."):
        rest = "attn." + rest[len("self."):]
    elif head not in ("encoder", "decoder"):
        return None
    return rest if rest in _SPLIT else None


def _pieces(cfg, key, mp):
    """How many distinct pieces a leaf split over an axis of `mp` has: mp,
    or KV for a kv leaf where the axis has more ranks than kv heads (rank
    r holds kv head r·KV // mp whole)."""
    kv = cfg.num_kv_heads
    if kv < mp and cfg.mla is None and _rule(key) in _KV:
        return kv
    return mp


def param_specs(cfg, params, mp=None):
    """{leaf: spec} of the split on a model axis of `mp` (None: one that
    divides every count): a tuple per dim with "model" on the split dim
    and None elsewhere; the embedding table and the head are whole where
    `mp` does not divide the vocabulary (`splits_vocab`). A kv leaf's
    "model" has KV pieces where the axis has more ranks than kv heads
    (`shard_params`). Every leaf must be one this module knows: a bias
    of a row-parallel product (`wo`, `w_down`; the ported configs have
    none) would be added once on every rank, so it raises."""
    whole_vocab = mp is not None and not splits_vocab(cfg, mp)
    specs = {}
    for key, v in params.items():
        name = _rule(key)
        if name is None:
            raise NotImplementedError(
                f"{cfg.name}: no tensor-parallel split for leaf {key!r}")
        dim = _TOP[name] if name in _TOP else _SPLIT[name]
        if whole_vocab and name in ("embed.table", "head"):
            dim = None
        spec = [None] * len(v.shape)
        if dim is not None:
            spec[dim] = "model"
        specs[key] = tuple(spec)
    return specs


def model_dims(cfg, params):
    """{leaf: the dim of the unstacked leaf that "model" splits, or None}
    (`param_specs`), for `sharding.state_shardings`."""
    return {k: spec.index("model") if "model" in spec else None
            for k, spec in param_specs(cfg, params).items()}


def _cut(cfg, key, leaf, spec, mesh, coords):
    """The piece of `leaf` under `spec` that the rank at `coords` holds:
    `local_shard`, or for a kv leaf of fewer kv heads than ranks its
    rank's head (`_pieces`)."""
    mp = axis_sizes(mesh)["model"]
    n = _pieces(cfg, key, mp)
    if n == mp:
        return local_shard(leaf, spec, mesh, coords)
    return local_shard(leaf, spec, {"model": n},
                       {"model": coords["model"] * n // mp})


def shard_params(cfg, params, mesh, coords=None):
    """The piece of the whole `params` that the rank at `coords` (default:
    this rank's) holds on `mesh`'s model axis; `params` itself on an axis
    of 1. Every rank draws the same init (or converts the same reference
    params) and keeps its piece, as `init_mesh_train_state` does."""
    mp = axis_sizes(mesh).get("model", 1)
    if mp == 1:
        return params
    check_tensor_parallel(cfg, mp)
    coords = mesh.coords if coords is None else coords
    specs = param_specs(cfg, params, mp)
    return {k: _cut(cfg, k, v, specs[k], mesh, coords)
            for k, v in params.items()}


def _shapes(cfg, generator):
    """(the init's leaves with every drawn leaf a meta tensor, the drawn
    leaves' names in the order the init draws them): a first init that
    draws nothing through `layers.keeping` (the small leaves an init
    draws directly, RWKV6's `u` and LoRA, RG-LRU's conv taps, it draws
    whole), from `generator`'s state, which it leaves as it found it."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import keeping

    drawn = []

    def shape_only(draw, shape, dtype):
        drawn.append(torch.empty(shape, dtype=dtype, device="meta"))
        return drawn[-1]

    state = generator.get_state()
    with keeping(shape_only):
        shapes = build_model(cfg).init(generator)
    generator.set_state(state)
    name_of = {id(v): k for k, v in shapes.items()}
    return shapes, [name_of[id(t)] for t in drawn]


def init_shard(cfg, generator, mesh):
    """This rank's piece on `mesh`'s model axis of `build_model(cfg).init(
    generator)`, bitwise `shard_params` of the whole init from the same
    generator stream, without the whole model: a first init draws
    nothing and takes the drawn leaves' shapes and order (meta tensors),
    then each leaf is drawn whole, as the init draws it, and only its
    piece is kept before the next is drawn (`layers.keeping`), so the
    peak is the rank's pieces and one whole leaf. The whole init on an
    axis of 1."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import keeping

    model = build_model(cfg)
    mp = axis_sizes(mesh).get("model", 1)
    if mp == 1:
        return model.init(generator)
    check_tensor_parallel(cfg, mp)
    shapes, order = _shapes(cfg, generator)
    names = iter(order)
    specs = param_specs(cfg, shapes, mp)

    def keep(draw, shape, dtype):
        whole = draw()
        name = next(names)
        piece = _cut(cfg, name, whole, specs[name], mesh, mesh.coords)
        # a piece that is a view (a leading dim's slice, or the whole
        # leaf) would hold the whole leaf's storage
        return piece.clone() if piece._base is not None else piece

    with keeping(keep):
        params = model.init(generator)
    drawn = set(order)
    return {k: v if k in drawn else _cut(cfg, k, v, specs[k], mesh,
                                         mesh.coords)
            for k, v in params.items()}


@functools.lru_cache(maxsize=16)
def _whole_shapes(cfg):
    """{leaf: its shape} of the whole init of `cfg`."""
    shapes, _ = _shapes(cfg, torch.Generator())
    return {k: tuple(v.shape) for k, v in shapes.items()}


def is_piece(cfg, params, mesh):
    """Whether `params` is this rank's piece on `mesh`'s model axis (from
    `shard_params` or `init_shard`) rather than the whole params, told by
    the leaves the axis splits into more than one piece: each holds the
    whole leaf's width on its split dim, or every one its piece's. Raises
    for another width, or for a mix of the two."""
    mp = axis_sizes(mesh).get("model", 1)
    if mp == 1:
        return False
    whole = _whole_shapes(cfg)
    seen = set()
    for key, spec in param_specs(cfg, params, mp).items():
        n = _pieces(cfg, key, mp)
        if "model" not in spec or n == 1:
            continue
        dim = spec.index("model")
        got, full = params[key].shape[dim], whole[key][dim]
        if got not in (full, full // n):
            raise ValueError(f"{cfg.name}: leaf {key!r} of {got} on dim "
                             f"{dim} is neither the whole leaf's {full} nor "
                             f"a piece of it on a model axis of {mp}")
        seen.add(got != full)
    if len(seen) > 1:
        raise ValueError(f"{cfg.name}: some leaves are whole and some are "
                         f"pieces on a model axis of {mp}")
    return seen == {True}


def serving_params(cfg, params, mesh=None):
    """This rank's piece of `params` on `mesh` (`shard_params` of the
    whole params, or `params` itself where it is the piece: `is_piece`;
    the whole params without a mesh) with every float leaf in the
    compute dtype, as the engine serves it."""
    compute = getattr(torch, cfg.compute_dtype)
    if mesh is not None and not is_piece(cfg, params, mesh):
        params = shard_params(cfg, params, mesh)
    return {k: v.to(compute) if v.is_floating_point() else v
            for k, v in params.items()}


def gather_params(cfg, pieces, mesh):
    """The inverse of `shard_params`: `pieces[r]` is rank r's piece (ranks
    row-major over the mesh's axes)."""
    mp = axis_sizes(mesh).get("model", 1)
    specs = param_specs(cfg, pieces[0], mp)
    out = {}
    for k, spec in specs.items():
        n = _pieces(cfg, k, mp)
        if n == mp:
            out[k] = gather_shards([p[k] for p in pieces], spec, mesh)
        else:
            # a kv head's piece from the first rank of each group
            out[k] = gather_shards([pieces[j * mp // n][k]
                                    for j in range(n)], spec, {"model": n})
    return out


class _Reduce(torch.autograd.Function):
    """The sum over the model axis; its backward is the identity on each
    rank (each rank's x enters the sum once)."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x, "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """The identity; its backward is the sum over the model axis of each
    rank's partial gradient, in SUM_DTYPE, rounded once to the
    gradient's dtype."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = ctx.comm.all_reduce(grad.to(SUM_DTYPE), "model")
        return total.to(grad.dtype), None


class ModelAxis:
    """The collectives of one rank on a mesh's "model" axis, over `comm`
    (a `dist.collectives.Collectives`). Every sum runs in the line's
    order on every rank and on both transports, so every rank gets the
    same bits."""

    def __init__(self, comm, mesh):
        self.comm = comm
        self.mesh = mesh
        self.size = axis_sizes(mesh)["model"]
        self.index = mesh.coords["model"]

    def reduce(self, x):
        """The sum over the axis of each rank's x, in x's dtype: SUM_DTYPE
        for the partial products of `row_product` (the caller rounds the
        sum once to the activation dtype), the compute dtype for the
        embedding's lookup (exact: one rank adds a non-zero row). Its
        gradient is the identity on each rank."""
        return _Reduce.apply(x, self.comm)

    def copy(self, x):
        """x itself, whose gradient is summed over the axis (the
        replicated input of a column-parallel product; a whole leaf that
        acts on the rank's heads only). x as it is where it needs no
        gradient (serving)."""
        return _Copy.apply(x, self.comm) if x.requires_grad else x

    def replicate(self, params):
        """`params` with `copy` on the whole leaves whose every rank's
        gradient is a part (qk-norm's scales: each rank normalizes its
        own heads), so each leaf's gradient is the whole one on every
        rank."""
        return {k: self.copy(v) if k.split(".", 2)[-1] in PARTIAL else v
                for k, v in params.items()}

    def nll(self, logits, targets):
        """The vocabulary-parallel cross-entropy: each token's negative
        log-likelihood [...] in f32 from the rank's slice of the logits
        [..., V / mp] (f32) and the global target ids, as `train_loss`
        takes it from the whole logits: the max over the axis (detached:
        it only shifts the exponents), the sum of exp(logits - max) over
        the axis, and the target's logit from the rank whose slice holds
        it (the others add a masked zero). One gather of the maxima, one
        sum of the (sum, target logit) pairs."""
        vocab = logits.shape[-1]
        peaks = self.comm.all_gather(logits.detach().amax(-1).contiguous(),
                                     "model")
        m = torch.stack(peaks).amax(0)
        local = targets.long() - self.index * vocab
        hit = (local >= 0) & (local < vocab)
        gold = torch.gather(logits, -1, local.clamp(0, vocab - 1)[..., None])
        gold = torch.where(hit, gold[..., 0], torch.zeros_like(gold[..., 0]))
        sums = self.reduce(torch.stack(
            [torch.sum(torch.exp(logits - m[..., None]), dim=-1), gold]))
        return m + torch.log(sums[0]) - sums[1]

    @staticmethod
    def row_product(h, w):
        """This rank's partial product h @ w of a row-parallel leaf (`wo`,
        `w_down`, `shared.w_down`: its rows of the whole leaf) in
        SUM_DTYPE, unrounded, for `reduce` to sum."""
        return h.to(SUM_DTYPE) @ w.to(SUM_DTYPE)

    def row_sum(self, h, w):
        """The whole product h @ w of a row-parallel leaf from this rank's
        rows: its partial product summed over the axis and rounded once to
        h's dtype, as one process rounds its product."""
        return self.reduce(self.row_product(h, w)).to(h.dtype)

    def embed_local(self, table, tokens):
        """This rank's part of an embedding lookup: the rows of the tokens
        in its vocabulary slice (table: its [V / mp, D] rows), zeros for
        the others."""
        rows = table.shape[0]
        local = tokens - self.index * rows
        hit = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), table)
        return torch.where(hit[..., None], x, torch.zeros_like(x))

    def embed(self, table, tokens):
        """The vocabulary-parallel lookup: one rank adds a token's row, the
        others zeros, so the sum is the one-process row bitwise."""
        return self.reduce(self.embed_local(table, tokens))

    def argmax(self, logits):
        """The greedy token of the rank's vocabulary slices logits [..., V /
        mp]: each rank's (largest value, its lowest global id), gathered,
        the largest value winning with the lowest id on a tie, as the
        reference's argmax over the sharded vocabulary breaks ties
        (int32 [...], equal on every rank). Ids ride in f32 beside the
        values (exact below 2**24; `check_tensor_parallel`)."""
        logits = logits.float()
        idx = torch.argmax(logits, -1)
        val = torch.gather(logits, -1, idx[..., None])[..., 0]
        ids = (idx + self.index * logits.shape[-1]).float()
        pieces = self.comm.all_gather(torch.stack([val, ids], -1), "model")
        best = pieces[0]
        for p in pieces[1:]:
            best = torch.where((p[..., 0] > best[..., 0])[..., None], p,
                               best)
        return best[..., 1].to(torch.int32)

    def gather_vocab(self, logits):
        """The whole vocabulary's logits from every rank's slice [..., V /
        mp] (a check's view, not a serving step's: the steps fetch the
        argmax)."""
        return torch.cat(self.comm.all_gather(logits.contiguous(), "model"),
                         dim=-1)


def model_axis(mesh, comm):
    """The `ModelAxis` of this rank on `mesh` (its model line, whatever its
    data coordinate), or None where the mesh has no model axis above 1
    (the one-process path)."""
    sizes = axis_sizes(mesh)
    if sizes.get("model", 1) == 1:
        return None
    return ModelAxis(comm, mesh)
